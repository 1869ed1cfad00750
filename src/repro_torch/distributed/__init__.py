"""Distributed training, as ``repro/distributed``: logical-axis sharding
on DTensor (:mod:`.sharding`), int8-compressed gradient sync
(:mod:`.compression`) and elastic restore onto another mesh
(:mod:`.elastic`)."""
