"""PyTorch + CUDA port of the many-world lane engine.

``repro_torch`` is the PyTorch counterpart of the JAX package ``repro``'s
accelerator path: ``search.runner.run_cells(cells, workers="lanes")``
evaluates void/void static-cluster cells as lanes of one batched program
(``manyworld.lanes``), whose per-pod placement select is a CUDA kernel
written for Hopper (``manyworld/csrc/masked_argmin.cu``).  Rows are
bit-identical to the serial simulator's except ``wall_s``.

The package imports ``torch`` and ``numpy`` only.  Module names mirror
``repro``'s so each counterpart is easy to find; the pieces of the NumPy
simulator this path needs (job types, node templates, the columnar trace,
four scenario families, the cell spec) are kept as local copies.

Every entry point takes ``device=None``, which means CUDA; the CPU runs
only when the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
