"""Training side of the port: synthetic data, AdamW, losses, the train
step, the checkpoint writer and reader, the ``Trainer``, and the replay
of the train fixture (``golden``)."""
