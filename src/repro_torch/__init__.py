"""PyTorch + CUDA port of ``repro``.

``repro_torch`` is the PyTorch counterpart of the JAX package ``repro``:
the paper's orchestrator (``core``: the serial simulator, its schedulers,
reschedulers and autoscalers, ``run_experiment`` and the Fig. 3 / Fig. 4
experiments; ``search.runner.run_cells``), the many-world lane engine
(``run_cells(cells, workers="lanes")``, one CUDA kernel a batch written
for Hopper), the learned rate forecaster that the predictive autoscaler
takes, and the LM data plane (models, training, serving, the sharded and
dry-run paths).  Rows are bit-identical to the reference's except
``wall_s``.

The package imports ``torch`` and ``numpy`` only, and reads no
environment variable.  Module names mirror ``repro``'s so each
counterpart is easy to find; the NumPy-only modules of ``repro`` are kept
as local copies.  The serial simulator runs on the host; the device
enters through the forecaster and the lane engine.

Every entry point that uses the device takes ``device=None``, which means
CUDA; the CPU runs only when the caller passes ``device="cpu"`` (see
:mod:`repro_torch.device`).
"""
