"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once and prints the
result as the last line of its output.  Everything a cell needs is
found by name under this folder: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``cells/<cell>.json`` and one reader a
per-layer metric, ``metrics/<metric>.py``.
"""
