"""Cell specs and the lane-engine cell runner (``repro.search``)."""
from repro_torch.search.runner import CellError, CellSpec, run_cells

__all__ = ["CellSpec", "CellError", "run_cells"]
