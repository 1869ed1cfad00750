"""The port's kernel build helper, kept importable at its first home; it
lives in :mod:`repro_torch._build`."""
from repro_torch._build import (BUILD_DIR, NVCC_FLAGS, build_all,  # noqa: F401
                                library_path, load, sources)
