"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``<subpackage>/csrc/<name>.cu`` of the port exports a plain C
launcher and compiles on its own into ``build/repro_torch/<name>-<hash>.so``
under the repository root (``.gitignore`` lists ``build/``), where ``<hash>`` covers the source and
the flags, so an edited kernel is rebuilt and an unchanged one is not.
The build runs on first use; :func:`build_all` starts one ``nvcc`` per
source, all at once.  One lock serialises :func:`build_all` and
:func:`load`, so threads that launch their first kernel together start
one ``nvcc`` a source and load one library.  Nothing here falls back: a
missing ``nvcc`` or a failed build raises, in every thread that asks
for the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()


def sources() -> Dict[str, Path]:
    """Kernel name -> CUDA source, for every ``csrc/*.cu`` of the port.
    Kernel names are unique across the port's ``csrc`` directories."""
    found: Dict[str, Path] = {}
    for path in sorted(PACKAGE.rglob("csrc/*.cu")):
        if path.stem in found:
            raise RuntimeError(f"repro_torch: two kernels named {path.stem!r}: "
                               f"{found[path.stem]} and {path}")
        found[path.stem] = path
    return found


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("repro_torch: nvcc not found (needed to build the "
                       "CUDA kernels); put the CUDA toolkit's bin on PATH")


def library_path(name: str) -> Path:
    src = sources()[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build every named kernel that is not built yet, one ``nvcc`` per
    source, started together.  Returns ``{name: {"seconds", "log",
    "cached"}}``; ``log`` is nvcc's output (``-Xptxas -v``: registers,
    shared memory, spills)."""
    with _LOCK:
        return _build_all(list(sources() if names is None else names))


def _build_all(names) -> Dict[str, dict]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    running = []
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            log = lib.with_suffix(".log")
            report[name] = {"seconds": 0.0, "cached": True,
                            "log": log.read_text() if log.exists() else ""}
            continue
        tmp = lib.with_name(
            f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc))
    failures = []
    for name, lib, tmp, proc in running:
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0,
                        "cached": False, "log": log}
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("repro_torch: kernel build failed\n"
                           + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, building it on first use."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build_all([name])
            lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return lib
