"""The port's kernel build (``repro_torch._build``) under threads, on the
CPU: ``nvcc``, ``subprocess.Popen`` and ``ctypes.CDLL`` are fakes, so
the test runs where no CUDA toolkit is installed.

Threads that launch their first kernel together (two trainers of the
live cluster, say) call ``load`` on the same unbuilt kernel at once: one
``nvcc`` must run, and every thread must get the one library it built.
"""
import ctypes
import subprocess
import sys
import threading
import time

import pytest

from repro_torch import _build

THREADS = 8


class _FakeNvcc:
    """``subprocess.Popen`` of nvcc: writes the ``-o`` file when its
    output is read, after a pause long enough for other threads to
    arrive."""

    calls = []
    returncode_to_give = 0
    running = 0
    most_running = 0

    def __init__(self, cmd, **kwargs):
        self.cmd = cmd
        self.out = cmd[cmd.index("-o") + 1]
        self.returncode = None
        _FakeNvcc.calls.append(self)
        _FakeNvcc.running += 1
        _FakeNvcc.most_running = max(_FakeNvcc.most_running,
                                     _FakeNvcc.running)

    def communicate(self):
        time.sleep(0.05)
        self.returncode = _FakeNvcc.returncode_to_give
        if self.returncode == 0:
            with open(self.out, "w") as f:
                f.write("built")
        _FakeNvcc.running -= 1
        return "ptxas info: fake", None


class _FakeCDLL:
    opened = []

    def __init__(self, path):
        self.path = path
        _FakeCDLL.opened.append(path)


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    src = tmp_path / "csrc" / "x.cu"
    src.parent.mkdir()
    src.write_text("// a kernel\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "sources", lambda: {"x": src})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(ctypes, "CDLL", _FakeCDLL)
    _FakeNvcc.calls = []
    _FakeNvcc.returncode_to_give = 0
    _FakeNvcc.running = _FakeNvcc.most_running = 0
    _FakeCDLL.opened = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield tmp_path
    finally:
        sys.setswitchinterval(interval)


def _load_from_threads(name):
    """``load(name)`` from ``THREADS`` threads released together: each
    thread's library or exception, in thread order."""
    start = threading.Barrier(THREADS)
    got = [None] * THREADS

    def run(i):
        start.wait()
        try:
            got[i] = _build.load(name)
        except RuntimeError as e:
            got[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return got


def test_eight_threads_build_once_and_share_the_library(fake_toolchain):
    got = _load_from_threads("x")
    assert len(_FakeNvcc.calls) == 1
    assert len(_FakeCDLL.opened) == 1
    assert _FakeNvcc.most_running == 1
    assert all(lib is got[0] for lib in got)
    assert isinstance(got[0], _FakeCDLL)
    lib = _build.library_path("x")
    assert got[0].path == str(lib) and lib.read_text() == "built"
    assert lib.with_suffix(".log").read_text() == "ptxas info: fake"
    assert not list(lib.parent.glob("*.tmp"))
    # Loaded: no thread builds or opens it again.
    assert _build.load("x") is got[0]
    assert len(_FakeNvcc.calls) == 1 and len(_FakeCDLL.opened) == 1


def test_temporary_file_names_process_and_thread(fake_toolchain):
    _build.build_all(["x"])
    name = _FakeNvcc.calls[0].out
    assert name.endswith(f".{_build.os.getpid()}.{threading.get_ident()}"
                         ".tmp")


def test_failed_build_raises_in_every_thread(fake_toolchain):
    _FakeNvcc.returncode_to_give = 1
    got = _load_from_threads("x")
    assert all(isinstance(e, RuntimeError) and "nvcc exited 1" in str(e)
               for e in got)
    assert not _FakeCDLL.opened
    assert not _build.library_path("x").exists()
    # A failure is not remembered: each thread tried in its turn, one
    # nvcc at a time.
    assert len(_FakeNvcc.calls) == THREADS
    assert _FakeNvcc.most_running == 1
