"""PyTorch port, placement select: ``masked_argmin`` and its plain version.

The CUDA kernel (``repro_torch/manyworld/csrc/masked_argmin.cu``) runs
only on the card; here its plain PyTorch version is held to NumPy's
first-occurrence argmin and to the reference's Pallas kernel (interpret
mode) on ties, all-masked rows, signed zeros, ``+inf`` scores and
non-power-of-two widths.  ``tests/test_torch_gpu.py`` holds the kernel to
the plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.manyworld import select as ref_select

from repro_torch import _build
from repro_torch.manyworld import select as port_select


def _cases():
    """(scores, mask) pairs covering every edge the lane engine can hit."""
    rng = np.random.default_rng(7)
    out = []
    for L, N in ((17, 13), (5, 1), (3, 1000), (8, 64), (4, 33)):
        scores = rng.standard_normal((L, N))
        mask = rng.random((L, N)) < 0.6
        out.append((scores, mask))
    scores, mask = out[0]
    scores[3, 4] = scores[3, 9] = scores[3].min() - 1.0   # exact tie
    mask[3, 4] = mask[3, 9] = True
    mask[5] = False                                        # all masked
    scores[6, :] = 0.0                                     # +0.0 / -0.0 tie
    scores[6, 2] = -0.0
    mask[6, :] = True
    scores[7, :] = np.inf                                  # all +inf
    mask[7, :] = True
    scores[8, :3] = np.inf                                 # +inf, finite
    mask[8, :] = False
    mask[8, :3] = True
    mask[8, 11] = True
    # Integer-valued scores with many ties (first-fit / best-fit rows).
    ints = rng.integers(0, 3, (16, 64)).astype(np.float64)
    out.append((ints, rng.random((16, 64)) < 0.5))
    out.append((np.zeros((4, 7)), np.zeros((4, 7), bool)))
    return out


CASES = _cases()


def _numpy_ref(scores, mask):
    return np.where(mask, scores, np.inf).argmin(axis=1).astype(np.int32)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_matches_numpy(case):
    scores, mask = CASES[case]
    got = port_select.masked_argmin_plain(torch.from_numpy(scores),
                                          torch.from_numpy(mask))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _numpy_ref(scores, mask))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_matches_reference_pallas_kernel(case):
    scores, mask = CASES[case]
    with jax.enable_x64(True):
        import jax.numpy as jnp
        want = np.asarray(ref_select.masked_argmin(
            jnp.asarray(scores), jnp.asarray(mask), "pallas"))
    got = port_select.masked_argmin(torch.from_numpy(scores),
                                    torch.from_numpy(mask))
    assert np.array_equal(got.numpy(), want)


def test_edge_rows_resolve_as_the_pallas_kernel_does():
    scores, mask = CASES[0]
    got = port_select.masked_argmin_plain(torch.from_numpy(scores),
                                          torch.from_numpy(mask)).numpy()
    assert got[3] == 4          # exact tie -> first index
    assert got[5] == 0          # all masked -> 0
    assert got[6] == 0          # +0.0 at 0 ties -0.0 at 2 -> first
    assert got[7] == 0          # all +inf -> 0
    assert got[8] == 11         # only finite unmasked entry


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def no_build(name):
        raise AssertionError(f"kernel {name} built for a CPU tensor")
    monkeypatch.setattr(_build, "load", no_build)
    before = port_select.launches
    scores, mask = CASES[0]
    got = port_select.masked_argmin(torch.from_numpy(scores),
                                    torch.from_numpy(mask))
    assert port_select.launches == before
    assert np.array_equal(got.numpy(), _numpy_ref(scores, mask))


def test_kernel_path_rejects_non_cuda_tensors_before_building(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built"))
    s = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="device"):
        port_select._masked_argmin_cuda(s, torch.ones((2, 3), dtype=torch.bool))


def test_build_sources_and_flags():
    srcs = _build.sources()
    assert "masked_argmin" in srcs
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    lib = _build.library_path("masked_argmin")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
