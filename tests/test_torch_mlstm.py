"""PyTorch port, mLSTM cell and block: ``repro_torch.kernels.mlstm_chunkwise``
and ``repro_torch.models`` against the JAX package.

The same numpy inputs go through the JAX oracle
``repro.models.xlstm._mlstm_chunkwise``, the Pallas kernel in interpret
mode and the port's plain versions (the function the CUDA kernels
compute, and the parallel kernel's three passes with and without its
bfloat16 hi/lo operands; the kernels themselves run only on the card,
``tests/test_torch_gpu.py``).
Tolerances are the JAX kernel test's (``tests/test_kernels.py:160``):
float32 ``atol 2e-4, rtol 2e-3`` (sums taken in another order), bfloat16
``5e-2``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm_chunkwise import mlstm_chunkwise as pallas_mlstm
from repro.models import conv as ref_conv
from repro.models import params as ref_params
from repro.models import xlstm as ref_xlstm
from repro.forecast import model as ref_fmodel

from repro_torch import _build
from repro_torch.kernels import mlstm_chunkwise as port_kernel
from repro_torch.models import conv as port_conv
from repro_torch.models import params as port_params
from repro_torch.models import xlstm as port_xlstm
from repro_torch.forecast import model as port_fmodel

F32_TOL = dict(atol=2e-4, rtol=2e-3)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
# (B, H, T, dh, chunk): tests/test_kernels.py:143-146, the forecaster's
# cell (H=2, T=16, dh=32, one chunk), and a multi-chunk walk.
SHAPES = [(1, 1, 128, 64, 64), (2, 2, 128, 32, 32), (3, 2, 16, 32, 64),
          (2, 3, 48, 16, 16)]


def _inputs(B, H, T, dk, dv=None, seed=0):
    dv = dk if dv is None else dv
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((B, H, T, dk)).astype(f32),
            (rng.standard_normal((B, H, T, dk)) / np.sqrt(dk)).astype(f32),
            rng.standard_normal((B, H, T, dv)).astype(f32),
            rng.standard_normal((B, H, T)).astype(f32),
            (rng.standard_normal((B, H, T)) + 2.0).astype(f32))


def _state(B, H, dk, dv, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, dk, dv)).astype(np.float32),
            np.abs(rng.standard_normal((B, H, dk))).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,dh,chunk", SHAPES)
def test_plain_matches_jax_oracle(B, H, T, dh, chunk, dtype):
    arrays = _inputs(B, H, T, dh)
    want_h, want_s = ref_xlstm._mlstm_chunkwise(
        *_j(arrays, getattr(jnp, dtype)), chunk=chunk)
    got_h, got_s = port_kernel.mlstm_chunkwise_plain(
        *_t(arrays, getattr(torch, dtype)), chunk=chunk)
    assert got_h.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got_h), _np(want_h), **tol)
    for got, want in zip(got_s, want_s):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,dh,chunk", SHAPES)
def test_plain_matches_pallas_kernel_interpret(B, H, T, dh, chunk, dtype):
    """The Pallas kernel starts the stabiliser at -1e30, the oracle and the
    port at -inf; the outputs agree all the same."""
    arrays = _inputs(B, H, T, dh, seed=2)
    want = pallas_mlstm(*_j(arrays, getattr(jnp, dtype)), chunk=chunk,
                        interpret=True)
    got, _ = port_kernel.mlstm_chunkwise_plain(
        *_t(arrays, getattr(torch, dtype)), chunk=chunk, return_state=False)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("B,H,T,dk,dv,chunk", [(2, 2, 64, 32, 48, 16),
                                                (1, 2, 16, 32, 32, 16)])
def test_plain_with_initial_state_matches_oracle(B, H, T, dk, dv, chunk):
    arrays = _inputs(B, H, T, dk, dv, seed=3)
    state = _state(B, H, dk, dv)
    want_h, want_s = ref_xlstm._mlstm_chunkwise(*_j(arrays), state=_j(state),
                                                chunk=chunk)
    got_h, got_s = port_kernel.mlstm_chunkwise_plain(
        *_t(arrays), state=_t(state), chunk=chunk)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **F32_TOL)
    for got, want in zip(got_s, want_s):
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


# (B, H, T, dk, dv, state in): the parallel kernel's envelope on the
# CPU: one chunk, several, dv != dk, B*H > 4, xLSTM-125M's 384-wide heads.
PARALLEL_SHAPES = [(1, 1, 64, 64, 64, False), (2, 3, 192, 64, 128, True),
                   (1, 2, 64, 128, 64, True), (1, 4, 256, 384, 384, False),
                   (1, 4, 256, 384, 384, True)]


def _parallel_case(B, H, T, dk, dv, with_state, rounding):
    """The inputs in float32 (rounding None) or in bfloat16 with the
    kernel's hi/lo operands (the dtype the parallel kernel takes)."""
    arrays = _inputs(B, H, T, dk, dv, seed=B + T + dk + dv)
    if rounding is not None:   # the bfloat16 values both sides see
        arrays = tuple(_np(torch.from_numpy(a).bfloat16()) for a in arrays)
    state = _state(B, H, dk, dv, seed=T) if with_state else None
    dtype = torch.float32 if rounding is None else torch.bfloat16
    tol = F32_TOL if rounding is None else BF16_TOL
    return arrays, state, dtype, tol


@pytest.mark.parametrize("rounding", [None, "bf16x2"])
@pytest.mark.parametrize("B,H,T,dk,dv,with_state", PARALLEL_SHAPES)
def test_parallel_plain_matches_jax_oracle(B, H, T, dk, dv, with_state,
                                           rounding):
    arrays, state, dtype, tol = _parallel_case(B, H, T, dk, dv, with_state,
                                               rounding)
    want_h, want_s = ref_xlstm._mlstm_chunkwise(
        *_j(arrays), state=None if state is None else _j(state), chunk=64)
    got_h, got_s = port_kernel.mlstm_chunkwise_parallel_plain(
        *_t(arrays, dtype), state=None if state is None else _t(state),
        chunk=64, rounding=rounding)
    assert got_h.dtype == dtype
    np.testing.assert_allclose(_np(got_h), _np(want_h), **tol)
    for got, want in zip(got_s, want_s):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("rounding", [None, "bf16x2"])
@pytest.mark.parametrize("B,H,T,dk,dv,with_state",
                         [s for s in PARALLEL_SHAPES if not s[5]])
def test_parallel_plain_matches_pallas_kernel_interpret(B, H, T, dk, dv,
                                                        with_state, rounding):
    arrays, _, dtype, tol = _parallel_case(B, H, T, dk, dv, False, rounding)
    want = pallas_mlstm(*_j(arrays), chunk=64, interpret=True)
    got, none = port_kernel.mlstm_chunkwise_parallel_plain(
        *_t(arrays, dtype), chunk=64, return_state=False, rounding=rounding)
    assert none is None
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_parallel_plain_without_rounding_equals_sequential_plain():
    arrays = _t(_inputs(2, 2, 192, 64, 32, seed=9))
    state = _t(_state(2, 2, 64, 32))
    want_h, want_s = port_kernel.mlstm_chunkwise_plain(*arrays, state=state)
    got_h, got_s = port_kernel.mlstm_chunkwise_parallel_plain(*arrays,
                                                              state=state)
    torch.testing.assert_close(got_h, want_h, atol=1e-5, rtol=1e-5)
    for got, want in zip(got_s, want_s):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="rounding"):
        port_kernel.mlstm_chunkwise_parallel_plain(*arrays, rounding="fp8")


# (L, dk, dv, dtype, kernel): the envelope edges of the three kernels.
PICKS = [
    (64, 384, 384, torch.bfloat16, "parallel"),   # xLSTM-125M's prefill
    (64, 64, 64, torch.bfloat16, "parallel"),
    (64, 384, 64, torch.bfloat16, "parallel"),
    (64, 64, 320, torch.bfloat16, "parallel"),
    (64, 384, 384, torch.float32, "block"),       # float32: never parallel
    (64, 64, 64, torch.float32, "block"),
    (32, 384, 384, torch.bfloat16, "block"),      # L != 64
    (16, 64, 64, torch.bfloat16, "rows"),
    (64, 200, 384, torch.bfloat16, "block"),      # dk not whole tiles
    (64, 384, 72, torch.bfloat16, "block"),       # dv not whole tiles
    (64, 32, 64, torch.bfloat16, "block"),
    (64, 384, 448, torch.bfloat16, "block"),      # dv past 384
    (16, 32, 32, torch.float32, "rows"),          # the forecaster
    (32, 64, 64, torch.float32, "rows"),
    (16, 32, 18, torch.float32, "block"),      # dv not whole 16-byte rows
]


@pytest.mark.parametrize("L,dk,dv,dtype,kernel", PICKS)
def test_pick_kernel_at_envelope_edges(monkeypatch, L, dk, dv, dtype, kernel):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built"))
    assert port_kernel.pick_kernel(L, dk, dv, dtype) == kernel
    assert port_kernel.takes_parallel_kernel(L, dk, dv, dtype) == (
        kernel == "parallel")


def test_pick_kernel_sends_unaligned_tensors_past_the_parallel_kernel():
    q = torch.zeros(1, 1, 64 * 64 + 1, dtype=torch.bfloat16)[0, 0, 1:]
    assert q.data_ptr() % 16
    assert port_kernel.pick_kernel(64, 64, 64, torch.bfloat16, (q,)) == \
        "block"


def test_named_kernel_outside_its_envelope_raises_before_building(
        monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built"))
    cuda = port_kernel._mlstm_chunkwise_cuda
    f32 = _t(_inputs(1, 1, 64, 64))
    with pytest.raises(ValueError, match="parallel kernel does not take"):
        cuda(*f32, None, 64, True, kernel="parallel")
    bf16 = _t(_inputs(1, 1, 64, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="parallel kernel does not take"):
        cuda(*bf16, None, 32, True, kernel="parallel")
    with pytest.raises(ValueError, match="no kernel named"):
        cuda(*bf16, None, 64, True, kernel="tensor")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda(*bf16, None, 64, True, kernel="parallel")


def test_return_state_off_gives_same_h_and_no_state():
    arrays = _t(_inputs(2, 2, 64, 16, seed=4))
    h_full, state = port_kernel.mlstm_chunkwise_plain(*arrays, chunk=16)
    h, none = port_kernel.mlstm_chunkwise_plain(*arrays, chunk=16,
                                                return_state=False)
    assert none is None and len(state) == 3
    assert torch.equal(h, h_full)


def test_dispatch_takes_plain_version_on_cpu(monkeypatch):
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail(f"built {name} for CPU"))
    before = port_kernel.launches
    arrays = _t(_inputs(1, 2, 32, 16, seed=5))
    h, s = port_kernel.mlstm_chunkwise(*arrays, chunk=16)
    want_h, want_s = port_kernel.mlstm_chunkwise_plain(*arrays, chunk=16)
    assert port_kernel.launches == before
    assert torch.equal(h, want_h)
    assert all(torch.equal(a, b) for a, b in zip(s, want_s))


def test_kernel_path_rejects_cpu_tensors_before_building(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built"))
    arrays = _t(_inputs(1, 1, 16, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        port_kernel._mlstm_chunkwise_cuda(*arrays, None, 16, True)


def test_kernel_path_limits_raise_naming_them(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built"))
    cuda = port_kernel._mlstm_chunkwise_cuda
    with pytest.raises(ValueError, match="dk <= 384"):
        cuda(*_t(_inputs(1, 1, 16, 385)), None, 16, True)
    with pytest.raises(ValueError, match="limit of 64"):
        cuda(*_t(_inputs(1, 1, 128, 8)), None, 128, True)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        cuda(*_t(_inputs(1, 1, 24, 8)), None, 16, True)
    q, k, v, i, f = _t(_inputs(1, 1, 16, 8))
    with pytest.raises(TypeError):
        cuda(q.double(), k, v, i, f, None, 16, True)
    with pytest.raises(ValueError, match="contiguous"):
        cuda(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, i, f,
             None, 16, True)
    with pytest.raises(ValueError, match="state"):
        cuda(q, k, v, i, f, (torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, 8)),
             16, True)


def test_build_finds_every_port_kernel():
    srcs = _build.sources()
    assert {"masked_argmin", "mlstm_chunkwise", "mlstm_parallel"} <= set(srcs)
    assert srcs["mlstm_chunkwise"].parent.name == "csrc"
    assert srcs["mlstm_parallel"].parent == srcs["mlstm_chunkwise"].parent
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    from repro_torch.manyworld import _build as old_home
    assert old_home.sources() == srcs and old_home.BUILD_DIR == _build.BUILD_DIR


@pytest.mark.parametrize("T,width", [(16, 4), (5, 4), (9, 2)])
def test_causal_conv1d_matches_jax(T, width):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, T, 12)).astype(np.float32)
    p = {"w": rng.standard_normal((width, 12)).astype(np.float32),
         "b": rng.standard_normal(12).astype(np.float32)}
    want = ref_conv.causal_conv1d({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x))
    got = port_conv.causal_conv1d(port_params.params_from_numpy(p, "cpu"),
                                  torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def _jax_params(specs, seed):
    tree = ref_params.init_params(jax.random.key(seed), specs)
    return tree, jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("d_model,heads,T", [(32, 2, 16), (16, 4, 32)])
def test_apply_mlstm_matches_jax(d_model, heads, T):
    ref_cfg = ref_fmodel.forecast_arch(d_model=d_model, num_heads=heads)
    cfg = port_fmodel.forecast_arch(d_model=d_model, num_heads=heads)
    jtree, ntree = _jax_params(ref_xlstm.mlstm_specs(ref_cfg), seed=7)
    x = np.random.default_rng(8).standard_normal((4, T, d_model)).astype(
        np.float32)
    want = ref_xlstm.apply_mlstm(jtree, jnp.asarray(x), ref_cfg)
    got = port_xlstm.apply_mlstm(port_params.params_from_numpy(ntree, "cpu"),
                                 torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_specs_match_reference_and_init_params():
    ref_specs = ref_fmodel.forecast_specs(ref_fmodel.forecast_arch())
    specs = port_fmodel.forecast_specs(port_fmodel.forecast_arch())
    ref_leaves = jax.tree_util.tree_flatten_with_path(
        ref_specs, is_leaf=ref_params.is_spec)[0]
    port_leaves = list(port_params.leaves_with_paths(specs))
    assert len(port_leaves) == len(ref_leaves) == 16
    from repro_torch.train.checkpoint import tree_key
    for (path, got), (jpath, want) in zip(port_leaves, ref_leaves):
        assert tree_key(path) == "/".join(str(p) for p in jpath)
        assert (got.shape, got.axes, got.init, got.scale) == (
            want.shape, want.axes, want.init, want.scale)
    assert sum(int(np.prod(s.shape)) for _, s in port_leaves) == 19_141
    params = port_params.init_params(specs, torch.Generator().manual_seed(0),
                                     device="cpu")
    assert torch.equal(params["block"]["b_i"], torch.zeros(2))
    assert torch.equal(params["block"]["out_norm"]["scale"], torch.ones(64))
    w = params["block"]["w_up"]
    assert w.shape == (32, 64) and abs(float(w.std()) - 32 ** -0.5) < 0.03
    again = port_params.init_params(specs, torch.Generator().manual_seed(0),
                                    device="cpu")
    assert torch.equal(again["w_out"], params["w_out"])
