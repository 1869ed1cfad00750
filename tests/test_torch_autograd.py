"""PyTorch port: gradients through the kernel wrappers
(``repro_torch.kernels._autograd``) against autograd through the plain
versions and against ``jax.vjp`` of the JAX package's functions.

Each wrapper, called with inputs that require grad, goes through a
``torch.autograd.Function`` whose backward differentiates the plain
version recomputed on the same device.  On the CPU the forward is the
plain version too, so the Function's gradients must equal plain
autograd's exactly; both are held to the reference's vector-Jacobian
product of the same function (``repro/kernels/ref.py`` oracles and
``repro/models/xlstm.py:69 _mlstm_chunkwise``) on the same numpy inputs
and cotangents, in float32.  Tolerances for that comparison: the
forward's own (the oracles sum in another order), ``atol 1e-5, rtol
1e-4`` for the scan (a reverse-time sum of up to 40 terms), ``atol
2e-5, rtol 1e-4`` for attention, ``atol 2e-4, rtol 2e-3`` for the mLSTM
cell.  No float64 ``gradcheck``: the plain versions compute in float32.
The kernels' own gradients on the card are in ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as ref_kernels
from repro.models import xlstm as ref_xlstm

from repro_torch import _build
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.kernels import mlstm_chunkwise as port_mlstm
from repro_torch.kernels import rglru_scan as port_rglru

SCAN_TOL = dict(atol=1e-5, rtol=1e-4)
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
MLSTM_TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    """CPU tensors never build or launch a kernel."""
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail(f"built {name} for CPU"))


def _grads(fn, arrays, cots, wrt):
    """Outputs of ``fn`` on torch copies of ``arrays`` and the gradients
    of ``sum(out * cot)`` w.r.t. the inputs indexed by ``wrt``."""
    inputs = [None if a is None else torch.from_numpy(a) for a in arrays]
    for i in wrt:
        inputs[i].requires_grad_()
    outs = fn(*inputs)
    grads = torch.autograd.grad(outs, [inputs[i] for i in wrt],
                                [torch.from_numpy(c) for c in cots])
    return outs, grads


def _jax_vjp(fn, arrays, cots, wrt):
    """``jax.vjp`` of ``fn`` in the inputs indexed by ``wrt``, the others
    held fixed."""
    def part(*xs):
        full = list(arrays)
        for i, x in zip(wrt, xs):
            full[i] = x
        return fn(*full)
    outs, vjp = jax.vjp(part, *[jnp.asarray(arrays[i]) for i in wrt])
    return outs, vjp(tuple(jnp.asarray(c) for c in cots))


def _check(port_fn, plain_fn, ref_fn, arrays, cots, wrt, tol):
    outs, grads = _grads(port_fn, arrays, cots, wrt)
    assert all("PlainBackward" in type(o.grad_fn).__name__ for o in outs)
    plain_outs, plain_grads = _grads(plain_fn, arrays, cots, wrt)
    for got, want in zip(outs + grads, plain_outs + plain_grads):
        assert torch.equal(got, want)
    ref_outs, ref_grads = _jax_vjp(ref_fn, arrays, cots, wrt)
    for got, want in zip(outs, ref_outs):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **tol)
    for got, want in zip(grads, ref_grads):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,T,R,wrt", [(2, 40, 24, (0, 1)), (1, 7, 5, (0,)),
                                       (3, 33, 8, (1,))])
def test_rglru_gradients_match_plain_and_jax(B, T, R, wrt):
    rng = np.random.default_rng(B * 100 + T)
    a = rng.uniform(0.5, 0.999, (B, T, R)).astype(np.float32)
    _check(lambda a, b: (port_rglru.rglru_scan(a, b),),
           lambda a, b: (port_rglru.rglru_scan_plain(a, b),),
           lambda a, b: (ref_kernels.rglru_scan_ref(a, b),),
           [a, 0.3 * _f32(rng, B, T, R)], [_f32(rng, B, T, R)], wrt,
           SCAN_TOL)


@pytest.mark.parametrize("B,Hq,Hkv,T,S,hd,causal,window", [
    (1, 4, 2, 16, 16, 8, True, 0),
    (2, 2, 1, 12, 12, 16, True, 5),
    (1, 2, 2, 9, 13, 8, False, 0),
])
def test_flash_gradients_match_plain_and_jax(B, Hq, Hkv, T, S, hd, causal,
                                             window):
    rng = np.random.default_rng(T * 10 + hd)
    opts = dict(causal=causal, window=window)
    _check(lambda q, k, v: (port_flash.flash_attention(q, k, v, **opts),),
           lambda q, k, v: (port_flash.flash_attention_plain(q, k, v,
                                                             **opts),),
           lambda q, k, v: (ref_kernels.attention_ref(q, k, v, **opts),),
           [_f32(rng, B, Hq, T, hd), _f32(rng, B, Hkv, S, hd),
            _f32(rng, B, Hkv, S, hd)], [_f32(rng, B, Hq, T, hd)],
           (0, 1, 2), ATTN_TOL)


def _mlstm_arrays(rng, B, H, T, dk, dv, with_state):
    arrays = [_f32(rng, B, H, T, dk),
              (_f32(rng, B, H, T, dk) / np.sqrt(dk)).astype(np.float32),
              _f32(rng, B, H, T, dv), _f32(rng, B, H, T),
              _f32(rng, B, H, T) + 2.0]
    if with_state:
        arrays += [_f32(rng, B, H, dk, dv),
                   np.abs(_f32(rng, B, H, dk)), _f32(rng, B, H)]
    return arrays


def _port_mlstm(fn, chunk):
    def call(q, k, v, i, f, *state):
        h, s = fn(q, k, v, i, f, state=tuple(state) or None, chunk=chunk)
        return (h,) + tuple(s)
    return call


def _ref_mlstm(chunk):
    def call(q, k, v, i, f, *state):
        h, s = ref_xlstm._mlstm_chunkwise(q, k, v, i, f,
                                          state=tuple(state) or None,
                                          chunk=chunk)
        return (h,) + tuple(s)
    return call


@pytest.mark.parametrize("B,H,T,dk,dv,chunk,with_state", [
    (2, 2, 16, 8, 8, 64, False),
    (1, 2, 32, 8, 12, 8, False),
    (2, 1, 24, 8, 8, 8, True),
    (1, 1, 16, 16, 8, 16, True),
])
def test_mlstm_gradients_match_plain_and_jax(B, H, T, dk, dv, chunk,
                                             with_state):
    rng = np.random.default_rng(B + T + dk)
    arrays = _mlstm_arrays(rng, B, H, T, dk, dv, with_state)
    cots = [_f32(rng, B, H, T, dv), _f32(rng, B, H, dk, dv),
            _f32(rng, B, H, dk), _f32(rng, B, H)]
    _check(_port_mlstm(port_mlstm.mlstm_chunkwise, chunk),
           _port_mlstm(port_mlstm.mlstm_chunkwise_plain, chunk),
           _ref_mlstm(chunk), arrays, cots, tuple(range(len(arrays))),
           MLSTM_TOL)


def test_mlstm_gradient_of_h_alone_without_state():
    """``return_state=False`` (the forecaster's call): one output."""
    rng = np.random.default_rng(3)
    arrays = _mlstm_arrays(rng, 3, 2, 16, 8, 8, False)
    cot = _f32(rng, 3, 2, 16, 8)

    def port(*x):
        return (port_mlstm.mlstm_chunkwise(*x, chunk=16,
                                           return_state=False)[0],)

    def ref(*x):
        return (ref_xlstm._mlstm_chunkwise(*x, chunk=16)[0],)

    outs, grads = _grads(port, arrays, [cot], (0, 1, 2, 3, 4))
    _, ref_grads = _jax_vjp(ref, arrays, [cot], (0, 1, 2, 3, 4))
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MLSTM_TOL)


@pytest.mark.parametrize("grad_mode", ["no_grad", "inference_mode",
                                       "no_input_requires_grad"])
def test_wrappers_bypass_the_function_without_grad(grad_mode):
    """Serving and forecasting: grad off, or no input requiring grad,
    calls the forward directly, with no graph."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 0.9, (1, 6, 4)).astype(np.float32))
    b = torch.from_numpy(_f32(rng, 1, 6, 4))
    q, k, v = (torch.from_numpy(_f32(rng, 1, 2, 8, 8)) for _ in range(3))
    m_in = [torch.from_numpy(x) for x in
            _mlstm_arrays(rng, 1, 2, 16, 8, 8, False)]
    if grad_mode != "no_input_requires_grad":
        for t in [a, b, q, k, v] + m_in:
            t.requires_grad_()
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "no_input_requires_grad": torch.enable_grad}[grad_mode]
    with ctx():
        outs = [port_rglru.rglru_scan(a, b),
                port_flash.flash_attention(q, k, v),
                port_mlstm.mlstm_chunkwise(*m_in, chunk=16)[0]]
    assert all(o.grad_fn is None and not o.requires_grad for o in outs)
    assert torch.equal(outs[0], port_rglru.rglru_scan_plain(a, b).detach())


def test_function_forward_runs_under_no_grad_and_keeps_dtype():
    """bfloat16 inputs: the result keeps the wrapper's dtype and the
    gradients come back in the inputs' dtype."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0.5, 0.9, (2, 9, 16)).astype(
        np.float32)).bfloat16().requires_grad_()
    b = torch.from_numpy(_f32(rng, 2, 9, 16)).bfloat16().requires_grad_()
    h = port_rglru.rglru_scan(a, b, out_dtype=torch.float32)
    assert h.dtype == torch.float32
    ga, gb = torch.autograd.grad(h.sum(), (a, b))
    assert ga.dtype == gb.dtype == torch.bfloat16
    want = torch.autograd.grad(
        port_rglru.rglru_scan_plain(a, b, torch.float32).sum(), (a, b))
    assert torch.equal(ga, want[0]) and torch.equal(gb, want[1])
