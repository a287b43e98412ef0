"""The port's RMSNorm (``paddle_tpu_torch.kernels.rms_norm``, the registry
op ``nn.functional.rms_norm``, ``nn.RMSNorm`` and incubate's
``fused_rms_norm``) against the JAX package's Pallas ``rms_norm`` in
interpret mode and its composed ``F.rms_norm``.

On the CPU the port's wrappers take the kernels' plain PyTorch versions,
which follow the Pallas kernel's arithmetic (fp32 statistics and weight,
one rounding to x's dtype), so these tests hold what ``chip_smoke.py``
compares the CUDA kernels with on the card to the JAX kernel. Tolerances
are ``test_pallas_kernels.py``'s: fp32 forward 1e-5, gradients 1e-4; a bf16
forward within one bf16 ulp of the JAX kernel's (both round once from fp32
values that differ only in summation order). Inputs are made with numpy
from a seed and handed to both packages. The CUDA kernels are tested on
the card by ``test_torch_llama_kernels_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.incubate.nn.functional as JI
import paddle_tpu.kernels.pallas.rms_norm as JRN
from paddle_tpu_torch import device_guard
from paddle_tpu_torch.incubate.nn import functional as TI
from paddle_tpu_torch.kernels import rms_norm as TRN
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as TF

JF = importlib.import_module("paddle_tpu.nn.functional.norm")

SHAPES = [(2, 8, 64), (37, 100), (1, 6), (3, 5, 4095)]


def _inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = r.randn(shape[-1]).astype(np.float32)
    dy = r.randn(*shape).astype(np.float32)
    return x, w, dy


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_forward_and_grads_match_jax_kernel_fp32(shape, eps):
    x, w, dy = _inputs(shape)
    xt, wt = _t(x, grad=True), _t(w, grad=True)
    y = TRN.rms_norm(xt, wt, eps)
    ref = JRN.rms_norm(_j(x), _j(w), eps)
    assert y.dtype == torch.float32 and y.shape == x.shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    gx, gw = torch.autograd.grad(y, (xt, wt), _t(dy))
    rx, rw = jax.grad(lambda a, b: jnp.sum(JRN.rms_norm(a, b, eps)
                                           * jnp.asarray(dy)),
                      argnums=(0, 1))(_j(x), _j(w))
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_parts_and_bf16_within_one_ulp(shape):
    """The plain forward and backward (the CPU path of the wrappers) give
    fp32 rstd [rows], dx and an fp32 dw; bf16 rows beside an fp32 weight
    stay bf16, within one bf16 ulp of the JAX kernel's."""
    x, w, dy = _inputs(shape, seed=1)
    H = shape[-1]
    x2, dy2 = _t(x).reshape(-1, H), _t(dy).reshape(-1, H)
    y, rstd = TRN.rms_norm_fwd_plain(x2, _t(w), 1e-6)
    assert rstd.dtype == torch.float32 and rstd.shape == (x2.shape[0],)
    dx, dw = TRN.rms_norm_bwd_plain(x2, _t(w), rstd, dy2)
    assert dw.dtype == torch.float32 and dw.shape == (H,)
    assert torch.equal(TRN.rms_norm_fwd(x2, _t(w), 1e-6)[0], y)
    assert torch.equal(TRN.rms_norm_bwd_dx(x2, _t(w), rstd, dy2), dx)
    yb = TRN.rms_norm(_t(x, torch.bfloat16), _t(w), 1e-6)
    rb = JRN.rms_norm(_j(x, jnp.bfloat16), _j(w), 1e-6)
    assert yb.dtype == torch.bfloat16 and rb.dtype == jnp.bfloat16
    ref = np.asarray(rb.astype(jnp.float32))
    ulp = np.maximum(np.abs(ref), 1e-30) * 2.0 ** -7
    assert (np.abs(yb.float().numpy() - ref) <= ulp).all()
    # the weight's gradient comes back in the weight's dtype
    wb = _t(w, torch.bfloat16, grad=True)
    xb = _t(x, torch.bfloat16, grad=True)
    gx, gw = torch.autograd.grad(TRN.rms_norm(xb, wb, 1e-6), (xb, wb),
                                 _t(dy, torch.bfloat16))
    assert gx.dtype == gw.dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["bias", "axis", "no_weight", "1d"])
def test_registry_gate_sends_the_rest_to_the_composed_op(case):
    """The JAX gate (a weight, no bias, the last axis, x at least 2-D)
    refuses these calls; both packages run the composed op, which rounds
    before the weight: fp32 within 1e-5, bf16 within one bf16 ulp."""
    x, w, _ = _inputs((4, 6, 16), seed=2)
    b = np.random.RandomState(3).randn(16).astype(np.float32)
    kw = {"bias": dict(weight=w, bias=b),
          "axis": dict(weight=np.ones((6, 16), np.float32), bias=None,
                       begin_norm_axis=1),
          "no_weight": dict(weight=None, bias=None),
          "1d": dict(weight=w, bias=None)}[case]
    if case == "1d":
        x = x[0, 0]
    targs = {k: (_t(v) if isinstance(v, np.ndarray) else v)
             for k, v in kw.items()}
    jargs = {k: (_j(v) if isinstance(v, np.ndarray) else v)
             for k, v in kw.items()}
    for dtype, jdtype, rtol, atol in ((torch.float32, jnp.float32, 1e-5,
                                       1e-5),
                                      (torch.bfloat16, jnp.bfloat16,
                                       2.0 ** -7, 0)):
        got = TF.rms_norm(_t(x, dtype), epsilon=1e-5, **targs)
        ref = JF.rms_norm(_j(x, jdtype), epsilon=1e-5, **jargs)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=rtol, atol=atol)


def test_layer_and_fused_rms_norm_take_the_kernel_path():
    x, w, _ = _inputs((3, 5, 128), seed=4)
    with device_guard("cpu"):
        layer = RMSNorm(128, epsilon=1e-5)
    assert layer.weight.dtype == torch.float32
    assert (layer.weight == 1).all()
    with torch.no_grad():
        layer.weight.copy_(_t(w))
    ref = np.asarray(JRN.rms_norm(_j(x), _j(w), 1e-5))
    np.testing.assert_allclose(layer(_t(x)).detach().numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    got = TI.fused_rms_norm(_t(x), _t(w), epsilon=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # bf16 rows keep their dtype beside the fp32 weight
    xb = _t(x, torch.bfloat16)
    assert layer(xb).dtype == torch.bfloat16
    assert torch.equal(TI.fused_rms_norm(xb, _t(w), epsilon=1e-5),
                       TRN.rms_norm(xb, _t(w), 1e-5))
    # a bias takes the composed op in both packages
    b = np.linspace(-1, 1, 128).astype(np.float32)
    np.testing.assert_allclose(
        TI.fused_rms_norm(_t(x), _t(w), _t(b), 1e-5).numpy(),
        np.asarray(JI.fused_rms_norm(_j(x), _j(w), _j(b), 1e-5)),
        rtol=1e-5, atol=1e-5)
