"""The port's RMSNorm gradients (``paddle_tpu_torch.kernels.rms_norm``
``rms_norm``: dx, and dw in the weight's dtype) against ``jax.grad`` of the
JAX package's Pallas ``rms_norm`` in interpret mode, at the widths where the
card's one-launch backward (``csrc/rms_norm.cu``, dx and dw summed inside
the kernel) changes path: 100 (one element a lane), 2048 (the row held in
registers), 4095 (re-read, odd) and 28680 (above the 28672 columns the
tile primitives' LayerNorm backward stops at: the column-tiled partial has
no width limit); an fp32 and a bf16 weight; a frozen weight (dx only: the
card takes the dx-only kernels) and a frozen x (dw only).

On the CPU the port's wrappers take the kernels' plain PyTorch versions,
which ``chip_smoke.py`` phase 19 and ``test_torch_paged_decode_hopper_cuda.py``
hold the CUDA kernel to on the card. Inputs come from numpy with a seed and
go to both packages. Tolerances, max-abs error over the reference's
max-abs: 1e-5 for fp32 (summation order), 1e-2 for bf16 (one rounding of
dx, of dw to the weight's dtype, and of the bf16 inputs' products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.pallas.rms_norm as JRN
from paddle_tpu_torch.kernels import rms_norm as TRN

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (rows, H): the widths around the card kernel's paths
SHAPES = [(37, 100), (64, 2048), (13, 4095), (3, 28680)]
# x dtype, weight dtype
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.bfloat16, torch.bfloat16)]


def _inputs(rows, H, seed):
    r = np.random.RandomState(seed)
    x = (r.randn(rows, H) * 2 + 0.5).astype(np.float32)
    w = r.randn(H).astype(np.float32)
    dy = r.randn(rows, H).astype(np.float32)
    return x, w, dy


def _rel(got, ref):
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _jax_grads(x, w, dy, xdt, wdt, argnums, eps=1e-5):
    jx, jw = jnp.asarray(x).astype(JDT[xdt]), jnp.asarray(w).astype(JDT[wdt])
    jdy = jnp.asarray(dy).astype(JDT[xdt])

    def f(a, b):
        y = JRN.rms_norm(a, b, eps)
        return jnp.sum(y.astype(jnp.float32) * jdy.astype(jnp.float32))
    return jax.grad(f, argnums=argnums)(jx, jw)


@pytest.mark.parametrize("xdt,wdt", DTYPES,
                         ids=["fp32", "bf16-x-fp32-w", "bf16-x-bf16-w"])
@pytest.mark.parametrize("rows,H", SHAPES, ids=[f"H{h}" for _, h in SHAPES])
def test_grads_match_jax_kernel(rows, H, xdt, wdt):
    x, w, dy = _inputs(rows, H, seed=H)
    xt = torch.from_numpy(x).to(xdt).requires_grad_(True)
    wt = torch.from_numpy(w).to(wdt).requires_grad_(True)
    n = TRN.rms_norm_bwd.LAUNCHES
    gx, gw = torch.autograd.grad(TRN.rms_norm(xt, wt, 1e-5), (xt, wt),
                                 torch.from_numpy(dy).to(xdt))
    assert TRN.rms_norm_bwd.LAUNCHES == n        # the CPU takes the plain
    rx, rw = _jax_grads(x, w, dy, xdt, wdt, (0, 1))
    assert gx.dtype == xdt and gx.shape == (rows, H)
    assert gw.dtype == wdt and gw.shape == (H,)
    assert _rel(gx, rx) <= TOL[xdt], _rel(gx, rx)
    # dw is fp32 only when both x and the weight are: bf16 x rounds its
    # products' inputs
    tol_w = TOL[torch.float32] if xdt == wdt == torch.float32 else 1e-2
    assert _rel(gw, rw) <= tol_w, _rel(gw, rw)


@pytest.mark.parametrize("frozen", ["weight", "x"])
@pytest.mark.parametrize("rows,H", [(37, 100), (3, 28680)],
                         ids=["H100", "H28680"])
def test_frozen_weight_or_x(rows, H, frozen):
    """Only the gradient asked for is formed, and it matches the JAX
    kernel's (whose custom_vjp forms both)."""
    x, w, dy = _inputs(rows, H, seed=rows)
    xt = torch.from_numpy(x).requires_grad_(frozen == "weight")
    wt = torch.from_numpy(w).requires_grad_(frozen == "x")
    target = xt if frozen == "weight" else wt
    (g,) = torch.autograd.grad(TRN.rms_norm(xt, wt, 1e-5), (target,),
                               torch.from_numpy(dy))
    ref = _jax_grads(x, w, dy, torch.float32, torch.float32,
                     0 if frozen == "weight" else 1)
    assert g.shape == target.shape and _rel(g, ref) <= 1e-5


def test_plain_backward_forms_only_what_is_asked():
    x, w, dy = (torch.from_numpy(a) for a in _inputs(5, 64, seed=0))
    _, rstd = TRN.rms_norm_fwd_plain(x, w, 1e-5)
    dx, dw = TRN.rms_norm_bwd(x, w, rstd, dy)
    assert dx.dtype == x.dtype and dw.dtype == torch.float32
    only_dx, none = TRN.rms_norm_bwd(x, w, rstd, dy, need_dw=False)
    none2, only_dw = TRN.rms_norm_bwd(x, w, rstd, dy, need_dx=False)
    assert none is None and none2 is None
    assert torch.equal(only_dx, dx) and torch.equal(only_dw, dw)
