"""The port's LayerNorm backward (``paddle_tpu_torch.kernels.layer_norm``
``layer_norm_bwd``: dx, dw and db from one call, and the ``layer_norm``
autograd Function over it) against ``jax.grad`` of the JAX package's Pallas
``layer_norm`` in interpret mode, at the widths where the card's one-launch
backward (``csrc/layer_norm.cu``, dx with dw and db summed inside the
kernel) changes route: 768 and 1024 (the row held in registers), 100 (one
element a lane), 4100 (re-read) and 28680 (above the 28672 columns the tile
primitives' LayerNorm backward stops at: the column-tiled partial has no
width limit); with and without a bias; an fp32 and a bf16 weight; a frozen
weight (dx only: the card takes the dx-only kernel) and a frozen x (dw and
db only).

On the CPU the port's wrappers take the kernels' plain PyTorch versions,
which ``chip_smoke.py`` phase 15 and ``test_torch_norm_hopper_cuda.py`` hold
the CUDA kernels to on the card. Inputs come from numpy with a seed and go
to both packages. Tolerances, max-abs error over the reference's max-abs:
1e-5 for fp32 (summation order), 1e-2 for bf16 (one rounding of dx, of dw
and db to the weight's dtype, and of the bf16 inputs' products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.pallas.layer_norm as JLN
from paddle_tpu_torch.kernels import layer_norm as TLN

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (rows, H): the widths around the card kernel's routes
SHAPES = [(37, 100), (64, 768), (9, 1024), (13, 4100), (3, 28680)]
# x dtype, weight (and bias) dtype
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.bfloat16, torch.bfloat16)]
EPS = 1e-5


def _inputs(rows, H, seed):
    r = np.random.RandomState(seed)
    x = (r.randn(rows, H) * 2 + 0.5).astype(np.float32)
    w = r.randn(H).astype(np.float32)
    b = r.randn(H).astype(np.float32)
    dy = r.randn(rows, H).astype(np.float32)
    return x, w, b, dy


def _rel(got, ref):
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _jax_grads(x, w, b, dy, xdt, wdt, argnums):
    jx, jw = jnp.asarray(x).astype(JDT[xdt]), jnp.asarray(w).astype(JDT[wdt])
    jb = None if b is None else jnp.asarray(b).astype(JDT[wdt])
    jdy = jnp.asarray(dy).astype(JDT[xdt])

    def f(*a):
        y = JLN.layer_norm(*a, EPS) if jb is not None else \
            JLN.layer_norm(*a, None, EPS)
        return jnp.sum(y.astype(jnp.float32) * jdy.astype(jnp.float32))
    args = (jx, jw) if jb is None else (jx, jw, jb)
    return jax.grad(f, argnums=argnums)(*args)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("xdt,wdt", DTYPES,
                         ids=["fp32", "bf16-x-fp32-w", "bf16-x-bf16-w"])
@pytest.mark.parametrize("rows,H", SHAPES, ids=[f"H{h}" for _, h in SHAPES])
def test_grads_match_jax_kernel(rows, H, xdt, wdt, bias):
    x, w, b, dy = _inputs(rows, H, seed=H)
    b = b if bias else None
    xt = torch.from_numpy(x).to(xdt).requires_grad_(True)
    wt = torch.from_numpy(w).to(wdt).requires_grad_(True)
    bt = torch.from_numpy(b).to(wdt).requires_grad_(True) if bias else None
    leaves = [t for t in (xt, wt, bt) if t is not None]
    n, routes = TLN.layer_norm_bwd.LAUNCHES, dict(TLN.layer_norm_bwd.ROUTES)
    got = torch.autograd.grad(TLN.layer_norm(xt, wt, bt, EPS), leaves,
                              torch.from_numpy(dy).to(xdt))
    # the CPU takes the plain version: no launch, no route counted
    assert TLN.layer_norm_bwd.LAUNCHES == n
    assert TLN.layer_norm_bwd.ROUTES == routes
    ref = _jax_grads(x, w, b, dy, xdt, wdt, tuple(range(len(leaves))))
    gx = got[0]
    assert gx.dtype == xdt and gx.shape == (rows, H)
    assert _rel(gx, ref[0]) <= TOL[xdt], _rel(gx, ref[0])
    # dw and db are fp32 only when both x and the parameters are: bf16 x
    # rounds its products' inputs
    tol_p = TOL[torch.float32] if xdt == wdt == torch.float32 else 1e-2
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == wdt and g.shape == (H,)
        assert _rel(g, r) <= tol_p, _rel(g, r)


@pytest.mark.parametrize("frozen", ["weight", "x"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("rows,H", [(37, 100), (64, 768), (3, 28680)],
                         ids=["H100", "H768", "H28680"])
def test_frozen_weight_or_x(rows, H, bias, frozen):
    """Only the gradients asked for are formed, and they match the JAX
    kernel's (whose custom_vjp forms all of them). A frozen weight leaves
    the bias trainable when there is one."""
    x, w, b, dy = _inputs(rows, H, seed=rows)
    b = b if bias else None
    xt = torch.from_numpy(x).requires_grad_(frozen == "weight")
    wt = torch.from_numpy(w).requires_grad_(frozen == "x")
    bt = torch.from_numpy(b).requires_grad_(True) if bias else None
    targets = [xt] if frozen == "weight" else [wt]
    argnums = [0] if frozen == "weight" else [1]
    if bias:
        targets.append(bt)
        argnums.append(2)
    got = torch.autograd.grad(TLN.layer_norm(xt, wt, bt, EPS), targets,
                              torch.from_numpy(dy))
    ref = _jax_grads(x, w, b, dy, torch.float32, torch.float32,
                     tuple(argnums))
    for g, r, t in zip(got, ref, targets):
        assert g.shape == t.shape and _rel(g, r) <= 1e-5, _rel(g, r)


def test_backward_forms_only_what_is_asked():
    """``layer_norm_bwd`` on CPU tensors: each need flag alone gives the
    same tensor as the full call, None for the rest, and nothing at all
    when nothing is asked for."""
    x, w, b, dy = (torch.from_numpy(a) for a in _inputs(5, 64, seed=0))
    _, mean, rstd = TLN.layer_norm_fwd_plain(x, w, b, EPS)
    dx, dw, db = TLN.layer_norm_bwd(x, w, mean, rstd, dy)
    assert dx.dtype == x.dtype and dw.dtype == db.dtype == torch.float32
    flags = dict(need_dx=False, need_dw=False, need_db=False)
    for name, full in (("dx", dx), ("dw", dw), ("db", db)):
        out = TLN.layer_norm_bwd(x, w, mean, rstd, dy,
                                 **dict(flags, **{f"need_{name}": True}))
        for other, t in zip(("dx", "dw", "db"), out):
            if other == name:
                assert torch.equal(t, full)
            else:
                assert t is None
    assert TLN.layer_norm_bwd(x, w, mean, rstd, dy, **flags) == \
        (None, None, None)
    # db is the plain sum of dy over the rows, dw of dy * xhat
    xhat = (x - mean[:, None]) * rstd[:, None]
    torch.testing.assert_close(db, dy.sum(0), rtol=0, atol=0)
    torch.testing.assert_close(dw, (dy * xhat).sum(0), rtol=0, atol=0)
