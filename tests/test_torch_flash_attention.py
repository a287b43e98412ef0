"""The port's flash attention (``paddle_tpu_torch.kernels.flash_attention``)
against the JAX package's Pallas flash kernels, run in interpret mode on
the CPU, and the port's composed attention (``nn.functional``) against the
JAX package's.

On the CPU the port's wrappers take the kernels' plain PyTorch versions, and
``flash_attention`` runs them through its ``torch.autograd.Function``, so
these tests hold the forward (out and lse) and the backward (dq, dk, dv) that
``chip_smoke.py`` compares the CUDA kernels with on the card to the JAX
kernels. Inputs are made with numpy from a seed and handed to both packages.
Tolerances are those of ``test_flash_training.py``: fp32 2e-5 (out) and
2e-4 (grads, relative to their max-abs); bf16 2e-2 and 5e-2. The CUDA
kernels themselves are tested on the card by
``test_torch_train_kernels_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas import flash_attention as JFA
from paddle_tpu_torch.kernels import flash_attention as FA

# the module, not the function of the same name the package exports
JNF = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
TNF = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")

TOL = {"fp32": (2e-5, 2e-4), "bf16": (2e-2, 5e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _inputs(B, sq, sk, H, Hkv, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, sq, H, D).astype(np.float32),
            rng.randn(B, sk, Hkv, D).astype(np.float32),
            rng.randn(B, sk, Hkv, D).astype(np.float32),
            rng.randn(B, sq, H, D).astype(np.float32))


def _jax_flash(q, k, v, do, causal, dt):
    """JAX kernel in interpret mode: out, lse [B, H, Sq], and the vjp of
    sum(out * dO) as dq, dk, dv."""
    qj, kj, vj = (jnp.asarray(a).astype(JDT[dt]) for a in (q, k, v))
    B, sq, H, D = q.shape
    scale = 1.0 / np.sqrt(D)
    bq, bk = JFA._pick_block(sq), JFA._pick_block(k.shape[1])
    out, res = JFA._flash_fwd(qj, kj, vj, None, None, None, None, causal,
                              scale, bq, bk, None, 0.0)
    lse = np.asarray(res[4]).reshape(B, H, sq)

    def loss(q_, k_, v_):
        o = JFA.flash_attention(q_, k_, v_, causal=causal)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))
    grads = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return f32(out), lse, [f32(g) for g in grads]


def _torch_flash(q, k, v, do, causal, dt, fn=None):
    qt, kt, vt = (torch.from_numpy(a).to(TDT[dt]).requires_grad_(True)
                  for a in (q, k, v))
    fn = fn or (lambda a, b, c: FA.flash_attention(a, b, c, causal=causal))
    out = fn(qt, kt, vt)
    grads = torch.autograd.grad(out, (qt, kt, vt),
                                torch.from_numpy(do).to(out.dtype))
    return out, [g.float().numpy() for g in grads]


def _close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, (what, err, tol)


CASES = {  # B, sq, sk, H, Hkv, D, causal
    "square-causal": (2, 128, 128, 4, 4, 16, True),
    "square-noncausal": (2, 128, 128, 4, 4, 16, False),
    "rect-causal-128x256": (1, 128, 256, 4, 4, 16, True),
    "rect-causal-256x128-dead-rows": (1, 256, 128, 4, 4, 16, True),
    "gqa-4-2": (2, 128, 128, 4, 2, 16, True),
    "mqa-4-1": (1, 128, 256, 4, 1, 16, False),
}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_matches_jax_kernel(case, dt):
    B, sq, sk, H, Hkv, D, causal = CASES[case]
    q, k, v, do = _inputs(B, sq, sk, H, Hkv, D)
    out_j, lse_j, grads_j = _jax_flash(q, k, v, do, causal, dt)
    n = FA.flash_fwd.LAUNCHES
    out_t, grads_t = _torch_flash(q, k, v, do, causal, dt)
    assert FA.flash_fwd.LAUNCHES == n            # the CPU path launches none
    assert out_t.dtype == TDT[dt] and out_t.shape == q.shape
    tol_o, tol_g = TOL[dt]
    _close(out_t.float().detach().numpy(), out_j, tol_o, "out")
    for name, gt, gj in zip(("dq", "dk", "dv"), grads_t, grads_j):
        assert gt.shape == gj.shape
        _close(gt, gj, tol_g, name)
    # lse (fp32 in both), dead rows included: -1e30 where no key is visible
    _, lse_t = FA.flash_fwd(*(torch.from_numpy(a).to(TDT[dt])
                              for a in (q, k, v)), causal, 1.0 / np.sqrt(D))
    live = lse_j > -1e29
    assert np.array_equal(lse_t.numpy() > -1e29, live)
    np.testing.assert_allclose(lse_t.numpy()[live], lse_j[live], rtol=1e-5,
                               atol=2e-5 if dt == "fp32" else 2e-2)
    if causal and sq > sk:
        assert not live.all()
        assert (out_t[:, :sq - sk] == 0).all()


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("Hkv", [4, 2])
def test_flash_any_length_matches_jax_composed(dt, Hkv):
    """S = 100: the Pallas gate needs S % 128, the port's kernels do not, so
    the reference is the JAX composed path."""
    q, k, v, do = _inputs(2, 100, 100, 4, Hkv, 16, seed=1)
    qj, kj, vj = (jnp.asarray(a).astype(JDT[dt]) for a in (q, k, v))

    def loss(q_, k_, v_):
        o = JNF._sdpa_reference(q_, k_, v_, is_causal=True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))
    out_j = np.asarray(JNF._sdpa_reference(qj, kj, vj, is_causal=True)
                       .astype(jnp.float32))
    grads_j = [np.asarray(g.astype(jnp.float32))
               for g in jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)]
    out_t, grads_t = _torch_flash(q, k, v, do, True, dt)
    tol_o, tol_g = TOL[dt]
    _close(out_t.float().detach().numpy(), out_j, tol_o, "out")
    for name, gt, gj in zip(("dq", "dk", "dv"), grads_t, grads_j):
        _close(gt, gj, tol_g, name)


def test_split_backward_matches_plain():
    """flash_bwd_dq (which forms delta) then flash_bwd_dkv: the pieces the
    card runs as two kernels give the plain backward's dq, dk, dv."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 96, 160, 4, 2, 16))
    lse = FA.flash_fwd(q, k, v, True, 0.25)[1]
    dq, delta = FA.flash_bwd_dq(q, k, v, lse, do, True, 0.25)
    dk, dv = FA.flash_bwd_dkv(q, k, v, lse, delta, do, True, 0.25)
    ref = FA.flash_bwd_plain(q, k, v, lse, do, True, 0.25)
    assert delta.shape == (2, 4, 96) and delta.dtype == torch.float32
    for got, want in zip((dq, dk, dv), ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _converged(seed=0, spread=0.03, B=1, S=128, H=2, D=64):
    """bf16 q, k, v, dO whose keys and values nearly coincide (a common
    vector per head plus ``spread`` noise), as the token states of a deep
    random-init encoder do: the true dq is tiny beside |dO| |O|."""
    rng = np.random.RandomState(seed)
    base_k, base_v = rng.randn(1, 1, H, D), rng.randn(1, 1, H, D)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    return (t(rng.randn(B, S, H, D)),
            t(base_k + spread * rng.randn(B, S, H, D)),
            t(base_v + spread * rng.randn(B, S, H, D)),
            t(rng.randn(B, S, H, D)))


def _fp64_grads(q, k, v, do, scale):
    qd, kd, vd = (t.double().requires_grad_(True) for t in (q, k, v))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vd)
    return torch.autograd.grad(o, (qd, kd, vd), do.double())


def test_delta_from_p_dp_keeps_dq_when_keys_converge():
    """delta = rowsum(p * dP) in fp32, as the kernels form it, keeps dq and
    dk within 1e-2 of fp64 on bf16 inputs whose keys nearly coincide; the
    same backward with delta = rowsum(dO * O) from the bf16 output misses
    dq by more than its own size there (each row's dS no longer sums to
    zero, and dq picks up that error times the mean key)."""
    q, k, v, do = _converged()
    scale = 64 ** -0.5
    out, lse = FA.flash_fwd_plain(q, k, v, False, scale)
    ref = _fp64_grads(q, k, v, do, scale)
    rel = lambda a, b: ((a.double() - b).norm() / b.norm()).item()  # noqa
    dq, dk, dv = FA.flash_bwd_plain(q, k, v, lse, do, False, scale)
    assert max(rel(dq, ref[0]), rel(dk, ref[1]), rel(dv, ref[2])) <= 1e-2
    from_out = (do.float() * out.float()).sum(-1).transpose(1, 2)
    dq_out = FA.flash_bwd_plain(q, k, v, lse, do, False, scale,
                                delta=from_out)[0]
    assert rel(dq_out, ref[0]) > 1.0


@pytest.mark.parametrize("kw", [dict(startend_row_indices=(0, 0)),
                                dict(window=(4, 0))],
                         ids=["flashmask", "window"])
def test_unported_arguments_raise(kw):
    # the bias backward and bias_grad (test_torch_flash_bias.py), the
    # flashmask rows and the window (test_torch_flashmask.py) are ported:
    # scalar rows are refused by shape, a (4, 0) window keeps its band
    q = torch.from_numpy(_inputs(1, 8, 8, 2, 2, 16, seed=7)[0])
    if "startend_row_indices" in kw:
        with pytest.raises(ValueError, match="flashmask start rows"):
            FA.flash_attention(q, q, q, causal=True, **kw)
        return
    out = FA.flash_attention(q, q, q, causal=True, **kw)
    d = torch.arange(8)[None, :] - torch.arange(8)[:, None]
    ref = TNF._sdpa_reference(q, q, q, attn_mask=(d >= -4) & (d <= 0))
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the forward with an additive bias (the two-program prefill's mask)
# ---------------------------------------------------------------------------
BIAS_SHAPES = ["1,1", "B,1", "1,H", "B,H"]


def _bias(rng, B, H, sq, sk, shape, dead_row=None):
    mb, mh = (B if shape[0] == "B" else 1), (H if shape[-1] == "H" else 1)
    bias = (rng.randn(mb, mh, sq, sk) * 2).astype(np.float32)
    bias[..., ::3] = -1e30                       # masked keys
    if dead_row is not None:
        bias[..., dead_row, :] = -1e30           # a row that sees nothing
    return bias


@pytest.mark.parametrize("shape", BIAS_SHAPES)
@pytest.mark.parametrize("S,causal", [(128, False), (256, True)])
def test_flash_bias_forward_matches_jax_kernel(S, causal, shape):
    """flash_fwd_plain with a bias against the JAX kernel's bias variant
    (interpret mode), fp32 at 2e-5 (test_flash_training's forward bound);
    the row the bias kills gives zeros and lse -1e30 in the port, zeros in
    JAX."""
    B, H, D = 2, 4, 16
    rng = np.random.RandomState(4)
    q, k, v, _ = _inputs(B, S, S, H, H, D, seed=5)
    bias = _bias(rng, B, H, S, S, shape, dead_row=7)
    ref = np.asarray(JFA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bias=jnp.asarray(bias)))
    n = FA.flash_fwd.LAUNCHES
    with torch.no_grad():
        out = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal, bias=torch.from_numpy(bias))
        _, lse = FA.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal, D ** -0.5, torch.from_numpy(bias))
    assert FA.flash_fwd.LAUNCHES == n            # the CPU path launches none
    _close(out.numpy(), ref, TOL["fp32"][0], "out")
    assert (out[:, 7] == 0).all() and (ref[:, 7] == 0).all()
    assert (lse[:, :, 7] == -1e30).all() and (lse[:, :, 8] > -1e29).all()


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_bool_mask_as_bias_gives_the_composed_answer(dt):
    """What the card runs for a keep-mask (where(mask, 0, -1e30) in q's
    dtype, added by the forward) against the composed path the CPU runs,
    on the prefill's shapes: Sq != Sk, neither a multiple of 128, a fully
    masked row."""
    P, C, cap, H, D = 2, 40, 72, 4, 16
    q, k, v, _ = (torch.from_numpy(a).to(TDT[dt])
                  for a in _inputs(P, C, cap, H, H, D, seed=6))
    pos = torch.tensor([[0], [25]]) + torch.arange(C)
    mask = (torch.arange(cap)[None, None] <= pos[:, :, None])[:, None]
    mask[1, 0, 3] = False
    ref = TNF._sdpa_reference(q, k, v, attn_mask=mask)
    bias = torch.where(mask, 0.0, -1e30).to(q.dtype)
    out, lse = FA.flash_fwd_plain(q, k, v, False, D ** -0.5, bias)
    _close(out.float().numpy(), ref.float().numpy(), TOL[dt][0], "out")
    assert (out[1, 3] == 0).all() and (lse[1, :, 3] == -1e30).all()


# ---------------------------------------------------------------------------
# the registry op's composed path (nn.functional)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["causal", "bool-mask", "float-mask",
                                     "segments", "gqa"])
def test_sdpa_reference_matches_jax(variant):
    rng = np.random.RandomState(2)
    B, S, H, D = 2, 12, 4, 8
    Hkv = 2 if variant == "gqa" else H
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, Hkv, D).astype(np.float32)
    v = rng.randn(B, S, Hkv, D).astype(np.float32)
    kw_j, kw_t = {}, {}
    if variant in ("causal", "gqa"):
        kw_j["is_causal"] = kw_t["is_causal"] = True
    if variant == "bool-mask":
        m = rng.rand(B, 1, S, S) > 0.3
        m[0, 0, 3] = False                       # a fully masked row
        kw_j["attn_mask"], kw_t["attn_mask"] = jnp.asarray(m), \
            torch.from_numpy(m)
    if variant == "float-mask":
        m = (rng.randn(1, H, S, S) * 2).astype(np.float32)
        kw_j["attn_mask"], kw_t["attn_mask"] = jnp.asarray(m), \
            torch.from_numpy(m)
    if variant == "segments":
        seg = np.repeat(np.array([[0, 1, 2]]), 4, axis=1).repeat(B, 0)
        kw_j["segment_ids"], kw_t["segment_ids"] = jnp.asarray(seg), \
            torch.from_numpy(seg)
    ref = np.asarray(JNF._sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **kw_j))
    out = TNF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **kw_t)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
