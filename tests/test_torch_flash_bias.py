"""The port's flash attention with an additive bias
(``paddle_tpu_torch.kernels.flash_attention``) against the JAX package's
Pallas flash kernels with a ``bias`` operand, run in interpret mode on the
CPU: the forward and the q / k / v gradients with a bool and an additive
mask, the learned bias's gradient (``bias_grad=True``) at the three bias
shapes, a bias with segment ids, and a bias with dropout at p -> 0; and the
``nn.functional`` ops ``flash_attention`` and ``flash_attn_unpadded``
against the JAX package's.

On the CPU the port's wrappers take the kernels' plain PyTorch versions,
run through ``flash_attention``'s ``torch.autograd.Function``, so these
tests hold what ``chip_smoke.py`` and ``test_torch_flash_bias_kernels_cuda.py``
compare the CUDA kernels with on the card to the JAX kernels. Inputs are
made with numpy from a seed and handed to both packages. Tolerances are the
JAX tests' own (``test_pallas_kernels.py``): 3e-4 rtol and atol for the
bias forward and gradients (``test_flash_attention_bias_mask``), 4e-4 for
the d-bias (``test_flash_bias_grad_broadcast_shapes``), 1e-5 / 1e-4 for the
composed ``nn.functional`` paths (one fp32 algorithm on both sides).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas import flash_attention as JFA
from paddle_tpu_torch.kernels import flash_attention as FA

JNF = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
TNF = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")

B, S, H, D = 2, 128, 2, 64


def _qkv(seed, b=B, s=S, h=H, d=D):
    rng = np.random.RandomState(seed)
    return ((rng.randn(b, s, h, d) * 0.3).astype(np.float32),
            (rng.randn(b, s, h, d) * 0.3).astype(np.float32),
            rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, s, h, d).astype(np.float32))


def _jax(q, k, v, do, bias=None, bias_grad=False, causal=False, seg=None):
    """The Pallas kernel in interpret mode (64 x 64 blocks): out and the vjp
    of sum(out * dO) in q, k, v (and the bias)."""
    args = [jnp.asarray(a) for a in (q, k, v)]
    kw = {}
    if seg is not None:
        kw = dict(q_segment_ids=jnp.asarray(seg),
                  kv_segment_ids=jnp.asarray(seg))

    def f(q_, k_, v_, b_):
        return JFA.flash_attention(q_, k_, v_, causal, None, 64, 64, bias=b_,
                                   bias_grad=bias_grad, **kw)
    out, vjp = jax.vjp(f, *args, jnp.asarray(bias))
    grads = vjp(jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch(q, k, v, do, bias=None, bias_grad=False, causal=False, seg=None,
           **kw):
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    b = torch.from_numpy(bias)
    if bias_grad:
        b.requires_grad_(True)
    if seg is not None:
        kw.update(q_segment_ids=torch.from_numpy(seg),
                  kv_segment_ids=torch.from_numpy(seg))
    n = FA.flash_fwd.LAUNCHES
    out = FA.flash_attention(*t, causal=causal, bias=b, bias_grad=bias_grad,
                             **kw)
    assert FA.flash_fwd.LAUNCHES == n        # the CPU path launches none
    grads = torch.autograd.grad(out, t + ([b] if bias_grad else []),
                                torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _bias(kind, seed, shape=(B, 1, S, S)):
    rs = np.random.RandomState(seed)
    if kind == "bool":
        m = rs.rand(*shape) > 0.3
        return np.where(m, 0.0, -1e30).astype(np.float32)
    return rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_bias_forward_and_grads_match_jax_kernel(kind, causal):
    q, k, v, do = _qkv(27)
    bias = _bias(kind, 30, (B, 1, S, S) if kind == "bool" else (1, H, S, S))
    out_j, g_j = _jax(q, k, v, do, bias, causal=causal)
    out_t, g_t = _torch(q, k, v, do, bias, causal=causal)
    np.testing.assert_allclose(out_t, out_j, rtol=3e-4, atol=3e-4)
    for name, a, b in zip("qkv", g_t, g_j[:3]):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-4, err_msg=name)


def test_bool_mask_is_the_additive_mask():
    """A bool keep-mask given to the port is where(mask, 0, -1e30) in q's
    dtype, as register.py's _sdpa_pallas makes it for the JAX kernel."""
    q, k, v, do = _qkv(3)
    rs = np.random.RandomState(4)
    m = rs.rand(B, 1, S, S) > 0.3
    m[0, 0, 5] = False                           # a row that sees nothing
    additive = np.where(m, 0.0, -1e30).astype(np.float32)
    out_b, g_b = _torch(q, k, v, do, m)
    out_a, g_a = _torch(q, k, v, do, additive)
    np.testing.assert_array_equal(out_b, out_a)
    for a, b in zip(g_b, g_a):
        np.testing.assert_array_equal(a, b)
    assert (out_b[0, 5] == 0).all() and (g_b[0][0, 5] == 0).all()


@pytest.mark.parametrize("shape", ["B,H", "1,H", "1,1"])
def test_dbias_matches_jax_kernel(shape):
    q, k, v, do = _qkv(80)
    mb, mh = (B if shape[0] == "B" else 1), (H if shape[-1] == "H" else 1)
    bias = (_bias("additive", 83, (mb, mh, S, S)) * 0.1).astype(np.float32)
    out_j, g_j = _jax(q, k, v, do, bias, bias_grad=True)
    out_t, g_t = _torch(q, k, v, do, bias, bias_grad=True)
    assert g_t[3].shape == bias.shape == g_j[3].shape
    np.testing.assert_allclose(out_t, out_j, rtol=3e-4, atol=3e-4)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=4e-4, atol=4e-4, err_msg=name)


def test_bias_without_bias_grad_is_a_constant():
    """Without bias_grad no gradient flows into the bias (the JAX vjp's
    zeros): the port returns None for it."""
    q, k, v, _ = _qkv(5)
    b = torch.from_numpy(_bias("additive", 6, (1, H, S, S))).requires_grad_()
    qt = torch.from_numpy(q).requires_grad_(True)
    FA.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                       bias=b).sum().backward()
    assert b.grad is None and qt.grad is not None
    with pytest.raises(ValueError, match="bias_grad"):
        FA.flash_attention(qt, qt, qt, bias=b > 0, bias_grad=True)


def test_bias_with_segments_matches_jax_kernel():
    """A padding bias and packed segment ids together, as BertModel sends a
    2-D mask beside pack_segment_ids; segment bounds off the 64-row tiles,
    and a -1 pad tail (S 256: the JAX gate's multiple of 128)."""
    q, k, v, do = _qkv(41, b=1, s=256)
    seg = np.full((1, 256), -1, np.int32)
    seg[0, :100], seg[0, 100:170] = 0, 1
    bias = np.where(np.arange(256)[None, None, None, :] < 230, 0.0,
                    -1e30).astype(np.float32)              # [1, 1, 1, S]
    bias = np.broadcast_to(bias, (1, 1, 256, 256)).copy()
    out_j, g_j = _jax(q, k, v, do, bias, seg=seg)
    out_t, g_t = _torch(q, k, v, do, bias, seg=seg)
    np.testing.assert_allclose(out_t, out_j, rtol=3e-4, atol=3e-4)
    for name, a, b in zip("qkv", g_t, g_j[:3]):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-4, err_msg=name)
    # a [1, 1, 1, S] bias broadcasts in place to the same answer
    out_r, g_r = _torch(q, k, v, do, np.ascontiguousarray(bias[:, :, :1]),
                        seg=seg)
    np.testing.assert_allclose(out_r, out_t, rtol=0, atol=1e-6)


def test_bias_with_dropout_at_p_to_zero_is_the_bias_alone():
    """The JAX kernel's dropout bits come from the TPU's PRNG, which the CPU
    cannot run: the port's bias-with-dropout path at p -> 0 (threshold 4 of
    2^32) against the JAX kernel with the bias alone."""
    q, k, v, do = _qkv(90)
    bias = _bias("bool", 91)
    out_j, g_j = _jax(q, k, v, do, bias)
    out_t, g_t = _torch(q, k, v, do, bias, dropout_p=1e-9, dropout_seed=123)
    np.testing.assert_allclose(out_t, out_j, rtol=3e-4, atol=3e-4)
    for name, a, b in zip("qkv", g_t, g_j[:3]):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-4, err_msg=name)
    # and at p = 0.5 the forward and the backward draw one mask: the plain
    # backward from the forward's lse gives autograd's gradients
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    bt, dot = torch.from_numpy(bias), torch.from_numpy(do)
    out, lse = FA.flash_fwd(qt, kt, vt, False, D ** -0.5, bt, dropout_p=0.5,
                            seed=7)
    got = FA.flash_bwd(qt, kt, vt, lse, dot, False, D ** -0.5, bias=bt,
                       dropout_p=0.5, seed=7)
    _, via_autograd = _torch(q, k, v, do, bias, dropout_p=0.5,
                             dropout_seed=7)
    for a, b in zip(got, via_autograd):
        np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# nn.functional: flash_attention and flash_attn_unpadded
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
def test_functional_flash_attention_matches_jax(causal):
    q, k, v, do = _qkv(11, s=48)
    out_j = np.asarray(JNF.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal)[0])
    out_t, sm = TNF.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=causal)
    assert sm is None
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-5, atol=1e-5)
    for mod, arr in ((JNF, jnp.asarray), (TNF, torch.from_numpy)):
        with pytest.raises(NotImplementedError, match="return_softmax"):
            mod.flash_attention(arr(q), arr(k), arr(v), return_softmax=True)


UNPADDED = {  # causal, cu_q, cu_k (None: the same object as cu_q)
    "noncausal": (False, [0, 30, 75, 100], [0, 20, 64, 100]),
    "causal-one-packing": (True, [0, 30, 75, 100], None),
    "causal-two-packings": (True, [0, 30, 75, 100], [0, 50, 70, 100]),
}


@pytest.mark.parametrize("case", list(UNPADDED))
def test_flash_attn_unpadded_matches_jax(case):
    causal, cq, ck = UNPADDED[case]
    rng = np.random.RandomState(len(case))
    q, k, v, do = (rng.randn(100, 4, 16).astype(np.float32)
                   for _ in range(4))
    k, v = k[:, :2].copy(), v[:, :2].copy()          # GQA 4 / 2
    cqj = jnp.asarray(cq, jnp.int32)
    ckj = cqj if ck is None else jnp.asarray(ck, jnp.int32)

    def jf(q_, k_, v_):
        return JNF.flash_attn_unpadded(q_, k_, v_, cqj, ckj, 75, 75,
                                       causal=causal)[0]
    out_j, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    g_j = vjp(jnp.asarray(do))
    cqt = torch.tensor(cq, dtype=torch.int32)
    ckt = cqt if ck is None else torch.tensor(ck, dtype=torch.int32)
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out_t, sm = TNF.flash_attn_unpadded(*t, cqt, ckt, 75, 75, causal=causal)
    assert sm is None
    g_t = torch.autograd.grad(out_t, t, torch.from_numpy(do))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    for name, a, b in zip("qkv", g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_segments_from_cu_matches_jax():
    cu = [0, 3, 3, 9, 10]
    got = TNF._segments_from_cu(torch.tensor(cu, dtype=torch.int32), 12)
    want = JNF._segments_from_cu(jnp.asarray(cu, jnp.int32), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_unported_attention_ops_raise():
    # flashmask_attention is ported (test_torch_flashmask.py); C = 3 is
    # refused as the JAX op refuses it
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="1, 2 or 4"):
        TNF.flashmask_attention(q, q, q, torch.zeros(1, 1, 8, 3),
                                causal=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        TNF.sdp_kernel(enable_flash=False)
