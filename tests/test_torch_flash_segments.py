"""The segment-id and dropout variants of the port's flash attention
(``paddle_tpu_torch.kernels.flash_attention``) on the CPU, where its wrappers
take the kernels' plain PyTorch versions.

Segments: against the JAX package's ``flash_attention(q_segment_ids=,
kv_segment_ids=)`` in interpret mode, forward and gradients, with the cases
and tolerances of ``test_pallas_kernels.py`` (2e-4 forward, 3e-4
gradients): four aligned segments under causal masking, boundaries that
do not align with a tile plus a pad tail, a row whose id matches no key,
and GQA. Dropout cannot match across the packages (the TPU keys its bits by
tile), so the port's mask is checked on its own: its Philox4x32-10 against
Random123's known-answer vectors, that it is a function of (seed, b, h, i,
j) alone, its keep rate, and that the plain backward with that mask equals
autograd through a composed attention that applies it. The CUDA kernels are
held to these plain versions on the card by
``test_torch_bert_kernels_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas.flash_attention import flash_attention \
    as jax_flash
from paddle_tpu_torch.kernels import flash_attention as FA

JNF = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")


def _rand(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, ref, tol, what):
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=what)


def _packed_ids(lengths, s):
    seg = np.full((s,), -1, np.int32)
    off = 0
    for i, n in enumerate(lengths):
        seg[off:off + n] = i
        off += n
    return seg


SEG_CASES = {
    # name: (b, s, h, h_kv, d, causal, qseg [b, s], kseg [b, s], block)
    "aligned-causal": (1, 256, 2, 2, 64, True,
                       np.repeat([0, 1, 2, 3], 64)[None], None, 64),
    "misaligned-pads": (1, 384, 2, 2, 64, False,
                        _packed_ids([140, 40, 120], 384)[None], None, 64),
    "dead-rows": (1, 256, 2, 2, 64, False,
                  np.r_[np.zeros(128), np.full(128, 7)][None],
                  np.zeros((1, 256)), 128),
    "gqa-two-rows": (2, 128, 4, 2, 64, False,
                     np.stack([_packed_ids([50, 60], 128),
                               _packed_ids([128], 128)]), None, 64),
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_segments_match_jax_kernel(case):
    b, s, h, hkv, d, causal, qseg, kseg, block = SEG_CASES[case]
    kseg = qseg if kseg is None else kseg
    qseg, kseg = qseg.astype(np.int32), kseg.astype(np.int32)
    q = _rand(b, s, h, d, seed=1) * 0.3
    k = _rand(b, s, hkv, d, seed=2) * 0.3
    v = _rand(b, s, hkv, d, seed=3)
    do = _rand(b, s, h, d, seed=4)

    def jloss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, causal, None, block, block,
                      q_segment_ids=jnp.asarray(qseg),
                      kv_segment_ids=jnp.asarray(kseg))
        return jnp.sum(o * jnp.asarray(do)), o
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = FA.flash_attention(qt, kt, vt, causal=causal,
                             q_segment_ids=torch.from_numpy(qseg),
                             kv_segment_ids=torch.from_numpy(kseg))
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    _close(out.detach().numpy(), np.asarray(jout), 2e-4, "out")
    for what, g, r in zip(("dq", "dk", "dv"), grads, jgrads):
        _close(g.numpy(), np.asarray(r), 3e-4, what)
    if case == "dead-rows":
        # rows that match no key: zeros, lse -1e30, no gradient into q
        assert float(out.detach()[:, 128:].abs().max()) == 0.0
        assert float(grads[0][:, 128:].abs().max()) == 0.0
        _, lse = FA.flash_fwd(qt.detach(), kt.detach(), vt.detach(), causal,
                              d ** -0.5, q_seg=torch.from_numpy(qseg),
                              kv_seg=torch.from_numpy(kseg))
        assert torch.all(lse[:, :, 128:] == -1e30)


def test_sdpa_segment_ids_cpu_path_matches_the_flash_plain_path():
    """The registry op on the CPU (composed ``_sdpa_reference``) and the
    flash plain versions give one answer for packed rows."""
    seg = np.stack([_packed_ids([30, 50, 20], 128), _packed_ids([100], 128)])
    q, k, v = (torch.from_numpy(_rand(2, 128, 2, 64, seed=i) * 0.5)
               for i in (5, 6, 7))
    seg_t = torch.from_numpy(seg)
    ref = JNF.scaled_dot_product_attention(q, k, v, segment_ids=seg_t)
    got = FA.flash_attention(q, k, v, q_segment_ids=seg_t,
                             kv_segment_ids=seg_t)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
], ids=["zeros", "ones"])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for philox4x32-10."""
    c = [torch.tensor([x], dtype=torch.int64) for x in counter]
    got = FA.philox4x32_10(*c, *key)
    assert tuple(int(w) for w in got) == want


def test_mask_is_a_function_of_its_coordinates_alone():
    """The mask at (b, h, i, j) does not depend on the shape it was drawn
    in (so the kernels' different tilings regenerate it), and it is word
    j % 4 of one Philox call per (b, h, i, j // 4)."""
    seed, p = 123456789012345, 0.3
    big = FA.dropout_keep_mask(seed, 3, 4, 70, 133, p)
    small = FA.dropout_keep_mask(seed, 2, 3, 33, 61, p)
    assert torch.equal(big[:2, :3, :33, :61], small)
    rng = np.random.RandomState(0)
    lo, hi = seed & 0xFFFFFFFF, seed >> 32
    for _ in range(20):
        b, h, i, j = (int(rng.randint(n)) for n in (3, 4, 70, 133))
        words = FA.philox4x32_10(*(torch.tensor([x]) for x in
                                   (j // 4, i, h, b)), lo, hi)
        keep = int(words[j % 4]) >= FA.dropout_threshold(p)
        assert bool(big[b, h, i, j]) == keep
    assert not torch.equal(FA.dropout_keep_mask(seed + 1, 3, 4, 70, 133, p),
                           big)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_is_binomial(p):
    n = 4 * 8 * 128 * 128
    kept = int(FA.dropout_keep_mask(7, 4, 8, 128, 128, p).sum())
    sigma = (n * p * (1 - p)) ** 0.5
    assert abs(kept - n * (1 - p)) <= 4 * sigma, (kept, n * (1 - p), sigma)


def _composed_with_mask(q, k, v, keep, p, causal, qseg=None):
    """Attention with an explicit keep-mask, differentiated by autograd."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    sq, sk = s.shape[-2:]
    ok = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        ok = ok.tril(sk - sq)
    if qseg is not None:
        ok = ok & (qseg[:, None, :, None] == qseg[:, None, None, :])
    prob = torch.softmax(s.masked_fill(~ok, -1e30), -1)
    prob = torch.where(keep, prob / (1 - p), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", prob, v)


@pytest.mark.parametrize("causal,segments", [(False, False), (True, False),
                                             (False, True)])
def test_dropout_backward_equals_autograd_through_the_mask(causal, segments):
    B, S, H, D, p, seed = 2, 96, 2, 64, 0.25, 42
    q, k, v, do = (torch.from_numpy(_rand(B, S, H, D, seed=i) * 0.5)
                   for i in (8, 9, 10, 11))
    seg = (torch.from_numpy(np.stack([_packed_ids([40, 56], S)] * 2))
           if segments else None)
    keep = FA.dropout_keep_mask(seed, B, H, S, S, p)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = _composed_with_mask(qr, kr, vr, keep, p, causal, seg)
    ref_g = torch.autograd.grad(ref, (qr, kr, vr), do)
    qf, kf, vf = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = FA.flash_attention(qf, kf, vf, causal=causal, q_segment_ids=seg,
                             kv_segment_ids=seg, dropout_p=p,
                             dropout_seed=seed)
    got_g = torch.autograd.grad(out, (qf, kf, vf), do)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    for g, r in zip(got_g, ref_g):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


def test_dropout_arguments():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="dropout_seed"):
        FA.flash_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="together"):
        FA.flash_attention(q, q, q, q_segment_ids=torch.zeros(1, 8))
    with pytest.raises(ValueError, match="flashmask start rows"):
        FA.flash_attention(q, q, q, startend_row_indices=(0, 0),
                           dropout_p=0.1, dropout_seed=1)
    # the same seed gives the same output, another seed another one
    x = torch.from_numpy(_rand(1, 64, 2, 64, seed=12))
    a = FA.flash_attention(x, x, x, dropout_p=0.5, dropout_seed=3)
    assert torch.equal(a, FA.flash_attention(x, x, x, dropout_p=0.5,
                                             dropout_seed=3))
    assert not torch.equal(a, FA.flash_attention(x, x, x, dropout_p=0.5,
                                                 dropout_seed=4))
