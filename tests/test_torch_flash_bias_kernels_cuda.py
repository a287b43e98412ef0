"""The padded-BERT slice's flash kernels on the card: the forward, dQ and
dK/dV kernels with an additive bias (alone, with dropout, with segment ids),
the d-bias, an fp32 bias beside bf16 q read in its own dtype, every head dim
up to 256 in fp32, bf16 and fp16, each against its plain PyTorch version on
the same inputs; the registry op's routes (D above 256 to the composed
path, ``flash_attn_unpadded``'s two kernel routes); and a tiny padded BERT
step's launch counts and its card-vs-CPU agreement.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest tests/test_torch_flash_bias_kernels_cuda.py --noconftest -q
"""

import importlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.nn import functional_call, functional_train_graph
from paddle_tpu_torch.nn.functional import (flash_attn_unpadded,
                                            scaled_dot_product_attention)

TNF = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")

pytestmark = pytest.mark.cuda

# flash (out, grads) on the worst 64-row tile's ||got - ref|| / ||ref||, as
# chip_smoke.py phase 6: fp32 summation order; 16-bit rounding of the
# outputs and of the tensor-core operands (fp16 held to the bf16 tier)
FLASH_TOL = {torch.float32: 5e-6, torch.bfloat16: 2e-2, torch.float16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tile_rel(got, ref, rows=64):
    """Worst ||got - ref|| / ||ref|| over 64-row tiles of dim 1 and each
    head (dim 2) of a [B, S, H, D] tensor."""
    r = ref.float()
    d = got.float() - r
    pad = -d.shape[1] % rows
    d, r = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (d, r))
    B, S, H, D = d.shape
    dd, rr = (t.reshape(B, S // rows, rows, H, D).square().sum((2, 4))
              for t in (d, r))
    ratio = torch.where(rr > 0, (dd / rr.clamp_min(1e-30)).sqrt(),
                        torch.where(dd > 0, float("inf"), 0.0))
    return ratio.max().item()


def _l2_rel(got, ref):
    return ((got.float() - ref.float()).norm()
            / ref.float().norm().clamp_min(1e-30)).item()


def _randn(gen, dev, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


def _pad_mask(lens, S, dev):
    """``bench_bert_base``'s bool mask, [B, 1, S, S]: pairs of valid
    positions only, so every pad query row sees no key."""
    valid = torch.arange(S, device=dev)[None, :] < torch.tensor(
        lens, device=dev)[:, None]
    return valid[:, None, None, :] & valid[:, None, :, None]


def _check(q, k, v, do, causal, var, tol, bias_grad=False):
    """Kernels vs plain: out, lse, dq, dk, dv (and the d-bias)."""
    scale = q.shape[-1] ** -0.5
    out, lse = FA.flash_fwd(q, k, v, causal, scale, var.get("bias"),
                            var.get("q_seg"), var.get("kv_seg"),
                            var.get("dropout_p", 0.0), var.get("seed", 0))
    grads = FA.flash_bwd(q, k, v, lse, do, causal, scale, bias_grad=bias_grad,
                         **var)
    torch.cuda.synchronize()
    out_p, lse_p = FA.flash_fwd_plain(q, k, v, causal, scale,
                                      var.get("bias"), var.get("q_seg"),
                                      var.get("kv_seg"),
                                      var.get("dropout_p", 0.0),
                                      var.get("seed", 0))
    ref = FA.flash_bwd_plain(q, k, v, lse, do, causal, scale,
                             bias_grad=bias_grad, **var)
    live = lse_p > -1e29
    assert torch.equal(live, lse > -1e29)
    if live.any():
        assert ((lse - lse_p).abs()[live].max()
                <= 1e-5 * lse_p.abs()[live].max().clamp_min(1.0)).item()
    assert (out.transpose(1, 2)[~live] == 0).all()        # dead rows
    assert out.dtype == q.dtype and out.shape == q.shape
    assert _tile_rel(out, out_p) <= tol
    for got, want in zip(grads[:3], ref[:3]):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.isfinite(got.float()).all()
        assert _tile_rel(got, want) <= tol
    assert (grads[0].transpose(1, 2)[~live] == 0).all()   # no dq there
    return out, lse, grads, ref


# ---------------------------------------------------------------------------
# the bias backward, alone and with dropout and segments
# ---------------------------------------------------------------------------
VARIANTS = ["bias", "bias-dropout", "bias-segments", "bias-segments-dropout"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("hkv", [4, 2])
def test_bias_kernels_match_plain(card, variant, dtype, hkv):
    """The padded BERT's call at a small size: a [B, 1, S, S] bool padding
    mask as an additive bias in q's dtype (pad query rows are dead), S not
    a multiple of the 64-row tile."""
    B, S, H, D = 2, 200, 4, 64
    gen = torch.Generator(device=card).manual_seed(len(variant) + hkv)
    q, do = (_randn(gen, card, dtype, B, S, H, D) for _ in range(2))
    k, v = (_randn(gen, card, dtype, B, S, hkv, D) for _ in range(2))
    mask = _pad_mask([150, 200], S, card)
    var = dict(bias=torch.where(mask, 0.0, -1e30).to(dtype))
    if "segments" in variant:
        seg = torch.from_numpy(np.stack([
            np.r_[np.zeros(90), np.ones(110)],
            np.r_[np.zeros(64), np.ones(64), np.full(72, 2)]]).astype(
                np.int32)).to(card)
        var.update(q_seg=seg, kv_seg=seg)
    if "dropout" in variant:
        var.update(dropout_p=0.1, seed=2 ** 33 + 77)
    out, lse, _, _ = _check(q, k, v, do, False, var, FLASH_TOL[dtype])
    assert (lse[0, :, 150:] == -1e30).all() and (out[0, 150:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_causal_gqa_and_a_float_bias(card, dtype):
    """Causal with Sq < Sk, GQA 4:1, a float bias [1, H, Sq, Sk] with a
    row it kills, and dropout."""
    B, Sq, Sk, H, D = 2, 96, 160, 8, 64
    gen = torch.Generator(device=card).manual_seed(3)
    q, do = (_randn(gen, card, dtype, B, Sq, H, D) for _ in range(2))
    k, v = (_randn(gen, card, dtype, B, Sk, 2, D) for _ in range(2))
    bias = torch.randn(1, H, Sq, Sk, generator=gen, device=card) * 2
    bias[:, :, 7] = -1e30
    var = dict(bias=bias.to(dtype), dropout_p=0.1, seed=5)
    _, lse, _, _ = _check(q, k, v, do, True, var, FLASH_TOL[dtype])
    assert (lse[:, :, 7] == -1e30).all()


def test_dropout_mask_is_shared_with_a_bias(card):
    """With a bias the three kernels still draw dropout_keep_mask: q = k = 0
    and a zero bias make every probability 1 / S, v = I reads the dropped
    row out of the forward, dO = I reads it out of dK/dV's dV."""
    B, S, H, p, seed = 2, 64, 3, 0.1, 2 ** 40 + 5
    for dtype in (torch.bfloat16, torch.float32):
        z = torch.zeros(B, S, H, S, device=card, dtype=dtype)
        eye = torch.eye(S, device=card, dtype=dtype)[None, :, None, :].expand(
            B, S, H, S).contiguous()
        bias = torch.zeros(1, 1, S, S, device=card, dtype=dtype)
        out, lse = FA.flash_fwd(z, z, eye, False, 1.0, bias, dropout_p=p,
                                seed=seed)
        _, dv = FA.flash_bwd_dkv(z, z, eye, lse, torch.zeros_like(lse), eye,
                                 False, 1.0, dropout_p=p, seed=seed,
                                 bias=bias)
        keep = FA.dropout_keep_mask(seed, B, H, S, S, p, card)
        assert torch.equal(out.permute(0, 2, 1, 3) > 0, keep)
        assert torch.equal(dv.permute(0, 2, 3, 1) > 0, keep)


# ---------------------------------------------------------------------------
# the d-bias
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["B,H", "1,H", "1,1"])
@pytest.mark.parametrize("extra", ["none", "causal-segments-dropout"])
def test_dbias_matches_plain(card, shape, dtype, extra):
    B, S, H, D = 2, 130, 4, 64
    gen = torch.Generator(device=card).manual_seed(len(shape) + len(extra))
    q, k, v, do = (_randn(gen, card, dtype, B, S, H, D) for _ in range(4))
    mb, mh = (B if shape[0] == "B" else 1), (H if shape[-1] == "H" else 1)
    bias = (torch.randn(mb, mh, S, S, generator=gen, device=card)).to(dtype)
    var = dict(bias=bias)
    causal = extra != "none"
    if causal:
        seg = torch.from_numpy(np.stack([
            np.r_[np.zeros(70), np.ones(60)], np.zeros(130)]).astype(
                np.int32)).to(card)
        var.update(q_seg=seg, kv_seg=seg, dropout_p=0.1, seed=11)
    _, lse, grads, ref = _check(q, k, v, do, causal, var, FLASH_TOL[dtype],
                                bias_grad=True)
    db, db_p = grads[3], ref[3]
    assert db.shape == bias.shape and db.dtype == bias.dtype
    assert torch.isfinite(db.float()).all()
    assert _l2_rel(db, db_p) <= (5e-6 if dtype == torch.float32 else 2e-2)
    # the full d-bias is zero on the tiles the dQ kernel skips (past the
    # causal bound, disjoint segments)
    dfull = FA.flash_bwd_dq(q, k, v, lse, do, causal, D ** -0.5,
                            bias_grad=True, **var)[2]
    assert dfull.shape == (B, H, S, S) and dfull.dtype == torch.float32
    if causal:
        assert (dfull.triu(1) == 0).all()
        assert (dfull[0, :, 70:, :70] == 0).all()      # other segment


def test_dbias_through_autograd(card):
    """flash_attention(bias_grad=True) gives the bias a gradient (summed over
    its broadcast dims); without it the bias stays a constant."""
    B, S, H, D = 2, 96, 2, 64
    gen = torch.Generator(device=card).manual_seed(8)
    q, k, v, do = (_randn(gen, card, torch.float32, B, S, H, D)
                   for _ in range(4))
    bias = torch.randn(1, H, S, S, generator=gen, device=card)
    qq, kk, vv, bb = (t.clone().requires_grad_(True) for t in (q, k, v, bias))
    out = FA.flash_attention(qq, kk, vv, bias=bb, bias_grad=True)
    gq, gk, gv, gb = torch.autograd.grad(out, (qq, kk, vv, bb), do)
    lse = FA.flash_fwd_plain(q, k, v, False, D ** -0.5, bias)[1]
    ref = FA.flash_bwd_plain(q, k, v, lse, do, False, D ** -0.5, bias=bias,
                             bias_grad=True)
    for got, want in zip((gq, gk, gv), ref[:3]):
        assert _tile_rel(got, want) <= FLASH_TOL[torch.float32]
    assert _l2_rel(gb, ref[3]) <= 5e-6
    bb2 = bias.clone().requires_grad_(True)
    out = FA.flash_attention(qq, kk, vv, bias=bb2)
    out.sum().backward()
    assert bb2.grad is None


# ---------------------------------------------------------------------------
# fault: a float bias was rounded to q's dtype before it was added
# ---------------------------------------------------------------------------
def test_fp32_bias_with_bf16_q_is_read_in_fp32(card):
    """An ALiBi-like fp32 bias in [-64, 0] beside bf16 q: the kernels add it
    in fp32, as the JAX kernel does, and land on the plain version (which
    adds bias.float()) within the bf16 tier. Rounding it to bf16 first, as
    the kernels did before they read the bias in its own dtype, moves a
    logit by up to 0.125 there; the plain version with the rounded bias
    misses the tier, so the test tells the two apart."""
    B, S, H, D = 2, 256, 4, 64
    gen = torch.Generator(device=card).manual_seed(21)
    q, k, v, do = (_randn(gen, card, torch.bfloat16, B, S, H, D)
                   for _ in range(4))
    slopes = torch.tensor([0.0313, 0.0219, 0.0437, 0.0251], device=card)
    pos = torch.arange(S, device=card, dtype=torch.float32)
    dist = (pos[None, :] - pos[:, None]).abs()
    # -56 - slope |i - j|, floored at -64: every value in [-64, -32), where
    # bf16 steps by 0.25
    bias = (-56.0 - slopes[:, None, None] * dist).clamp_min(-64.0)[None]
    bias = bias + torch.rand(1, H, S, S, generator=gen, device=card) * 1e-3
    assert bias.dtype == torch.float32 and bias.min() >= -64.0
    out, lse, _, _ = _check(q, k, v, do, False, dict(bias=bias),
                            FLASH_TOL[torch.bfloat16])
    out_p = FA.flash_fwd_plain(q, k, v, False, D ** -0.5, bias)[0]
    rounded = FA.flash_fwd_plain(q, k, v, False, D ** -0.5,
                                 bias.to(torch.bfloat16))[0]
    assert _tile_rel(rounded, out_p) > FLASH_TOL[torch.bfloat16]
    assert _tile_rel(out, out_p) <= FLASH_TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# head dims and dtypes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [32, 40, 80, 96, 160, 256])
def test_head_dims_and_dtypes_match_plain(card, D, dtype, causal):
    B, S, H = 2, 130, 4
    gen = torch.Generator(device=card).manual_seed(D)
    q, k, v, do = (_randn(gen, card, dtype, B, S, H, D) for _ in range(4))
    _check(q, k, v, do, causal, {}, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [80, 256])
def test_head_dims_gqa_rectangular(card, D, dtype):
    """GQA 4:1 with Sq != Sk, causal (dead rows where Sq > Sk), and a bias
    and dropout."""
    B, H = 2, 8
    gen = torch.Generator(device=card).manual_seed(D + 1)
    for sq, sk in ((100, 190), (190, 100)):
        q, do = (_randn(gen, card, dtype, B, sq, H, D) for _ in range(2))
        k, v = (_randn(gen, card, dtype, B, sk, 2, D) for _ in range(2))
        _check(q, k, v, do, True, {}, FLASH_TOL[dtype])
        bias = torch.randn(B, 1, sq, sk, generator=gen, device=card)
        _check(q, k, v, do, False, dict(bias=bias, dropout_p=0.1, seed=4),
               FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 33),
                                     (torch.float16, 1),
                                     (torch.float32, 5),
                                     (torch.float32, 250)])
def test_rows_off_the_16_byte_word_are_padded_once(card, dtype, D):
    """A head whose row is not a whole number of 16-byte words is copied
    into a zero-padded buffer and the outputs cut back to D."""
    B, S, H = 1, 70, 2
    gen = torch.Generator(device=card).manual_seed(D)
    q, k, v, do = (_randn(gen, card, dtype, B, S, H, D) for _ in range(4))
    out, _, grads, _ = _check(q, k, v, do, True, {}, FLASH_TOL[dtype])
    assert out.shape[-1] == D and all(g.shape[-1] == D for g in grads)
    assert out.is_contiguous()


def test_sdpa_routes_by_head_dim(card):
    """D <= 256 in fp16 goes through the kernels (counted in their
    launches); D 320 goes to the composed path by shape, counted in
    scaled_dot_product_attention.COMPOSED, forward and backward."""
    gen = torch.Generator(device=card).manual_seed(0)
    q = _randn(gen, card, torch.float16, 2, 64, 4, 256).requires_grad_(True)
    n = FA.flash_fwd.LAUNCHES, FA.flash_bwd_dq.LAUNCHES
    scaled_dot_product_attention(q, q, q, is_causal=True).float().sum() \
        .backward()
    assert (FA.flash_fwd.LAUNCHES - n[0], FA.flash_bwd_dq.LAUNCHES - n[1]) \
        == (1, 1)
    q320 = _randn(gen, card, torch.bfloat16, 2, 64, 4, 320)
    q320.requires_grad_(True)
    before = scaled_dot_product_attention.COMPOSED
    out = scaled_dot_product_attention(q320, q320, q320, is_causal=True)
    out.float().sum().backward()
    assert scaled_dot_product_attention.COMPOSED == before + 1
    assert FA.flash_fwd.LAUNCHES - n[0] == 1
    ref = TNF._sdpa_reference(q320.detach(), q320.detach(), q320.detach(),
                              is_causal=True)
    assert torch.equal(out, ref)
    assert torch.isfinite(q320.grad.float()).all()


def test_flash_attn_unpadded_routes(card):
    """Non-causal, and causal with one packing: the segment kernels; causal
    with two packings: the composed bool mask as the kernels' bias. Each
    against the composed attention on the same mask."""
    H, D = 4, 64
    gen = torch.Generator(device=card).manual_seed(9)
    cu = torch.tensor([0, 50, 130, 200], dtype=torch.int32)
    cu_k = torch.tensor([0, 70, 100, 200], dtype=torch.int32)
    q, k, v = (_randn(gen, card, torch.bfloat16, 200, H, D)
               for _ in range(3))
    for causal, cq, ck in ((False, cu, cu_k), (True, cu, cu),
                           (True, cu, cu_k)):
        n = FA.flash_fwd.LAUNCHES
        out, sm = flash_attn_unpadded(q, k, v, cq, ck, 130, 130,
                                      causal=causal)
        assert sm is None and FA.flash_fwd.LAUNCHES == n + 1
        seg_q = TNF._segments_from_cu(cq, 200).to(card)
        seg_k = TNF._segments_from_cu(ck, 200).to(card)
        mask = seg_q[:, None] == seg_k[None, :]
        if causal:
            pq = torch.arange(200, device=card) - cq.to(card)[seg_q.long() - 1]
            pk = torch.arange(200, device=card) - ck.to(card)[seg_k.long() - 1]
            mask = mask & (pk[None, :] <= pq[:, None])
        ref = TNF._sdpa_reference(q[None], k[None], v[None],
                                  attn_mask=mask[None, None])[0]
        assert _tile_rel(out[None], ref[None]) <= FLASH_TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# a tiny padded BERT step
# ---------------------------------------------------------------------------
def _tiny_padded_bert(dropout):
    cfg = TB.BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=256,
                        max_position_embeddings=128, hidden_dropout=dropout)
    rng = np.random.RandomState(0)
    lens = np.array([128, 90, 37, 64])
    ids = np.zeros((4, 128), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(1, 512, n)
    valid = np.arange(128)[None, :] < lens[:, None]
    mask = valid[:, None, None, :] & valid[:, None, :, None]
    mlm = np.where((rng.rand(4, 128) < 0.2) & valid,
                   rng.randint(0, 512, (4, 128)), -100)
    nsp = rng.randint(0, 2, (4,))
    return cfg, (ids, mask, mlm, nsp)


def _padded_step(model, batch, dev):
    params = functional_train_graph(model, device=dev)[0]
    for t in params.values():
        t.requires_grad_(True)
    ids, mask, mlm, nsp = (torch.from_numpy(a).to(dev) for a in batch)
    (lm, ns), _ = functional_call(model, params, {}, ids,
                                  attention_mask=mask)
    loss = TB.bert_pretrain_loss(lm, ns, mlm, nsp)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, dict(zip(params, grads))


def test_tiny_padded_bert_launches_and_matches_cpu(card):
    """The 4-D bool mask through BertModel: one flash forward, dQ and dK/dV
    launch per layer, with dropout on; with dropout off the fp32 loss and
    every gradient agree with the CPU run."""
    cfg, batch = _tiny_padded_bert(0.1)
    model = TB.BertForPretraining(cfg)
    n = (FA.flash_fwd.LAUNCHES, FA.flash_bwd_dq.LAUNCHES,
         FA.flash_bwd_dkv.LAUNCHES)
    loss, grads = _padded_step(model, batch, card)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert (FA.flash_fwd.LAUNCHES - n[0], FA.flash_bwd_dq.LAUNCHES - n[1],
            FA.flash_bwd_dkv.LAUNCHES - n[2]) == (L, L, L)
    assert torch.isfinite(loss) and all(
        torch.isfinite(g).all() for g in grads.values())

    cfg, batch = _tiny_padded_bert(0.0)
    model = TB.BertForPretraining(cfg)
    l_card, g_card = _padded_step(model, batch, card)
    l_cpu, g_cpu = _padded_step(model, batch, "cpu")
    assert abs(l_card.item() - l_cpu.item()) <= 1e-5 * abs(l_cpu.item())
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    for name, g in g_cpu.items():
        err = (g_card[name].cpu() - g).abs().max().item()
        assert err <= 1e-4 * max(g.abs().max().item(), 1e-3 * gmax), name
