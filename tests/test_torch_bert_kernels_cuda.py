"""The BERT slice's CUDA kernels on the card: the LayerNorm forward and
backward, and the segment-id and dropout variants of the flash forward, dQ
and dK/dV kernels, each against its plain PyTorch version on the same
inputs; the CUDA Philox mask bit for bit against the plain one; and a tiny
fp32 BERT step on the card against the same step on the CPU.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest tests/test_torch_bert_kernels_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.kernels import layer_norm as LN
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.nn import functional_call, functional_train_graph
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

pytestmark = pytest.mark.cuda

# flash (out, grads) on the worst tile's ||got - ref|| / ||ref||, as
# chip_smoke.py phase 6: fp32 summation order; bf16 rounding of the outputs
# and of the tensor-core operands
FLASH_TOL = {torch.float32: (5e-6, 5e-6), torch.bfloat16: (2e-2, 2e-2)}
# LayerNorm max-abs err / max-abs ref: fp32 sums in another order; bf16 one
# rounding of the output (an fp32 difference can flip it by one ulp)
LN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / max(b.float().abs().max().item(), 1.0)).item()


def _tile_rel(got, ref, rows=64):
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


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,H", [(5120, 768), (37, 768), (1, 768),
                                    (13, 100), (7, 36)])
@pytest.mark.parametrize("eps,bias", [(1e-12, True), (1e-5, False)])
def test_layer_norm_kernels_match_plain(card, dtype, rows, H, eps, bias):
    rng = np.random.RandomState(rows + H)
    x = torch.from_numpy(rng.randn(rows, H).astype(np.float32) * 3 + 1).to(
        card, dtype)
    w = torch.from_numpy(rng.randn(H).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.randn(H).astype(np.float32)).to(card) \
        if bias else None
    dy = torch.from_numpy(rng.randn(rows, H).astype(np.float32)).to(
        card, dtype)
    n = (LN.layer_norm_fwd.LAUNCHES, LN.layer_norm_bwd.LAUNCHES)
    y, mean, rstd = LN.layer_norm_fwd(x, w, b, eps)
    dx, dw, db = LN.layer_norm_bwd(x, w, mean, rstd, dy, need_db=bias)
    torch.cuda.synchronize()
    assert (LN.layer_norm_fwd.LAUNCHES, LN.layer_norm_bwd.LAUNCHES) == \
        (n[0] + 1, n[1] + 1)
    y_p, mean_p, rstd_p = LN.layer_norm_fwd_plain(x, w, b, eps)
    dx_p, _, _ = LN.layer_norm_bwd_plain(x, w, mean_p, rstd_p, dy)
    # dw / db: fp32 sums of the same products (the kernel's statistics on
    # both sides), only their order differs
    _, dw_p, db_p = LN.layer_norm_bwd_plain(x, w, mean, rstd, dy, bias,
                                            need_dx=False)
    assert y.dtype == dtype and dx.dtype == dtype
    assert _rel(y, y_p) <= LN_TOL[dtype]
    assert _rel(mean, mean_p) <= 1e-5
    assert ((rstd - rstd_p).abs() / rstd_p).max().item() <= 1e-5
    assert _rel(dx, dx_p) <= LN_TOL[dtype]
    assert _rel(dw, dw_p) <= 1e-5
    assert (db is None) if not bias else _rel(db, db_p) <= 1e-5


def test_layer_norm_unaligned_rows_and_autograd(card):
    """A row base that is not 16-byte aligned takes the one-element path;
    the autograd Function's dw and db match the plain sums."""
    H = 768
    big = torch.randn(65 * H + 3, device=card)
    x = big[3:].view(65, H)                         # 12-byte offset
    assert x.data_ptr() % 16
    w = torch.randn(H, device=card, requires_grad=True)
    b = torch.randn(H, device=card, requires_grad=True)
    y, mean, rstd = LN.layer_norm_fwd(x, w.detach(), b.detach(), 1e-5)
    y_p, mean_p, rstd_p = LN.layer_norm_fwd_plain(x, w.detach(), b.detach(),
                                                  1e-5)
    assert _rel(y, y_p) <= 1e-5
    xr = x.clone().requires_grad_(True)
    dy = torch.randn(65, H, device=card)
    gx, gw, gb = torch.autograd.grad(LN.layer_norm(xr, w, b, 1e-5),
                                     (xr, w, b), dy)
    dx_p, dw_p, db_p = LN.layer_norm_bwd_plain(x, w.detach(), mean_p, rstd_p,
                                               dy)
    assert _rel(gx, dx_p) <= 1e-5
    assert _rel(gw, dw_p) <= 1e-5 and _rel(gb, db_p) <= 1e-5


# ---------------------------------------------------------------------------
# flash attention: segments and dropout
# ---------------------------------------------------------------------------
def _packed_ids(lengths, s):
    seg = np.full((s,), -1, np.int32)
    off = 0
    for i, n in enumerate(lengths):
        seg[off:off + n] = i
        off += n
    return seg


FLASH_CASES = {  # name: (B, S, H, Hkv, D, causal, segment lengths per row)
    "packed": (2, 192, 4, 4, 64, False, ([70, 50, 30], [192])),
    "packed-d128": (2, 160, 2, 2, 128, False, ([100, 40], [20, 20, 20])),
    "causal-segments": (2, 192, 4, 4, 64, True, ([90, 90], [64, 64, 64])),
    "gqa-4-2": (2, 128, 4, 2, 64, False, ([128], [60, 60])),
    "no-segments": (2, 130, 4, 4, 64, False, None),
}


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_variants_match_plain(card, case, dtype, p):
    B, S, H, Hkv, D, causal, lens = FLASH_CASES[case]
    rng = np.random.RandomState(S + H)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            card, dtype)
    q, k, v, do = t(B, S, H, D), t(B, S, Hkv, D), t(B, S, Hkv, D), \
        t(B, S, H, D)
    seg = (None if lens is None else torch.from_numpy(
        np.stack([_packed_ids(r, S) for r in lens])).to(card))
    var = dict(q_seg=seg, kv_seg=seg, dropout_p=p, seed=987654321987)
    scale = D ** -0.5
    out, lse = FA.flash_fwd(q, k, v, causal, scale, **var)
    dq, dk, dv = FA.flash_bwd(q, k, v, lse, do, causal, scale, **var)
    torch.cuda.synchronize()
    out_p, lse_p = FA.flash_fwd_plain(q, k, v, causal, scale, **var)
    dq_p, dk_p, dv_p = FA.flash_bwd_plain(q, k, v, lse, do, causal,
                                          scale, **var)
    tol_o, tol_g = FLASH_TOL[dtype]
    live = lse_p > -1e29
    assert torch.equal(live, lse > -1e29)
    assert _rel(lse[live], lse_p[live]) <= 1e-5
    assert _tile_rel(out, out_p) <= tol_o
    for got, ref in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        assert torch.isfinite(got.float()).all()
        assert _tile_rel(got, ref) <= tol_g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dead_rows_with_segments(card, dtype):
    """Query ids that match no key: zeros, lse -1e30, no gradient."""
    S = 192
    qseg = torch.tensor(np.r_[np.zeros(100), np.full(92, 7)][None],
                        dtype=torch.int32, device=card)
    kseg = torch.zeros(1, S, dtype=torch.int32, device=card)
    q, k, v, do = (torch.randn(1, S, 2, 64, device=card).to(dtype)
                   for _ in range(4))
    out, lse = FA.flash_fwd(q, k, v, False, 0.125, q_seg=qseg, kv_seg=kseg)
    dq, dk, dv = FA.flash_bwd(q, k, v, lse, do, False, 0.125,
                              q_seg=qseg, kv_seg=kseg)
    assert (out[:, 100:] == 0).all() and (dq[:, 100:] == 0).all()
    assert (lse[:, :, 100:] == -1e30).all()
    _, dk_p, dv_p = FA.flash_bwd_plain(q, k, v, lse, do, False, 0.125,
                                       q_seg=qseg, kv_seg=kseg)
    assert _tile_rel(dk, dk_p) <= FLASH_TOL[dtype][1]
    assert _tile_rel(dv, dv_p) <= FLASH_TOL[dtype][1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_philox_mask_is_the_plain_mask_bit_for_bit(card, dtype):
    """With q = k = 0 every probability is 1 / Sk and v = I reads the
    dropped row out of the forward; with dO = I the dK/dV kernel's dV reads
    the dropped probabilities transposed. Both equal the plain
    dropout_keep_mask exactly."""
    B, S, H, D, p, seed = 2, 64, 3, 64, 0.3, 2 ** 40 + 12345
    z = torch.zeros(B, S, H, D, device=card, dtype=dtype)
    eye = torch.eye(S, device=card, dtype=dtype)[None, :, None, :].expand(
        B, S, H, S).contiguous()
    out, lse = FA.flash_fwd(z, z, eye, False, 1.0, dropout_p=p, seed=seed)
    keep = FA.dropout_keep_mask(seed, B, H, S, S, p, card)
    assert torch.equal(out.permute(0, 2, 1, 3) > 0, keep)
    _, dv = FA.flash_bwd_dkv(z, z, eye, lse, torch.zeros_like(lse), eye,
                             False, 1.0, dropout_p=p, seed=seed)
    assert torch.equal(dv.permute(0, 2, 3, 1) > 0, keep)
    assert 0.6 < keep.float().mean().item() < 0.8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_flash_backward_when_keys_converge(card, dtype, drop):
    """Keys and values that nearly coincide (the deep layers of a
    random-init BERT): the dQ kernel's delta = rowsum(p * dP) keeps dq, dk
    and dv within 1e-2 of fp64 autograd through the composed attention on
    the same inputs, dropout taken from the kernels' own mask."""
    rng = np.random.RandomState(0)
    B, S, H, D = 2, 256, 4, 64
    base_k, base_v = rng.randn(1, 1, H, D), rng.randn(1, 1, H, D)
    t = lambda a: torch.from_numpy(a).to(card, dtype)  # noqa: E731
    q, do = t(rng.randn(B, S, H, D)), t(rng.randn(B, S, H, D))
    k = t(base_k + 0.03 * rng.randn(B, S, H, D))
    v = t(base_v + 0.03 * rng.randn(B, S, H, D))
    scale = D ** -0.5
    lse = FA.flash_fwd(q, k, v, False, scale, dropout_p=drop, seed=7)[1]
    got = FA.flash_bwd(q, k, v, lse, do, False, scale, dropout_p=drop,
                       seed=7)
    qd, kd, vd = (x.double().requires_grad_(True) for x in (q, k, v))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale, -1)
    if drop:
        keep = FA.dropout_keep_mask(7, B, H, S, S, drop, card)
        p = torch.where(keep, p / (1 - drop), 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vd)
    ref = torch.autograd.grad(o, (qd, kd, vd), do.double())
    for name, g, r in zip("qkv", got, ref):
        err = ((g.double() - r).norm() / r.norm()).item()
        assert err <= 1e-2, (name, err)


def test_sdpa_card_path_counts_its_launches(card):
    """The registry op sends segment ids and training dropout to the
    kernels; the seed comes from the caller's CPU generator."""
    q = torch.randn(2, 128, 4, 64, device=card, dtype=torch.bfloat16,
                    requires_grad=True)
    seg = torch.tensor(np.stack([_packed_ids([64, 64], 128)] * 2),
                       device=card)
    n = (FA.flash_fwd.LAUNCHES, FA.flash_bwd_dq.LAUNCHES,
         FA.flash_bwd_dkv.LAUNCHES)
    gen = torch.Generator().manual_seed(5)
    out = scaled_dot_product_attention(q, q, q, dropout_p=0.1,
                                       segment_ids=seg, generator=gen)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert (FA.flash_fwd.LAUNCHES, FA.flash_bwd_dq.LAUNCHES,
            FA.flash_bwd_dkv.LAUNCHES) == tuple(x + 1 for x in n)
    gen2 = torch.Generator().manual_seed(5)
    again = scaled_dot_product_attention(q, q, q, dropout_p=0.1,
                                         segment_ids=seg, generator=gen2)
    assert torch.equal(out, again)
    # a mask with segments and dropout runs the kernels too, the mask as
    # their bias: one more forward and backward beside the forward of
    # `again`
    out = scaled_dot_product_attention(
        q, q, q, attn_mask=torch.ones(1, 1, 128, 128, dtype=torch.bool,
                                      device=card), dropout_p=0.1,
        segment_ids=seg, generator=torch.Generator().manual_seed(5))
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert (FA.flash_fwd.LAUNCHES - n[0], FA.flash_bwd_dq.LAUNCHES - n[1],
            FA.flash_bwd_dkv.LAUNCHES - n[2]) == (3, 2, 2)
    assert torch.equal(out, again)      # an all-true mask changes nothing


# ---------------------------------------------------------------------------
# a tiny BERT step, card vs CPU
# ---------------------------------------------------------------------------
def test_tiny_bert_step_card_matches_cpu(card):
    cfg = TB.BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=256,
                        max_position_embeddings=128, hidden_dropout=0.0)
    model = TB.BertForPretraining(cfg)
    rng = np.random.RandomState(0)
    seqs = [rng.randint(1, 512, (n,)) for n in (90, 30, 128, 60, 20)]
    ids, seg, pos, _, _ = TB.pack_sequences(seqs, 128)
    mlm = np.where((rng.rand(*ids.shape) < 0.2) & (seg >= 0),
                   rng.randint(0, 512, ids.shape), -100)
    nsp = rng.randint(0, 2, (ids.shape[0],))

    def run(dev):
        params = functional_train_graph(model, device=dev)[0]
        for t in params.values():
            t.requires_grad_(True)
        tt = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        (lm, ns), _ = functional_call(model, params, {}, tt(ids),
                                      pack_segment_ids=tt(seg),
                                      position_ids=tt(pos))
        loss = TB.bert_pretrain_loss(lm, ns, tt(mlm), tt(nsp))
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.item(), dict(zip(params, grads))

    n = (LN.layer_norm_fwd.LAUNCHES, FA.flash_fwd.LAUNCHES)
    l_card, g_card = run(card)
    assert LN.layer_norm_fwd.LAUNCHES - n[0] == 2 * cfg.num_layers + 2
    assert FA.flash_fwd.LAUNCHES - n[1] == cfg.num_layers
    l_cpu, g_cpu = run("cpu")
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    for name, g in g_cpu.items():
        err = (g_card[name].cpu() - g).abs().max().item()
        assert err <= 1e-4 * max(g.abs().max().item(), 1e-3 * gmax), name


def test_eager_call_runs_on_the_card(card):
    """A layer built with no device guard holds its parameters on the card,
    and an eager call runs there, through the LayerNorm and flash kernels."""
    cfg = TB.BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=256,
                        max_position_embeddings=128, hidden_dropout=0.0)
    model = TB.BertForPretraining(cfg).eval()
    assert {p.device.type for p in model.parameters()} == {"cuda"}
    rng = np.random.RandomState(1)
    ids, seg, pos, _, _ = TB.pack_sequences(
        [rng.randint(1, 512, (n,)) for n in (70, 40, 100)], 128)
    tt = lambda a: torch.from_numpy(a).to(card)  # noqa: E731
    n = (LN.layer_norm_fwd.LAUNCHES, FA.flash_fwd.LAUNCHES)
    with torch.no_grad():
        lm, ns = model(tt(ids), pack_segment_ids=tt(seg),
                       position_ids=tt(pos))
    assert lm.device.type == "cuda" and bool(torch.isfinite(lm).all())
    assert LN.layer_norm_fwd.LAUNCHES - n[0] == 2 * cfg.num_layers + 2
    assert FA.flash_fwd.LAUNCHES - n[1] == cfg.num_layers
