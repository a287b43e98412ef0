"""The redesigned 16-bit flash forward, dQ and dK/dV kernels on the card
(``csrc/flash_fwd_hopper.cu``, ``csrc/flash_dq_hopper.cu``: wgmma with the
scores and accumulators in registers, K and V through a TMA ring;
``csrc/flash_dkv_hopper.cu``: transposed scores in registers, Q and dO
through a TMA ring, at every width; at D_pad 192 and 256 one warpgroup
holds dv and another dk over 64 keys) against their plain PyTorch versions
on the same inputs: out and lse, dq, delta and the d-bias, dk and dv. The
grid:
D 32, 40, 64, 96, 128, 192 and 256; bf16 and fp16; no variant, a bias,
segment ids, flashmask rows, dropout, and bias + rows + dropout; causal,
non-causal and a window across two 128-row tiles; GQA groups of 1 and 4;
Sq != Sk from {1, 63, 129, 1000}; dead rows. Also the forward's and dQ's
dropout bits against ``dropout_keep_mask``, over one key tile and over
several, the model's strided qkv views and a batch-broadcast key. dK/dV
alone at every width (D 32, 64, 96, 128, 160, 192, 256) x bf16 / fp16 x
each flag, GQA 8/2, key lengths across its 128- and 64-key blocks, and its
dropout bits over several query tiles read out of dv. Tolerance: the
bf16 / fp16 tier of ``chip_smoke.py``, 2e-2 on the worst 64-row tile's
relative l2.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_flash_hopper_cuda.py --noconftest -q
"""

import itertools
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as FA

pytestmark = pytest.mark.cuda

TOL = 2e-2
DIMS = (32, 40, 64, 96, 128, 192, 256)
DTYPES = (torch.bfloat16, torch.float16)
FLAGS = ("none", "bias", "segments", "rows", "dropout", "bias_rows_dropout")
MODES = ("causal", "noncausal", "window")
SHAPES = ((63, 129), (129, 1000), (1000, 63), (1, 129), (129, 1), (1000, 129))
FWD_KEYS = ("bias", "q_seg", "kv_seg", "dropout_p", "seed", "fm", "window")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tile_rel(got, ref, rows=64, terms=None):
    """Worst ||got - ref|| / ||ref|| over 64-row tiles of dim 1 and each
    head (dim 2) of a [B, S, H, D] tensor. ``terms``: the size a gradient's
    terms have before they cancel; a tile's denominator is then at least
    1e-2 of that tile's ||terms|| (a query that sees one key has dq = 0
    exactly, and both versions give rounding noise)."""
    r = ref.float()
    d = got.float() - r
    pad = -d.shape[1] % rows
    ts = [d, r] + ([] if terms is None else [terms.float()])
    ts = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in ts]
    B, S, H, D = ts[0].shape
    sq = [t.reshape(B, S // rows, rows, H, D).square().sum((2, 4)) for t in ts]
    dd, rr = sq[0], sq[1]
    if terms is not None:
        rr = torch.maximum(rr, 1e-4 * sq[2])
    ratio = torch.where(rr > 0, (dd / rr.clamp_min(1e-30)).sqrt(),
                        torch.where(dd > 0, float("inf"), 0.0))
    return ratio.max().item()


def _grad_terms(p, dp, delta, q, k, scale):
    """The sizes of dq's and dk's terms before ds = p (dP - delta) cancels:
    |p| (|dP| + |delta|) scale times |k| (summed over the keys) and |q|
    (over the queries, and over each kv head's query group)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    mag = p.abs() * (dp.abs() + delta.abs()[..., None]) * scale
    kf = k.float().abs().repeat_interleave(H // Hkv, dim=2)
    tq = torch.einsum("bhqk,bkhd->bqhd", mag, kf)
    tk = torch.einsum("bhqk,bqhd->bkhd", mag, q.float().abs())
    return tq, tk.reshape(B, Sk, Hkv, H // Hkv, D).sum(3)


def _variant(flag, mode, B, Sq, Sk, H, dtype, rng, dev):
    """(causal, variant kwargs) of one grid point; the bias kills query 0
    of batch 0 (a dead row), segment ids leave queries of an id no key has
    dead, and the rows take H_mask 1 or H."""
    causal = mode == "causal"
    var = {}
    if mode == "window":
        var["window"] = (130, 20)
    if "bias" in flag:
        bias = rng.randn(B, 1, Sq, Sk).astype(np.float32)
        bias[0, 0, 0] = -1e30
        var["bias"] = torch.from_numpy(bias).to(dtype).to(dev)
    if flag == "segments":
        q_seg = np.sort(rng.randint(0, 4, (B, Sq)), 1)
        kv_seg = np.sort(rng.randint(0, 3, (B, Sk)), 1)
        var["q_seg"] = torch.from_numpy(q_seg).to(dev)
        var["kv_seg"] = torch.from_numpy(kv_seg).to(dev)
    if "rows" in flag:
        hm = 1 if mode != "noncausal" else H
        start = rng.randint(0, max(Sq, 1), (B, hm, Sk))
        end = np.minimum(start + rng.randint(1, 200, start.shape), Sq)
        var["fm"] = (torch.from_numpy(start.astype(np.int32)).to(dev),
                     torch.from_numpy(end.astype(np.int32)).to(dev))
    if "dropout" in flag:
        var.update(dropout_p=0.1 if flag == "dropout" else 0.2, seed=4242)
    return causal, var


def _check(q, k, v, do, causal, var, what):
    """Forward, dQ and dK/dV (from the dQ kernel's delta) against their
    plain versions: dead rows, lse, out, dq, dk, dv, delta, the d-bias."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    fwd = {n: var[n] for n in FWD_KEYS if n in var}
    bias_grad = "bias" in var
    n = FA.flash_fwd.LAUNCHES, FA.flash_bwd_dq.LAUNCHES
    out, lse = FA.flash_fwd(q, k, v, causal, scale, **fwd)
    dq, delta, *dbias = FA.flash_bwd_dq(q, k, v, lse, do, causal, scale,
                                        bias_grad=bias_grad, **var)
    dk, dv = FA.flash_bwd_dkv(q, k, v, lse, delta, do, causal, scale, **var)
    torch.cuda.synchronize()
    assert (FA.flash_fwd.LAUNCHES, FA.flash_bwd_dq.LAUNCHES) == (n[0] + 1,
                                                                n[1] + 1)
    out_p, lse_p = FA.flash_fwd_plain(q, k, v, causal, scale, **fwd)
    args = (q, k, v, lse, do, causal, scale, None, var.get("q_seg"),
            var.get("kv_seg"), var.get("dropout_p", 0.0), var.get("seed", 0),
            var.get("bias"), var.get("fm"), var.get("window"))
    dq_p, dk_p, dv_p, delta_p, ds_p = FA._plain_bwd(*args)
    p, _, dp = FA._bwd_probs(*args[:7], *args[8:12], bias=args[12],
                             fm=args[13], window=args[14])
    live = lse_p > -1e29
    assert torch.equal(live, lse > -1e29), what
    dead_q = ~live.transpose(1, 2)
    assert (out[dead_q] == 0).all() and (dq[dead_q] == 0).all(), what
    assert (lse[~live] == -1e30).all(), what
    if live.any():
        err = (lse[live] - lse_p[live]).abs().max().item()
        assert err <= 1e-5 * max(lse_p[live].abs().max().item(), 1.0), \
            (what, err)
    terms_q, terms_k = _grad_terms(p, dp, delta_p, q, k, scale)
    for name, got, want, terms in (("out", out, out_p, None),
                                   ("dq", dq, dq_p, terms_q),
                                   ("dk", dk, dk_p, terms_k),
                                   ("dv", dv, dv_p, None)):
        assert torch.isfinite(got.float()).all(), (what, name)
        tile = _tile_rel(got, want, terms=terms)
        assert tile <= TOL, (what, name, tile)
    # delta: rowsum(p dP) in fp32, to the rounding of its terms' sizes (dP
    # itself a sum of dO v products)
    g = q.shape[2] // k.shape[2]
    dp_terms = torch.einsum("bqhd,bkhd->bhqk", do.float().abs(),
                            v.float().abs().repeat_interleave(g, dim=2))
    mag = (p * dp_terms).sum(-1) / (1.0 - var.get("dropout_p", 0.0))
    gap = (delta - delta_p).abs()
    assert bool((gap[live] <= 1e-4 * mag[live] + 1e-6).all()), \
        (what, "delta", gap[live].max().item())
    if bias_grad:
        db = dbias[0]
        assert db.shape == ds_p.shape
        assert bool((db[p == 0] == 0).all()), (what, "d-bias zeros")
        # dS's own terms as the floor, as for dq (_tile_rel)
        floor = 1e-2 * (p.abs() * (dp.abs() + delta_p.abs()[..., None])).norm()
        l2 = ((db - ds_p).norm() / torch.maximum(ds_p.norm(), floor)
              .clamp_min(1e-30)).item()
        assert l2 <= TOL, (what, "d-bias", l2)


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp16"))
@pytest.mark.parametrize("D", DIMS)
def test_fwd_dq_vs_plain(card, D, dtype, flag):
    rng = np.random.RandomState(D + 7 * FLAGS.index(flag))
    B, H = 2, 4
    for idx, (mode, hkv) in enumerate(itertools.product(MODES, (4, 1))):
        for Sq, Sk in (SHAPES[(2 * idx) % 6], SHAPES[(2 * idx + 1) % 6]):
            q, do = (torch.from_numpy(rng.randn(B, Sq, H, D).astype(
                np.float32)).to(dtype).to(card) for _ in range(2))
            k, v = (torch.from_numpy(rng.randn(B, Sk, hkv, D).astype(
                np.float32)).to(dtype).to(card) for _ in range(2))
            causal, var = _variant(flag, mode, B, Sq, Sk, H, dtype, rng, card)
            _check(q, k, v, do, causal, var,
                   f"D={D} {dtype} {flag} {mode} H_kv={hkv} Sq={Sq} Sk={Sk}")


@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp16"))
@pytest.mark.parametrize("D", (64, 128))
def test_forward_keep_bits_are_dropout_keep_mask(card, D, dtype):
    """q = 0 gives every visible key the same probability, and v = the
    identity puts key j's kept probability in output column j: the
    forward's nonzero columns are its keep bits, which must be
    ``dropout_keep_mask``'s (the dK/dV kernel regenerates them)."""
    B, Sq, H, Sk, p, seed = 2, 300, 3, D, 0.3, 77
    q = torch.zeros(B, Sq, H, D, dtype=dtype, device=card)
    k = torch.randn(B, Sk, H, D, device=card).to(dtype)
    v = torch.eye(Sk, D, device=card).to(dtype)[None, :, None, :].expand(
        B, Sk, H, D).contiguous()
    out, _ = FA.flash_fwd(q, k, v, False, 1.0, dropout_p=p, seed=seed)
    keep = FA.dropout_keep_mask(seed, B, H, Sq, Sk, p, card)
    assert torch.equal((out != 0).permute(0, 2, 1, 3)[..., :Sk], keep)


def _one_hot_keys(B, Sk, H, D, w, dtype, dev):
    """v with v[:, w + d, :, d] = 1 for d < min(D, Sk - w), else 0: output
    column d of a row is then key w + d's kept probability."""
    v = torch.zeros(B, Sk, H, D, dtype=dtype, device=dev)
    idx = torch.arange(min(D, Sk - w), device=dev)
    v[:, w + idx, :, idx] = 1
    return v


@pytest.mark.parametrize("bias", (False, True), ids=("nobias", "bias"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp16"))
@pytest.mark.parametrize("D", (64, 128, 256))
def test_forward_keep_bits_across_key_tiles(card, D, dtype, bias):
    """The same read-out over Sk = 320 keys, several of the forward's key
    tiles (128 keys, or 64 beside a bias or at D_pad 256) and a partial
    last one, D keys a call (v one-hot on keys [w, w + D)), so the Philox
    words of every tile past the first are checked bit for bit."""
    B, Sq, H, Sk, p, seed = 2, 200, 3, 320, 0.3, 91
    q = torch.zeros(B, Sq, H, D, dtype=dtype, device=card)
    k = torch.randn(B, Sk, H, D, device=card).to(dtype)
    var = dict(dropout_p=p, seed=seed)
    if bias:
        var["bias"] = torch.zeros(1, 1, Sq, Sk, dtype=dtype, device=card)
    keep = FA.dropout_keep_mask(seed, B, H, Sq, Sk, p, card)
    for w in range(0, Sk, D):
        n = min(D, Sk - w)
        v = _one_hot_keys(B, Sk, H, D, w, dtype, card)
        out, _ = FA.flash_fwd(q, k, v, False, 1.0, **var)
        assert torch.equal((out[..., :n] != 0).permute(0, 2, 1, 3),
                           keep[..., w:w + n]), (D, dtype, bias, w)


@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp16"))
@pytest.mark.parametrize("D", (64, 128, 256))
def test_dq_keep_bits_across_key_tiles(card, D, dtype):
    """dQ's keep bits over Sk = 320 keys (dQ's tiles: 64 keys, 32 at D_pad
    256), read out of its d-bias: q = k = 0 makes every p 1 / Sk and
    dO . v = 1 for every pair makes dP the keep bit over (1 - p), so the
    d-bias p (dP - delta) is positive exactly where a key was kept; delta
    is the row's kept count over Sk (1 - p). Without a bias, delta alone."""
    B, Sq, H, Sk, p, seed = 2, 200, 3, 320, 0.3, 93
    q = torch.zeros(B, Sq, H, D, dtype=dtype, device=card)
    k = torch.zeros(B, Sk, H, D, dtype=dtype, device=card)
    v = torch.zeros(B, Sk, H, D, dtype=dtype, device=card)
    do = torch.zeros(B, Sq, H, D, dtype=dtype, device=card)
    v[..., 0] = 1
    do[..., 0] = 1
    keep = FA.dropout_keep_mask(seed, B, H, Sq, Sk, p, card)
    want = keep.float().sum(-1) / (Sk * (1 - p))
    bias = torch.zeros(1, 1, Sq, Sk, dtype=dtype, device=card)
    for var in (dict(), dict(bias=bias)):
        var.update(dropout_p=p, seed=seed)
        _, lse = FA.flash_fwd(q, k, v, False, 1.0, **var)
        got = FA.flash_bwd_dq(q, k, v, lse, do, False, 1.0,
                              bias_grad="bias" in var, **var)
        torch.testing.assert_close(got[1], want, rtol=1e-5, atol=1e-6)
        if "bias" in var:
            assert torch.equal(got[2] > 0, keep), (D, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp16"))
def test_layouts_qkv_views_and_broadcast_key(card, dtype):
    """The model's head-major qkv read in place (the tensor maps take the
    views' strides: seq stride above head stride), and a key and value
    broadcast over the batch (copied by the wrapper)."""
    B, S, H, D = 2, 300, 4, 128
    qkv = torch.randn(B, S, H, 3, D, device=card).to(dtype)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    do = torch.randn(B, S, H, D, device=card).to(dtype)
    _check(q, k, v, do, True, {}, "qkv views")
    kb = torch.randn(1, S, 2, D, device=card).to(dtype).expand(B, S, 2, D)
    vb = torch.randn(1, S, 2, D, device=card).to(dtype).expand(B, S, 2, D)
    _check(q, kb, vb, do, False, {}, "broadcast key")


DKV_DIMS = (32, 64, 96, 128, 160, 192, 256)  # every D_pad, 192 twice
DKV_SHAPES = ((129, 257), (200, 127), (64, 255), (257, 128))


def test_dkv_plan_reports_the_wgmma_kernel(card):
    """kernel_plan: the wgmma dK/dV at every 16-bit width, key-major,
    streaming query tiles of 64: a block of 128 keys at D_pad <= 128, of 64
    keys at D_pad 192 and 256 (two warpgroups over the same keys, one
    holding dv and one dk); for fp32 the TF32 tensor-core kernel at every
    width."""
    for D in list(DIMS) + [1, 160, 200]:
        for dtype in DTYPES:
            plan = FA.kernel_plan("flash_bwd_dkv", D, dtype)
            want = ("wgmma+tma", 64, 128 if D <= 128 else 64)
            assert (plan["design"], plan["query_rows"], plan["keys"]) == want
            assert plan["key_major"]
        assert FA.kernel_plan("flash_bwd_dkv", D, torch.float32)["design"] \
            == "wgmma-3xtf32"


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp16"))
@pytest.mark.parametrize("D", DKV_DIMS)
def test_dkv_vs_plain(card, D, dtype, flag):
    """dK/dV (with the forward and dQ that feed it) at GQA 8/2 and 2/2, the
    key lengths on both sides of the kernel's 128- and 64-key blocks and
    the query lengths across its 64-row query tiles, causal, non-causal and
    a window."""
    rng = np.random.RandomState(3 * D + 11 * FLAGS.index(flag))
    B = 2
    for idx, (mode, (H, hkv)) in enumerate(itertools.product(
            MODES, ((8, 2), (2, 2)))):
        Sq, Sk = DKV_SHAPES[idx % len(DKV_SHAPES)]
        q, do = (torch.from_numpy(rng.randn(B, Sq, H, D).astype(
            np.float32)).to(dtype).to(card) for _ in range(2))
        k, v = (torch.from_numpy(rng.randn(B, Sk, hkv, D).astype(
            np.float32)).to(dtype).to(card) for _ in range(2))
        causal, var = _variant(flag, mode, B, Sq, Sk, H, dtype, rng, card)
        n = FA.flash_bwd_dkv.LAUNCHES
        _check(q, k, v, do, causal, var,
               f"dkv D={D} {dtype} {flag} {mode} H={H}/{hkv} Sq={Sq} Sk={Sk}")
        assert FA.flash_bwd_dkv.LAUNCHES == n + 1


@pytest.mark.parametrize("bias", (False, True), ids=("nobias", "bias"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp16"))
@pytest.mark.parametrize("D", (64, 128, 256))
def test_dkv_keep_bits_across_query_tiles(card, D, dtype, bias):
    """dK/dV's keep bits over Sq = 200 queries (four of its query tiles of
    64, the last partial) and Sk = 300 keys (three of its 128-key blocks,
    five of its 64-key blocks at D 256),
    read out of dv: q = k = 0 makes every p 1 / Sk, and dO one-hot on
    queries [w, w + D) (dO[w + d, :, d] = 1) makes dv[key, d] the kept,
    rescaled p of query w + d, nonzero exactly where the forward kept the
    pair (``dropout_keep_mask``), with and without a bias."""
    B, Sq, H, Sk, p, seed = 2, 200, 3, 300, 0.3, 95
    q = torch.zeros(B, Sq, H, D, dtype=dtype, device=card)
    k = torch.zeros(B, Sk, H, D, dtype=dtype, device=card)
    v = torch.randn(B, Sk, H, D, device=card).to(dtype)
    var = dict(dropout_p=p, seed=seed)
    if bias:
        var["bias"] = torch.zeros(1, 1, Sq, Sk, dtype=dtype, device=card)
    keep = FA.dropout_keep_mask(seed, B, H, Sq, Sk, p, card)
    _, lse = FA.flash_fwd(q, k, v, False, 1.0, **var)
    for w in range(0, Sq, D):
        n = min(D, Sq - w)
        do = torch.zeros(B, Sq, H, D, dtype=dtype, device=card)
        idx = torch.arange(n, device=card)
        do[:, w + idx, :, idx] = 1
        _, delta = FA.flash_bwd_dq(q, k, v, lse, do, False, 1.0, **var)
        _, dv = FA.flash_bwd_dkv(q, k, v, lse, delta, do, False, 1.0, **var)
        got = (dv[..., :n] != 0).permute(0, 2, 3, 1)      # [B, H, d, key]
        assert torch.equal(got, keep[:, :, w:w + n]), (D, dtype, bias, w)
