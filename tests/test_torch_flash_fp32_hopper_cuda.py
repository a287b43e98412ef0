"""The fp32 flash forward, dQ and dK/dV kernels on the TF32 tensor cores
(``csrc/flash_fwd_tf32_hopper.cu``: 128 query rows a block over key tiles
of 32 up to D_pad 128, 64 rows over key tiles of 16 at D_pad 192 and 256,
V transposed in shared memory; ``csrc/flash_dq_tf32_hopper.cu``: 64
query rows a block over key tiles of 32, of 16 at D_pad 256;
``csrc/flash_dkv_tf32_hopper.cu``: 64 keys a block over query tiles of 32,
of 16 at D_pad 192 and 256; each fp32 operand split into two TF32 halves,
three wgmma products for each) against their plain PyTorch versions on the
same inputs: out and lse, dq, delta and the d-bias, dk and dv (the
backward from the forward kernel's lse). The grid: D 32, 40, 64, 96, 128,
160, 200 and 256 (D_pad 32 to 256); every flag instance (bias x integer
masks x dropout); causal, non-causal and a window; GQA 8/2 and 2/2 (and
16/4 in the forward); lengths on both sides of the 16-, 32- and 64-row
tiles; dead rows. Also the keep bits of the three kernels across their
tiles (at D 160 / 256 the forward's, dQ's and dK/dV's from one mask), the
model's strided qkv views and a batch-broadcast key, a 16-bit bias beside
fp32 q, and ``kernel_plan``'s design for fp32.
Tolerance: ``chip_smoke.py``'s fp32 gate, 5e-6 on the worst 64-row tile's
relative l2, dq and dk with a floor of 1e-1 of the tile's terms before they
cancel (``test_torch_flash_hopper_cuda.py`` takes 1e-2 beside its 2e-2):
the kernels recompute s on the tensor cores, not with the forward's
arithmetic, so a query that sees one key gets p = 1 - O(2^-21) and dq = p
dP (1 - p) k is rounding noise of about 3e-7 of its terms where the true dq
is 0; 5e-6 of 1e-1 of the terms holds that noise to fp32 grade. Where the
plain fp32 version is itself farther than 5e-6 from a float64 witness (the
plain arithmetic in float64 on the same inputs, mask and keep bits: a key
alone in its tile, whose dk is a few cancelling ds), the backward is held
to the witness instead, at most 1.25 times the plain version's distance.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_flash_fp32_hopper_cuda.py --noconftest -q
"""

import itertools
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as FA

pytestmark = pytest.mark.cuda

TOL = 5e-6
# where the plain fp32 version is farther than TOL from the float64
# witness, the kernel's worst tile against the witness may be at most this
# times the plain version's (PERF.md's form for BERT's q / k gradients)
WITNESS_RATIO = 1.25
DIMS = (32, 40, 64, 96, 128)
WIDE = (160, 200, 256)  # D_pad 192 and 256: 16-row tiles
# bias x integer masks x dropout: every instance of the kernels
FLAGS = ("none", "bias", "segments", "rows", "dropout", "bias_segments",
         "bias_dropout", "rows_dropout", "bias_rows_dropout")
MODES = ("causal", "noncausal", "window")
SHAPES = ((63, 97), (97, 65), (33, 129), (129, 31), (1, 65), (65, 1))
FWD_KEYS = ("bias", "q_seg", "kv_seg", "dropout_p", "seed", "fm", "window")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tile_rel(got, ref, rows=64, terms=None):
    """Worst ||got - ref|| / ||ref|| over 64-row tiles of dim 1 and each
    head (dim 2) of a [B, S, H, D] tensor; with ``terms`` a tile's
    denominator is at least 1e-1 of that tile's ||terms||."""
    # float64 when held to the float64 witness, fp32 otherwise
    dt = torch.float64 if ref.dtype == torch.float64 else torch.float32
    r = ref.to(dt)
    d = got.to(dt) - r
    pad = -d.shape[1] % rows
    ts = [d, r] + ([] if terms is None else [terms.to(dt)])
    ts = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in ts]
    B, S, H, D = ts[0].shape
    sq = [t.reshape(B, S // rows, rows, H, D).square().sum((2, 4)) for t in ts]
    dd, rr = sq[0], sq[1]
    if terms is not None:
        rr = torch.maximum(rr, 1e-2 * sq[2])
    ratio = torch.where(rr > 0, (dd / rr.clamp_min(1e-30)).sqrt(),
                        torch.where(dd > 0, float("inf"), 0.0))
    return ratio.max().item()


def _grad_terms(p, dp, delta, q, k, scale):
    """The sizes of dq's and dk's terms before ds = p (dP - delta)
    cancels."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    mag = p.abs() * (dp.abs() + delta.abs()[..., None]) * scale
    kf = k.float().abs().repeat_interleave(H // Hkv, dim=2)
    tq = torch.einsum("bhqk,bkhd->bqhd", mag, kf)
    tk = torch.einsum("bhqk,bqhd->bkhd", mag, q.float().abs())
    return tq, tk.reshape(B, Sk, Hkv, H // Hkv, D).sum(3)


def _witness64(q, k, v, lse, do, causal, scale, delta, q_seg, kv_seg,
               dropout_p, seed, bias, fm, window):
    """dq, dk and dv of the plain version's arithmetic in float64 on the
    same inputs: the same visibility mask, keep bits and lse, with delta
    recomputed in float64."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    kf, vf = (t.repeat_interleave(g, dim=2) for t in (k64, v64))
    s = torch.einsum("bqhd,bkhd->bhqk", q64, kf) * scale
    if bias is not None:
        s = s + FA._additive(bias, q.dtype).double()
    ok = FA._visible(Sq, Sk, causal, q.device, q_seg, kv_seg, fm, window)
    live = (lse > 0.5 * FA._NEG_INF)[..., None]
    zero = torch.zeros((), dtype=torch.float64, device=q.device)
    p = torch.where(ok & live, torch.exp(s - lse.double()[..., None]), zero)
    dp = torch.einsum("bqhd,bkhd->bhqk", do64, vf)
    p_kept = p
    if dropout_p:
        keep = FA.dropout_keep_mask(seed, B, H, Sq, Sk, dropout_p, q.device)
        p_kept = torch.where(keep, p / (1.0 - dropout_p), zero)
        dp = torch.where(keep, dp / (1.0 - dropout_p), zero)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q64)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_kept, do64)
    return (dq, dk.reshape(B, Sk, Hkv, g, D).sum(3),
            dv.reshape(B, Sk, Hkv, g, D).sum(3))


def _variant(flag, mode, B, Sq, Sk, H, rng, dev):
    """(causal, variant kwargs) of one grid point; the bias kills query 0
    of batch 0 (a dead row), segment ids leave queries of an id no key has
    dead, and the rows take H_mask 1 or H."""
    causal = mode == "causal"
    var = {}
    if mode == "window":
        var["window"] = (70, 20)
    if "bias" in flag:
        bias = rng.randn(B, 1, Sq, Sk).astype(np.float32)
        bias[0, 0, 0] = -1e30
        var["bias"] = torch.from_numpy(bias).to(dev)
    if "segments" in flag:
        q_seg = np.sort(rng.randint(0, 4, (B, Sq)), 1)
        kv_seg = np.sort(rng.randint(0, 3, (B, Sk)), 1)
        var["q_seg"] = torch.from_numpy(q_seg).to(dev)
        var["kv_seg"] = torch.from_numpy(kv_seg).to(dev)
    if "rows" in flag:
        hm = 1 if mode != "noncausal" else H
        start = rng.randint(0, max(Sq, 1), (B, hm, Sk))
        end = np.minimum(start + rng.randint(1, 60, start.shape), Sq)
        var["fm"] = (torch.from_numpy(start.astype(np.int32)).to(dev),
                     torch.from_numpy(end.astype(np.int32)).to(dev))
    if "dropout" in flag:
        var.update(dropout_p=0.1 if flag == "dropout" else 0.2, seed=4242)
    return causal, var


def _check(q, k, v, do, causal, var, what):
    """dQ and dK/dV (from the dQ kernel's delta) against their plain
    versions, from the forward kernel's lse: dead rows, dq, dk, dv, delta,
    the d-bias; one launch of each."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    fwd = {n: var[n] for n in FWD_KEYS if n in var}
    bias_grad = "bias" in var
    n = FA.flash_bwd_dq.LAUNCHES, FA.flash_bwd_dkv.LAUNCHES
    _, lse = FA.flash_fwd(q, k, v, causal, scale, **fwd)
    dq, delta, *dbias = FA.flash_bwd_dq(q, k, v, lse, do, causal, scale,
                                        bias_grad=bias_grad, **var)
    dk, dv = FA.flash_bwd_dkv(q, k, v, lse, delta, do, causal, scale, **var)
    torch.cuda.synchronize()
    assert (FA.flash_bwd_dq.LAUNCHES, FA.flash_bwd_dkv.LAUNCHES) == (
        n[0] + 1, n[1] + 1), what
    args = (q, k, v, lse, do, causal, scale, None, var.get("q_seg"),
            var.get("kv_seg"), var.get("dropout_p", 0.0), var.get("seed", 0),
            var.get("bias"), var.get("fm"), var.get("window"))
    dq_p, dk_p, dv_p, delta_p, ds_p = FA._plain_bwd(*args)
    p, _, dp = FA._bwd_probs(*args[:7], *args[8:12], bias=args[12],
                             fm=args[13], window=args[14])
    live = lse > -1e29
    assert (dq[~live.transpose(1, 2)] == 0).all(), what
    terms_q, terms_k = _grad_terms(p, dp, delta_p, q, k, scale)
    wq, wk, wv = _witness64(*args)
    for name, got, want, exact, terms in (
            ("dq", dq, dq_p, wq, terms_q), ("dk", dk, dk_p, wk, terms_k),
            ("dv", dv, dv_p, wv, None)):
        assert torch.isfinite(got).all(), (what, name)
        plain_err = _tile_rel(want, exact, terms=terms)
        if plain_err <= TOL:
            tile = _tile_rel(got, want, terms=terms)
            assert tile <= TOL, (what, name, tile)
        else:
            # the plain fp32 version itself sits farther than TOL from the
            # exact gradient: hold the kernel to the float64 witness, at
            # most WITNESS_RATIO times the plain version's own distance
            tile = _tile_rel(got, exact, terms=terms)
            assert tile <= WITNESS_RATIO * plain_err, \
                (what, name, tile, plain_err)
    g = q.shape[2] // k.shape[2]
    dp_terms = torch.einsum("bqhd,bkhd->bhqk", do.abs(),
                            v.abs().repeat_interleave(g, dim=2))
    mag = (p * dp_terms).sum(-1) / (1.0 - var.get("dropout_p", 0.0))
    gap = (delta - delta_p).abs()
    assert bool((gap[live] <= 1e-5 * mag[live] + 1e-7).all()), \
        (what, "delta", gap[live].max().item())
    if bias_grad:
        db = dbias[0]
        assert db.shape == ds_p.shape
        assert bool((db[p == 0] == 0).all()), (what, "d-bias zeros")
        floor = 1e-1 * (p.abs() * (dp.abs() + delta_p.abs()[..., None])).norm()
        l2 = ((db - ds_p).norm() / torch.maximum(ds_p.norm(), floor)
              .clamp_min(1e-30)).item()
        assert l2 <= TOL, (what, "d-bias", l2)


def test_fp32_plan_reports_the_tf32_design(card):
    """kernel_plan for fp32: the forward, dQ and dK/dV on the TF32 tensor
    cores at every D_pad; up to 128 the forward 128 query rows over 32-key
    tiles, dQ 64 query rows over 32-key tiles, dK/dV 64 keys over 32-query
    tiles (key-major); at D_pad 192 and 256 the forward 64 query rows over
    16-key tiles, dQ 64 query rows over 32-key tiles (16 at 256), dK/dV 64
    keys over 16-query tiles."""
    for D in (1, 32, 40, 64, 96, 128):
        fwd = FA.kernel_plan("flash_fwd", D, torch.float32)
        fwd_b = FA.kernel_plan("flash_fwd", D, torch.float32, bias=True)
        dq = FA.kernel_plan("flash_bwd_dq", D, torch.float32)
        dkv = FA.kernel_plan("flash_bwd_dkv", D, torch.float32)
        for plan in (fwd, fwd_b):
            assert (plan["design"], plan["query_rows"], plan["keys"],
                    plan["key_major"]) == ("wgmma-3xtf32", 128, 32, False)
        assert (dq["design"], dq["query_rows"], dq["keys"],
                dq["key_major"]) == ("wgmma-3xtf32", 64, 32, False)
        assert (dkv["design"], dkv["query_rows"], dkv["keys"],
                dkv["key_major"]) == ("wgmma-3xtf32", 32, 64, True)
    for D in (136, 160, 192, 200, 256):
        for bias in (False, True):
            fwd = FA.kernel_plan("flash_fwd", D, torch.float32, bias=bias)
            assert (fwd["design"], fwd["query_rows"], fwd["keys"],
                    fwd["key_major"]) == ("wgmma-3xtf32", 64, 16, False)
        dq = FA.kernel_plan("flash_bwd_dq", D, torch.float32)
        dkv = FA.kernel_plan("flash_bwd_dkv", D, torch.float32)
        assert (dq["design"], dq["query_rows"], dq["keys"],
                dq["key_major"]) == ("wgmma-3xtf32", 64,
                                     32 if D <= 192 else 16, False)
        assert (dkv["design"], dkv["query_rows"], dkv["keys"],
                dkv["key_major"]) == ("wgmma-3xtf32", 16, 64, True)


def _check_fwd(q, k, v, causal, var, what):
    """The forward kernel against its plain version: dead rows, lse, and out
    on the worst 64-row tile; one launch."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    fwd = {n: var[n] for n in FWD_KEYS if n in var}
    n = FA.flash_fwd.LAUNCHES
    out, lse = FA.flash_fwd(q, k, v, causal, scale, **fwd)
    torch.cuda.synchronize()
    assert FA.flash_fwd.LAUNCHES == n + 1, what
    out_p, lse_p = FA.flash_fwd_plain(q, k, v, causal, scale, **fwd)
    live = lse_p > -1e29
    assert torch.equal(live, lse > -1e29), what
    assert bool((lse[~live] == -1e30).all()), what
    assert bool((out[~live.transpose(1, 2)] == 0).all()), what
    if live.any():
        gap = (lse[live] - lse_p[live]).abs().max().item()
        assert gap <= 1e-5 * max(lse_p[live].abs().max().item(), 1.0), \
            (what, "lse", gap)
    assert torch.isfinite(out).all(), what
    tile = _tile_rel(out, out_p)
    assert tile <= TOL, (what, "out", tile)


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("D", DIMS + WIDE)
def test_fp32_fwd_vs_plain(card, D, flag):
    """The forward at GQA 8/2 and 2/2 and 16/4, lengths across its key and
    row tiles (32 keys and 128 rows, 16 and 64 at D 160-256; and S 1000),
    causal, non-causal and a window."""
    rng = np.random.RandomState(7 * D + 11 * FLAGS.index(flag))
    B = 2
    shapes = SHAPES + ((1000, 1000), (129, 257))
    for idx, (mode, (H, hkv)) in enumerate(itertools.product(
            MODES, ((8, 2), (2, 2), (16, 4)))):
        Sq, Sk = shapes[idx % len(shapes)]
        q = torch.from_numpy(rng.randn(B, Sq, H, D).astype(
            np.float32)).to(card)
        k, v = (torch.from_numpy(rng.randn(B, Sk, hkv, D).astype(
            np.float32)).to(card) for _ in range(2))
        causal, var = _variant(flag, mode, B, Sq, Sk, H, rng, card)
        _check_fwd(q, k, v, causal, var,
                   f"fp32 fwd D={D} {flag} {mode} H={H}/{hkv} Sq={Sq} "
                   f"Sk={Sk}")


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("D", DIMS + WIDE)
def test_fp32_bwd_vs_plain(card, D, flag):
    """dQ and dK/dV at GQA 8/2 and 2/2, lengths across both kernels' 16- or
    32-row and 64-row tiles, causal, non-causal and a window."""
    rng = np.random.RandomState(5 * D + 13 * FLAGS.index(flag))
    B = 2
    for idx, (mode, (H, hkv)) in enumerate(itertools.product(
            MODES, ((8, 2), (2, 2)))):
        Sq, Sk = SHAPES[idx % len(SHAPES)]
        q, do = (torch.from_numpy(rng.randn(B, Sq, H, D).astype(
            np.float32)).to(card) for _ in range(2))
        k, v = (torch.from_numpy(rng.randn(B, Sk, hkv, D).astype(
            np.float32)).to(card) for _ in range(2))
        causal, var = _variant(flag, mode, B, Sq, Sk, H, rng, card)
        _check(q, k, v, do, causal, var,
               f"fp32 D={D} {flag} {mode} H={H}/{hkv} Sq={Sq} Sk={Sk}")


@pytest.mark.parametrize("D", (64, 128, 160, 256))
def test_fp32_dq_keep_bits_across_key_tiles(card, D):
    """dQ's keep bits over Sk = 300 keys (ten of its 32-key tiles, nineteen
    of its 16-key tiles at D 256, the last partial), read out of its
    d-bias as the 16-bit test reads them: q = k =
    0 makes every p 1 / Sk and dO . v = 1 makes dP the keep bit over
    (1 - p), so the d-bias is positive exactly where a key was kept."""
    B, Sq, H, Sk, p, seed = 2, 200, 3, 300, 0.3, 93
    q, k, v, do = (torch.zeros(B, S, H, D, device=card)
                   for S in (Sq, Sk, Sk, Sq))
    v[..., 0] = 1
    do[..., 0] = 1
    keep = FA.dropout_keep_mask(seed, B, H, Sq, Sk, p, card)
    want = keep.float().sum(-1) / (Sk * (1 - p))
    bias = torch.zeros(1, 1, Sq, Sk, device=card)
    for var in (dict(), dict(bias=bias)):
        var.update(dropout_p=p, seed=seed)
        _, lse = FA.flash_fwd(q, k, v, False, 1.0, **var)
        got = FA.flash_bwd_dq(q, k, v, lse, do, False, 1.0,
                              bias_grad="bias" in var, **var)
        torch.testing.assert_close(got[1], want, rtol=1e-5, atol=1e-6)
        if "bias" in var:
            assert torch.equal(got[2] > 0, keep), D


@pytest.mark.parametrize("bias", (False, True), ids=("nobias", "bias"))
@pytest.mark.parametrize("D", (64, 128, 160, 256))
def test_fp32_dkv_keep_bits_across_query_tiles(card, D, bias):
    """dK/dV's keep bits over Sq = 200 queries (seven of its 32-query
    tiles, thirteen of its 16-query tiles at D 160 / 256, the last partial)
    and Sk = 300 keys (five of its 64-key blocks),
    read out of dv: q = k = 0 makes every p 1 / Sk, and dO one-hot on
    queries [w, w + D) makes dv[key, d] the kept, rescaled p of query w + d,
    nonzero exactly where the forward kept the pair."""
    B, Sq, H, Sk, p, seed = 2, 200, 3, 300, 0.3, 95
    q = torch.zeros(B, Sq, H, D, device=card)
    k = torch.zeros(B, Sk, H, D, device=card)
    v = torch.randn(B, Sk, H, D, device=card)
    var = dict(dropout_p=p, seed=seed)
    if bias:
        var["bias"] = torch.zeros(1, 1, Sq, Sk, device=card)
    keep = FA.dropout_keep_mask(seed, B, H, Sq, Sk, p, card)
    _, lse = FA.flash_fwd(q, k, v, False, 1.0, **var)
    for w in range(0, Sq, D):
        n = min(D, Sq - w)
        do = torch.zeros(B, Sq, H, D, device=card)
        idx = torch.arange(n, device=card)
        do[:, w + idx, :, idx] = 1
        _, delta = FA.flash_bwd_dq(q, k, v, lse, do, False, 1.0, **var)
        _, dv = FA.flash_bwd_dkv(q, k, v, lse, delta, do, False, 1.0, **var)
        got = (dv[..., :n] != 0).permute(0, 2, 3, 1)      # [B, H, d, key]
        assert torch.equal(got, keep[:, :, w:w + n]), (D, bias, w)


def test_fp32_layouts_qkv_views_and_broadcast_key(card):
    """The model's head-major qkv read in place (the fp32 tensor maps take
    the views' strides), and a key and value broadcast over the batch."""
    B, S, H, D = 2, 300, 4, 128
    qkv = torch.randn(B, S, H, 3, D, device=card)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    do = torch.randn(B, S, H, D, device=card)
    _check(q, k, v, do, True, {}, "fp32 qkv views")
    _check_fwd(q, k, v, True, {}, "fp32 fwd qkv views")
    kb = torch.randn(1, S, 2, D, device=card).expand(B, S, 2, D)
    vb = torch.randn(1, S, 2, D, device=card).expand(B, S, 2, D)
    _check(q, kb, vb, do, False, {}, "fp32 broadcast key")
    _check_fwd(q, kb, vb, False, {}, "fp32 fwd broadcast key")


@pytest.mark.parametrize("D", (160, 256))
def test_fp32_wide_dropout_one_mask_in_both_designs(card, D):
    """At D_pad 192 / 256 the forward, dQ and dK/dV all run on the TF32
    tensor cores, one design in both directions, and all
    draw dropout_keep_mask's bits. The forward's are read out of out (q = k = 0
    makes every p 1 / Sk, and v one-hot on keys [w, w + D) makes out[i, d]
    the kept, rescaled p of key w + d), dQ's out of its d-bias (dO . v = 1
    makes dP the keep bit over (1 - p)); then both against the plain
    versions with dropout on, gradients included."""
    B, Sq, H, Sk, p, seed = 2, 200, 3, 300, 0.3, 97
    q = torch.zeros(B, Sq, H, D, device=card)
    k = torch.zeros(B, Sk, H, D, device=card)
    keep = FA.dropout_keep_mask(seed, B, H, Sq, Sk, p, card)
    var = dict(dropout_p=p, seed=seed)
    for w in range(0, Sk, D):
        n = min(D, Sk - w)
        v = torch.zeros(B, Sk, H, D, device=card)
        idx = torch.arange(n, device=card)
        v[:, w + idx, :, idx] = 1
        out, _ = FA.flash_fwd(q, k, v, False, 1.0, **var)
        got = (out[..., :n] != 0).permute(0, 2, 1, 3)     # [B, H, q, key]
        assert torch.equal(got, keep[..., w:w + n]), (D, "fwd", w)
    v = torch.zeros(B, Sk, H, D, device=card)
    do = torch.zeros(B, Sq, H, D, device=card)
    v[..., 0] = 1
    do[..., 0] = 1
    bias = torch.zeros(1, 1, Sq, Sk, device=card)
    _, lse = FA.flash_fwd(q, k, v, False, 1.0, bias=bias, **var)
    _, _, db = FA.flash_bwd_dq(q, k, v, lse, do, False, 1.0, bias=bias,
                               bias_grad=True, **var)
    assert torch.equal(db > 0, keep), (D, "dq")
    rng = np.random.RandomState(D)
    q, do = (torch.from_numpy(rng.randn(B, 97, 4, D).astype(
        np.float32)).to(card) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(B, 129, 2, D).astype(
        np.float32)).to(card) for _ in range(2))
    for causal in (True, False):
        _check_fwd(q, k, v, causal, var, f"fp32 D={D} dropout fwd")
        _check(q, k, v, do, causal, var, f"fp32 D={D} dropout bwd")


@pytest.mark.parametrize("bias_dtype", (torch.bfloat16, torch.float16),
                         ids=("bf16", "fp16"))
@pytest.mark.parametrize("D", (64, 128, 160, 256))
def test_fp32_fwd_with_a_16bit_bias(card, D, bias_dtype):
    """A bias in its own 16-bit dtype beside fp32 q, read in pairs where it
    is contiguous over keys: the TF32 forward's key tiles of 32 and 16 hold
    fewer column groups than one chunk of 16-bit loads, which is cut to the
    tile. Also a bias broadcast over batch and heads (0-strides) and one
    that kills whole rows (-1e30)."""
    rng = np.random.RandomState(31 + D)
    B, Sq, Sk, H, hkv = 2, 130, 97, 4, 2
    q = torch.from_numpy(rng.randn(B, Sq, H, D).astype(np.float32)).to(card)
    k, v = (torch.from_numpy(rng.randn(B, Sk, hkv, D).astype(
        np.float32)).to(card) for _ in range(2))
    full = rng.randn(B, H, Sq, Sk).astype(np.float32)
    full[1, 2, 5] = -1e30
    for bias in (torch.from_numpy(full), torch.from_numpy(full[:1, :1])):
        bias = bias.to(card, bias_dtype)
        for causal in (True, False):
            _check_fwd(q, k, v, causal, dict(bias=bias),
                       f"fp32 D={D} {bias_dtype} bias {tuple(bias.shape)}")


@pytest.mark.parametrize("D", (160, 256))
def test_fp32_wide_layouts_qkv_views_and_broadcast_key(card, D):
    """The forward, dQ and dK/dV at D_pad 192 / 256 on the model's
    head-major qkv read in place, and on a key and value broadcast over the
    batch (copied before the launch: the tensor maps take no zero stride)."""
    B, S, H = 2, 300, 4
    qkv = torch.randn(B, S, H, 3, D, device=card)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    do = torch.randn(B, S, H, D, device=card)
    _check_fwd(q, k, v, True, {}, f"fp32 D={D} fwd qkv views")
    _check(q, k, v, do, True, {}, f"fp32 D={D} qkv views")
    kb = torch.randn(1, S, 2, D, device=card).expand(B, S, 2, D)
    vb = torch.randn(1, S, 2, D, device=card).expand(B, S, 2, D)
    _check_fwd(q, kb, vb, False, {}, f"fp32 D={D} fwd broadcast key")
    _check(q, kb, vb, do, False, {}, f"fp32 D={D} broadcast key")
