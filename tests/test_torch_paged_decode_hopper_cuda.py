"""The kernels redesigned for Hopper in the eleventh slice, on the card,
each against its plain PyTorch version on the same inputs.

* Paged decode: the "bulk-ring" route (``csrc/paged_decode_hopper.cu``:
  split page ranges, a bulk-copy page ring, the splits merged by the last
  one to finish) over the shapes of the CPU goldens
  (``test_torch_paged_decode_tiles.py``) and pages carried in parts (fp32
  at D 256, pages of 64 keys at D 128 in fp32, of 128 keys at D 256) in
  fp32, bf16 and fp16 with every split count 1-16 forced and the plan's;
  the "fp32-tiles" route (``csrc/paged_decode_attention.cu``) for a head
  dim that is not whole 16-byte words, a misaligned pool and pages of 256
  keys, in fp32 and 16 bits; two calls give the same bits; twenty calls on
  cold pages too; pages in random table order. Tolerance: 1e-2 of the
  reference's max-abs in 16 bits, 1e-5 in fp32; a len-0 row exact zeros.
* The RMSNorm backward with dw summed in the kernel (``csrc/rms_norm.cu``,
  one cooperative launch): dx and dw at rows 1, 37 and 8192 with the row
  held (bf16 H 2048) and re-read (4095, 4096), and above 28672 columns;
  dw bit for bit across two calls; a frozen weight (the dx-only kernels)
  and a frozen x. Tolerance: max-abs error over the plain version's
  max-abs, 1e-2 for dx of bf16 and fp16 x, 1e-5 for fp32 dx; dw, an fp32
  sum of the same products on both sides (the plain version given the
  kernel's rstd), 1e-5 whatever x's dtype; a bf16 dw is the kernel's fp32
  dw cast, bit for bit.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_paged_decode_hopper_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import paged_attention as PA
from paddle_tpu_torch.kernels import rms_norm as RN

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
DW_TOL = 1e-5       # dw: fp32 sums in another order, whatever x's dtype

# lens, H_q, H_kv, D, bs, nb (test_torch_paged_decode_tiles.py's cases)
CASES = {
    "page-and-split-edges": ([15, 16, 17, 63, 64, 65, 0, 128], 4, 4, 64, 16,
                             8),
    "g1-d128-bs32": ([31, 32, 33, 0], 2, 2, 128, 32, 4),
    "gqa-16-4": ([100, 1, 0, 64], 16, 4, 64, 16, 8),
    "g16-bs8": ([40, 7], 16, 1, 64, 8, 6),
    "mqa-32-1-d128": ([33, 0, 70], 32, 1, 128, 32, 3),
    "d256": ([40, 9, 0], 4, 2, 256, 16, 4),
    "mqa-32-1-d256": ([21, 48], 32, 1, 256, 16, 3),
    "bs8": ([7, 8, 9, 25], 2, 1, 64, 8, 5),
    "bs64": ([63, 64, 65, 200], 2, 2, 64, 64, 4),
    "wide-table": ([5, 20], 4, 4, 64, 8, 12),
    "len-past-table": ([100, 48], 2, 2, 64, 16, 3),
    "serving-decode-batch": ([100, 173, 256, 311, 400, 467, 555, 640], 16, 16,
                             128, 32, 20),
}
# pages the ring carries in parts and the other edges of the fp32 calls on
# the ring (test_torch_paged_decode_tiles.py's PART_CASES), and pages of 128
# keys at D 256, in parts of 32 keys in 16 bits too
RING_CASES = dict(CASES, **{
    "d256-bs32-parts-of-16": ([15, 16, 17, 31, 32, 33, 63, 64, 65, 0], 2, 2,
                              256, 32, 4),
    "d128-bs64-g16-parts-of-32": ([31, 32, 33, 64, 129], 16, 1, 128, 64, 3),
    "d64-bs8-g1-split-edges": ([15, 16, 17, 95, 96, 97], 2, 2, 64, 8, 16),
    "d100-bs16-g4": ([40, 65, 0], 8, 2, 100, 16, 6),
    "bs128-d256": ([127, 128, 129, 300], 4, 4, 256, 128, 3),
})
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / max(b.float().abs().max().item(), 1e-30)).item()


def _decode(dev, dtype, lens, hq, hkv, D, bs, nb, seed=0):
    """q as the engine gives it (a strided view of a head-major qkv), every
    table slot a distinct real block in random order."""
    rng = np.random.RandomState(seed + sum(lens) + hq + D + bs)
    B = len(lens)
    NB = B * nb + 1
    tables = rng.permutation(np.arange(1, NB))[:B * nb].reshape(B, nb)

    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    qkv = t(rng.randn(B, hq, 3, D).astype(np.float32))
    return [qkv[:, :, 0], t(rng.randn(hkv, NB, bs, D).astype(np.float32)),
            t(rng.randn(hkv, NB, bs, D).astype(np.float32)),
            t(tables.astype(np.int32), torch.int32),
            t(np.asarray(lens, np.int32), torch.int32)], 1.0 / np.sqrt(D)


def _held(out, ref, lens, tol, what):
    assert out.dtype == ref.dtype and out.shape == ref.shape, what
    assert torch.isfinite(out.float()).all(), what
    assert _rel(out, ref) <= tol, (what, _rel(out, ref))
    for b, ln in enumerate(lens):
        if ln == 0:
            assert (out[b] == 0).all(), (what, b)


# D 100 is whole 16-byte words in fp32 only (in 16 bits it takes the
# fp32-tiles route: test_shapes_off_the_ring_take_the_fp32_tiles_route)
RING_PARAMS = [pytest.param(name, dt, id=f"{name}-{tag}")
               for name in RING_CASES
               for dt, tag in zip(DTYPES, ("fp32", "bf16", "fp16"))
               if name != "d100-bs16-g4" or dt == torch.float32]


@pytest.mark.parametrize("name,dtype", RING_PARAMS)
def test_bulk_ring_vs_plain_at_every_split(card, name, dtype):
    lens, bs = RING_CASES[name][0], RING_CASES[name][4]
    args, scale = _decode(card, dtype, *RING_CASES[name])
    plan = PA.kernel_plan(args[0], args[1], args[3], args[2])
    assert plan["design"] == "bulk-ring" and plan["max_splits"] == 16
    assert plan["stages"] in (4, 8) and 1 <= plan["splits"] <= 16
    sub = plan["stage_keys"]
    assert bs % sub == 0 and (sub == bs or sub >= 16), plan
    if name == "d256-bs32-parts-of-16" and dtype == torch.float32:
        assert sub == 16, plan
    ref = PA.paged_decode_attention_plain(*args, scale)
    for splits in list(range(1, 17)) + [None]:
        n, r = (PA.paged_decode_attention.LAUNCHES,
                PA.paged_decode_attention.ROUTES["bulk-ring"])
        out = PA.paged_decode_attention(*args, scale, splits=splits)
        torch.cuda.synchronize()
        assert PA.paged_decode_attention.LAUNCHES == n + 1
        assert PA.paged_decode_attention.ROUTES["bulk-ring"] == r + 1
        _held(out, ref, lens, TOL[dtype], f"{name} splits={splits}")


@pytest.mark.parametrize("form", ["head-dim-102", "misaligned-pool",
                                  "pages-of-256"])
def test_fp32_tiles_route_vs_plain(card, form):
    """The fp32 shapes the ring does not take: a head dim that is not whole
    16-byte words, a pool off 16 bytes, pages above 128 keys."""
    shape = {"head-dim-102": ([40, 0, 17], 4, 2, 102, 16, 4),
             "misaligned-pool": ([40, 9], 4, 4, 64, 16, 4),
             "pages-of-256": ([300, 5], 4, 4, 128, 256, 2)}[form]
    args, scale = _decode(card, torch.float32, *shape)
    if form == "misaligned-pool":
        for i in (1, 2):
            shifted = torch.empty(args[i].numel() + 1, dtype=torch.float32,
                                  device=card)[1:].view(args[i].shape)
            args[i] = shifted.copy_(args[i])
    plan = PA.kernel_plan(args[0], args[1], args[3], args[2])
    assert plan["design"] == "fp32-tiles", plan
    r = PA.paged_decode_attention.ROUTES["fp32-tiles"]
    out = PA.paged_decode_attention(*args, scale)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention.ROUTES["fp32-tiles"] == r + 1
    _held(out, PA.paged_decode_attention_plain(*args, scale), shape[0],
          TOL[torch.float32], form)


@pytest.mark.parametrize("form", ["odd-head-dim-100", "fp16-head-dim-36",
                                  "misaligned-pool", "pages-of-256",
                                  "mqa-64-1-d256"])
def test_shapes_off_the_ring_take_the_fp32_tiles_route(card, form):
    """The shapes the first kernel refused or the ring does not take run
    on the CUDA-core kernel, never the plain version."""
    dtype = torch.float16 if form.startswith("fp16") else torch.bfloat16
    shape = {"odd-head-dim-100": ([40, 0, 17], 4, 2, 100, 16, 4),
             "fp16-head-dim-36": ([40, 9], 4, 4, 36, 16, 4),
             "misaligned-pool": ([40, 9], 4, 4, 64, 16, 4),
             "pages-of-256": ([300, 5], 4, 4, 128, 256, 2),
             "mqa-64-1-d256": ([70, 3], 64, 1, 256, 32, 3)}[form]
    args, scale = _decode(card, dtype, *shape)
    if form == "misaligned-pool":
        for i in (1, 2):
            shifted = torch.empty(args[i].numel() + 1, dtype=dtype,
                                  device=card)[1:].view(args[i].shape)
            args[i] = shifted.copy_(args[i])
    plan = PA.kernel_plan(args[0], args[1], args[3], args[2])
    want = "bulk-ring" if form == "mqa-64-1-d256" else "fp32-tiles"
    assert plan["design"] == want, plan
    n = PA.paged_decode_attention.ROUTES[want]
    out = PA.paged_decode_attention(*args, scale)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention.ROUTES[want] == n + 1
    _held(out, PA.paged_decode_attention_plain(*args, scale), shape[0],
          TOL[dtype], form)


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32),
                         ids=("bf16", "fp32"))
def test_two_calls_give_the_same_bits_and_table_order_is_free(card, dtype):
    args, scale = _decode(card, dtype, *CASES["serving-decode-batch"])
    a = PA.paged_decode_attention(*args, scale, splits=5)
    b = PA.paged_decode_attention(*args, scale, splits=5)
    assert torch.equal(a, b)
    # the same pages under other block numbers: the same answer
    k, v, tables = args[1], args[2], args[3]
    perm = torch.randperm(k.shape[1], generator=torch.Generator().manual_seed(
        1)).to(card)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=card)
    moved = [args[0], k[:, perm], v[:, perm], inv[tables.long()].int(),
             args[4]]
    c = PA.paged_decode_attention(*moved, scale, splits=5)
    assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32),
                         ids=("bf16", "fp32"))
def test_repeated_calls_with_cold_pages_agree(card, dtype):
    """Calls that find the pages cold (a 256 MB write between them) and the
    stream held back by a sleep, as the timings run them: the ring's stages
    and the splits' tickets give the same bits every time."""
    args, scale = _decode(card, dtype, *CASES["serving-decode-batch"])
    flush = torch.empty(64 << 20, dtype=torch.float32, device=card)
    for splits in (1, 3, None):
        first = PA.paged_decode_attention(*args, scale, splits=splits)
        for _ in range(20):
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            out = PA.paged_decode_attention(*args, scale, splits=splits)
            torch.cuda.synchronize()
            assert torch.equal(out, first), splits


def test_plan_splits_more_where_the_grid_is_short(card):
    def plan(B, hq, hkv, nb):
        q = torch.empty(B, hq, 128, dtype=torch.bfloat16, device=card)
        pool = torch.empty(hkv, 8, 32, 128, dtype=torch.bfloat16,
                           device=card)
        tables = torch.empty(B, nb, dtype=torch.int32, device=card)
        return PA.kernel_plan(q, pool, tables)["splits"]
    serving = plan(8, 16, 16, 20)
    long_gqa = plan(1, 16, 4, 256)
    assert 1 <= serving <= 16 and long_gqa > serving
    assert plan(8, 16, 16, 1) == 1          # one page a row: nothing to split


# ---------------------------------------------------------------------------
# the RMSNorm backward with dw in the kernel
# ---------------------------------------------------------------------------
def _rms(card, rows, H, dtype, seed=0):
    rng = np.random.RandomState(seed + rows + H)
    t = lambda a, dt=dtype: torch.from_numpy(a.astype(np.float32)).to(card, dt)
    x = t(rng.randn(rows, H) * 3.0 + 1.0)
    w = t(rng.randn(H), torch.float32)
    dy = t(rng.randn(rows, H))
    return x, w, dy


RMS_SHAPES = [(1, 2048), (37, 2048), (8192, 2048), (1, 4095), (37, 4096),
              (8192, 4096), (1, 28680), (37, 30000), (300, 28680)]


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32),
                         ids=("bf16", "fp32"))
@pytest.mark.parametrize("rows,H", RMS_SHAPES,
                         ids=[f"{r}x{h}" for r, h in RMS_SHAPES])
def test_rms_backward_dx_and_dw_in_one_launch(card, rows, H, dtype):
    x, w, dy = _rms(card, rows, H, dtype)
    _, rstd = RN.rms_norm_fwd(x, w, 1e-5)
    plan = RN.bwd_plan(x, w, dy)
    held = dtype == torch.bfloat16 and H == 2048
    assert plan["path"] == ("held" if held else "tiled"), plan
    assert 1 <= plan["blocks"] <= max(1, rows)
    n = RN.rms_norm_bwd.LAUNCHES
    dx, dw = RN.rms_norm_bwd(x, w, rstd, dy)
    dx2, dw2 = RN.rms_norm_bwd(x, w, rstd, dy)
    torch.cuda.synchronize()
    assert RN.rms_norm_bwd.LAUNCHES == n + 2
    dx_p, dw_p = RN.rms_norm_bwd_plain(x, w, rstd, dy)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    assert _rel(dx, dx_p) <= TOL[dtype] and _rel(dw, dw_p) <= DW_TOL
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)


@pytest.mark.parametrize("frozen", ["weight", "x"])
@pytest.mark.parametrize("H", [2048, 4095])
def test_rms_backward_frozen_weight_or_x(card, frozen, H):
    x, w, dy = _rms(card, 64, H, torch.bfloat16)
    xr, wr = x.clone().requires_grad_(frozen == "weight"), \
        w.clone().requires_grad_(frozen == "x")
    target = xr if frozen == "weight" else wr
    n = RN.rms_norm_bwd.LAUNCHES
    (g,) = torch.autograd.grad(RN.rms_norm(xr, wr, 1e-5), (target,), dy)
    assert RN.rms_norm_bwd.LAUNCHES == n + 1
    _, rstd = RN.rms_norm_fwd(x, w, 1e-5)
    dx_p, dw_p = RN.rms_norm_bwd_plain(x, w, rstd, dy)
    ref, tol = ((dx_p, TOL[torch.bfloat16]) if frozen == "weight" else
                (dw_p, DW_TOL))
    assert g.shape == ref.shape and _rel(g, ref) <= tol
    dx, dw = RN.rms_norm_bwd(x, w, rstd, dy, need_dx=frozen == "weight",
                             need_dw=frozen == "x")
    assert (dw is None) == (frozen == "weight") and \
        (dx is None) == (frozen == "x")


def test_rms_backward_fp16_and_a_bf16_weight(card):
    x, w, dy = _rms(card, 129, 2048, torch.float16)
    wb = w.to(torch.bfloat16).requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    gx, gw = torch.autograd.grad(RN.rms_norm(xr, wb, 1e-5), (xr, wb), dy)
    _, rstd = RN.rms_norm_fwd(x, wb.detach(), 1e-5)
    dx_p, dw_p = RN.rms_norm_bwd_plain(x, wb.detach(), rstd, dy)
    _, dw = RN.rms_norm_bwd(x, wb.detach(), rstd, dy)
    assert gx.dtype == torch.float16 and gw.dtype == torch.bfloat16
    assert _rel(gx, dx_p) <= 1e-2 and _rel(dw, dw_p) <= DW_TOL
    assert torch.equal(gw, dw.to(torch.bfloat16))
