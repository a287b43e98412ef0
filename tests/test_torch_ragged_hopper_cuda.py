"""The redesigned ragged paged-attention kernels on the card
(``csrc/ragged_paged_attention_hopper.cu``: wgmma, pages through a TMA ring,
a row's key tiles split over blocks and merged by a second kernel;
``csrc/ragged_paged_attention_tf32_hopper.cu``: the same for fp32 queries
over fp32, int8 and fp8 pools on the TF32 tensor cores, each operand split
into two TF32 halves; both with a gathered page ring, key row by key row:
the 16-bit kernel at page sizes that are not a multiple of 8, the TF32
kernel at every page size) against their plain PyTorch
version, over the shapes of the CPU goldens (``test_torch_ragged_tiles.py``,
``test_torch_ragged_pages.py``) at D 128 and 64 (and 40 in fp32), bf16,
fp16 and fp32, with the split count forced to 1, 2 and many (every count
1-16 in fp32, on the gathered rings at pages of 5, 12, 20 and 100 keys,
and at D_pad 192 and 256: D 160 and 256 on both kernels, int8 / fp8
pools there, fp32 queries over them at pages of 5, 12, 32 and 100) and
left to the plan; int8 / fp8 pools under 16-bit and fp32 queries; a page
too large for the CUDA-core kernel's shared memory; and the calls that
stay on the CUDA-core kernel of ``csrc/ragged_paged_attention.cu`` (D 100
in bf16, 99 and 250 in fp32, a misaligned pool): each launches its kernel (counted under
its route), none goes to the plain version; D above 256 raises. Tolerance:
1e-2 of the reference's max-abs (``chip_smoke.py`` KERNEL_TOL) in 16 bits,
1e-5 in fp32 (over any pool); 16-bit queries over quantized pools 1e-2 on
the worst (row, column, head) slab's relative L2, as ``chip_smoke.py``
phase 12 holds them (the dequantized tile is rounded to 16 bits for the
tensor cores); columns past q_len exact zeros.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_ragged_hopper_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import ragged_paged_attention as RPA

pytestmark = pytest.mark.cuda

# q_lens, kv_lens, C, hq, hkv, bs, nb (test_torch_ragged_tiles.py's cases)
CASES = {
    "gqa-16-4-qlen-g-across-64": ([15, 16, 17, 1], [15, 80, 130, 200], 20, 16,
                                  4, 16, None),
    "mha-16-16-qlen-across-64": ([63, 64, 65, 0], [63, 127, 129, 0], 65, 16,
                                 16, 32, None),
    "kv-across-page-and-tile": ([1, 1, 1, 1, 1, 1], [31, 32, 33, 63, 64, 65],
                                1, 16, 4, 32, None),
    "kv-across-split-ranges": ([1, 1, 4, 1], [128, 129, 320, 513], 4, 16, 16,
                               16, 33),
    "pages-of-64": ([1, 40, 0, 7], [130, 100, 0, 7], 40, 16, 4, 64, None),
    "decode-batch-of-phase-3": ([1] * 8, [100, 173, 256, 311, 400, 467, 555,
                                          640], 1, 16, 16, 32, 20),
    "empty-rows-and-row-past-its-table": ([0, 5, 0, 1], [0, 9, 40, 70], 5, 16,
                                          4, 16, 3),
    "mixed-of-phase-3": ([128, 100, 1, 0], [384, 100, 517, 0], 128, 16, 16,
                         32, 20),
}
SPLITS = (1, 2, 7, None)      # None: the plan's count
EVERY_SPLIT = tuple(range(1, 17)) + (None,)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, dtype, q_lens, kv_lens, C, hq, hkv, bs, nb, D=128, seed=0,
          pool_dtype=None):
    rng = np.random.RandomState(seed + sum(kv_lens) + C + hkv + bs)
    R = len(q_lens)
    nb = nb or max(max(-(-k // bs) for k in kv_lens), 1)
    NB = R * nb + 1
    tables = rng.permutation(np.arange(1, NB))[:R * nb].reshape(R, nb)

    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    pool = pool_dtype or dtype
    return [t(rng.randn(R, C, hq, D).astype(np.float32)),
            t(rng.randn(hkv, NB, bs, D).astype(np.float32), pool),
            t(rng.randn(hkv, NB, bs, D).astype(np.float32), pool),
            t(tables.astype(np.int32), torch.int32),
            t(np.asarray(q_lens, np.int32), torch.int32),
            t(np.asarray(kv_lens, np.int32), torch.int32)], 1.0 / np.sqrt(D)


def _check(out, ref, q_lens, tol, what, slabs=False):
    """Max-abs error within ``tol`` of the reference's max-abs; with
    ``slabs`` (quantized pools, as ``chip_smoke.py`` phase 12 holds them)
    the worst (row, column, head) slab's L2 error within ``tol`` of its
    L2 norm instead. Columns past q_len exact zeros either way."""
    assert out.dtype == ref.dtype and out.shape == ref.shape, what
    assert torch.isfinite(out.float()).all(), what
    d, r = out.float() - ref.float(), ref.float()
    if slabs:
        dd, rr = d.square().sum(-1), r.square().sum(-1)
        rel = torch.where(rr > 0, (dd / rr.clamp_min(1e-30)).sqrt(),
                          torch.where(dd > 0, float("inf"), 0.0)).max().item()
        assert rel <= tol, (what, rel)
    else:
        err, top = d.abs().max().item(), r.abs().max().item()
        assert err <= tol * max(top, 1e-6), (what, err, top)
    for row, ql in enumerate(q_lens.tolist()):
        assert (out[row, ql:] == 0).all(), (what, row)


# (D, pool dtype or None): the 16-bit kernel's four widths (D 160 and 256
# read into D_pad 192 and 256), and 1-byte pools at D_pad 256
WIDTHS = ((128, None), (64, None), (160, None), (256, None),
          (256, torch.int8), (256, torch.float8_e4m3fn))


@pytest.mark.parametrize("D,pool", WIDTHS,
                         ids=("D128", "D64", "D160", "D256", "D256-int8",
                              "D256-fp8"))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16),
                         ids=("bf16", "fp16"))
@pytest.mark.parametrize("name", list(CASES))
def test_wgmma_kernel_vs_plain_at_forced_splits(card, name, dtype, D, pool):
    """At D_pad <= 128 the split counts 1, 2 and 7; past it every count
    1-16; quantized pools held by the worst slab (``_check``)."""
    args, scale = _case(card, dtype, *CASES[name], D=D)
    extra = _quantize(args, pool) if pool is not None else {}
    plan = RPA.kernel_plan(args[0], args[1], args[3])
    assert plan["design"] == "wgmma+tma" and plan["query_rows"] == 64
    assert plan["keys"] == 64 and plan["splits"] >= 1
    ref = RPA.ragged_paged_attention_plain(*args, scale, **extra)
    for splits in SPLITS if D <= 128 else EVERY_SPLIT:
        n, w = (RPA.ragged_paged_attention.LAUNCHES,
                RPA.ragged_paged_attention.ROUTES["wgmma+tma"])
        out = RPA.ragged_paged_attention(*args, scale, splits=splits, **extra)
        torch.cuda.synchronize()
        assert RPA.ragged_paged_attention.LAUNCHES == n + 1
        assert RPA.ragged_paged_attention.ROUTES["wgmma+tma"] == w + 1
        _check(out, ref, args[4], 1e-2, f"{name} D={D} splits={splits}",
               slabs=pool is not None)


def test_plan_splits_short_grids_only(card):
    """One long decode row (16 blocks: most SMs idle) splits; the serving
    decode batch (8 rows x 16 kv heads: 128 blocks, about one an SM) and a
    prefill batch do not; a split keeps at least 4 key tiles of the table.
    The plan reads shapes only (the tensors here are never filled)."""
    def plan(R, C, nb, hkv=16):
        q = torch.empty(R, C, 16, 128, dtype=torch.bfloat16, device=card)
        pool = torch.empty(hkv, 8, 32, 128, dtype=torch.bfloat16, device=card)
        tables = torch.empty(R, nb, dtype=torch.int32, device=card)
        return RPA.kernel_plan(q, pool, tables)["splits"]
    assert plan(1, 1, 256) > 1               # kv 8192 over 16 kv heads
    assert plan(2, 1, 256, hkv=4) > 1        # GQA: 8 blocks
    assert plan(8, 1, 20) == 1               # phase 3's decode batch
    assert plan(64, 128, 20) == 1            # 2048 blocks
    assert plan(1, 1, 4) == 1                # 2 key tiles: nothing to split
    assert plan(1, 1, 16) == 2               # 8 key tiles: 2 of 4


def _quantize(args, pool):
    """The pools as int8 / fp8 e4m3 against their per-(kv head, page)
    absmax scales (the layout of ``quantization/kv_cache.py``)."""
    qmax = 127.0 if pool == torch.int8 else 448.0
    k, v = args[1].float(), args[2].float()
    ks, vs = (x.abs().amax((2, 3)).clamp_min(1e-6) for x in (k, v))
    kq, vq = (x / sc[..., None, None] * qmax for x, sc in ((k, ks), (v, vs)))
    if pool == torch.int8:
        kq, vq = torch.round(kq), torch.round(vq)
    args[1], args[2] = kq.to(pool), vq.to(pool)
    return dict(k_scales=ks.contiguous(), v_scales=vs.contiguous())


ROUTES = {  # route: (q dtype, pool, page size, design, D)
    "fp32": (torch.float32, None, 16, "wgmma-3xtf32", 128),
    "fp32_int8": (torch.float32, torch.int8, 16, "wgmma-3xtf32", 128),
    "fp32_fp8_d64": (torch.float32, torch.float8_e4m3fn, 32, "wgmma-3xtf32",
                     64),
    "fp32_bs_12": (torch.float32, None, 12, "wgmma-3xtf32", 128),
    "fp32_int8_bs_12": (torch.float32, torch.int8, 12, "wgmma-3xtf32", 128),
    "bs_12": (torch.bfloat16, None, 12, "wgmma+gather", 128),
    "int8_bs_12": (torch.bfloat16, torch.int8, 12, "wgmma+gather", 128),
    "int8": (torch.bfloat16, torch.int8, 16, "wgmma+tma", 128),
    "fp8": (torch.bfloat16, torch.float8_e4m3fn, 16, "wgmma+tma", 128),
    "fp8_fp16_q": (torch.float16, torch.float8_e4m3fn, 32, "wgmma+tma", 128),
    "d256": (torch.bfloat16, None, 16, "wgmma+tma", 256),
    "int8_d256": (torch.bfloat16, torch.int8, 16, "wgmma+tma", 256),
    "fp8_fp16_q_d192": (torch.float16, torch.float8_e4m3fn, 32, "wgmma+tma",
                        192),
    "bs_12_d256": (torch.bfloat16, None, 12, "wgmma+gather", 256),
    "fp32_d256": (torch.float32, None, 16, "wgmma-3xtf32", 256),
    "fp32_int8_d256": (torch.float32, torch.int8, 16, "wgmma-3xtf32", 256),
    "fp32_fp8_d160": (torch.float32, torch.float8_e4m3fn, 32, "wgmma-3xtf32",
                      160),
    "fp32_d250": (torch.float32, None, 16, "fp32", 250),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", ("gqa-16-4-qlen-g-across-64",
                                  "decode-batch-of-phase-3",
                                  "kv-across-split-ranges"))
def test_routes_launch_their_kernel(card, name, route):
    """Each route launches its own kernel, counted under its design, and
    matches the plain version: 16-bit queries over 16-bit, int8 / fp8 pools
    on the wgmma kernel up to D 256 (a quantized page dequantized by the
    consumer into the 16-bit tile, at forced split counts too); fp32
    queries over fp32, int8 and fp8 pools on the TF32 kernel up to D 256
    (held at 1e-5 of max-abs), at every page size; a page size that is not
    a multiple of 8 on the 16-bit kernel's gathered ring; fp32 queries at D
    250 (not whole 16-byte words) on the CUDA-core kernel, which refuses a
    split count above 1."""
    dtype, pool, bs, design, D = ROUTES[route]
    q_lens, kv_lens, C, hq, hkv, _, nb = CASES[name]
    args, scale = _case(card, dtype, q_lens, kv_lens, C, hq, hkv, bs, nb,
                        D=D)
    extra = _quantize(args, pool) if pool is not None else {}
    plan = RPA.kernel_plan(args[0], args[1], args[3])
    assert plan["design"] == design
    ref = RPA.ragged_paged_attention_plain(*args, scale, **extra)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for splits in ((None,) if design == "fp32" else (1, 3, None)):
        n, c = (RPA.ragged_paged_attention.LAUNCHES,
                RPA.ragged_paged_attention.ROUTES[design])
        out = RPA.ragged_paged_attention(*args, scale, splits=splits, **extra)
        torch.cuda.synchronize()
        assert RPA.ragged_paged_attention.LAUNCHES == n + 1
        assert RPA.ragged_paged_attention.ROUTES[design] == c + 1
        _check(out, ref, args[4], tol, f"{route} {name} splits={splits}",
               slabs=pool is not None and dtype != torch.float32)
    if design == "fp32":
        with pytest.raises(RuntimeError, match="invalid argument"):
            RPA.ragged_paged_attention(*args, scale, splits=2, **extra)
        assert RPA.ragged_paged_attention.LAUNCHES == n + 1


def _tf32_keys(D):
    """The TF32 kernel's key tile: 32, and 16 at D_pad 192 / 256."""
    return 16 if D > 128 else 32


@pytest.mark.parametrize("D", (128, 64, 40, 160, 256))
@pytest.mark.parametrize("name", list(CASES))
def test_tf32_kernel_vs_plain_at_every_split_count(card, name, D):
    """fp32 queries over fp32 pools on the TF32 kernel (64 folded rows a
    block, key tiles of 32, of 16 at D 160 and 256), held at 1e-5 at every
    forced split count 1-16 and at the plan's."""
    args, scale = _case(card, torch.float32, *CASES[name], D=D)
    plan = RPA.kernel_plan(args[0], args[1], args[3])
    assert plan["design"] == "wgmma-3xtf32" and plan["query_rows"] == 64
    assert plan["keys"] == _tf32_keys(D) and plan["splits"] >= 1
    ref = RPA.ragged_paged_attention_plain(*args, scale)
    for splits in list(range(1, 17)) + [None]:
        n, w = (RPA.ragged_paged_attention.LAUNCHES,
                RPA.ragged_paged_attention.ROUTES["wgmma-3xtf32"])
        out = RPA.ragged_paged_attention(*args, scale, splits=splits)
        torch.cuda.synchronize()
        assert RPA.ragged_paged_attention.LAUNCHES == n + 1
        assert RPA.ragged_paged_attention.ROUTES["wgmma-3xtf32"] == w + 1
        _check(out, ref, args[4], 1e-5, f"{name} D={D} splits={splits}")


POOLS = (None, torch.int8, torch.float8_e4m3fn)
POOL_IDS = ("float", "int8", "fp8")


@pytest.mark.parametrize("pool", POOLS[1:], ids=POOL_IDS[1:])
@pytest.mark.parametrize("D", (128, 64, 160, 256))
@pytest.mark.parametrize("name", list(CASES))
def test_tf32_kernel_over_1byte_pools_at_every_split_count(card, name, D,
                                                           pool):
    """fp32 queries over int8 / fp8 pools on the TF32 kernel (raw 1-byte
    rows gathered, dequantized by the split warps into the fp32 value
    the reference forms, x * (scale / qmax)), held at 1e-5 of max-abs at
    every forced split count 1-16 and at the plan's."""
    args, scale = _case(card, torch.float32, *CASES[name], D=D)
    extra = _quantize(args, pool)
    plan = RPA.kernel_plan(args[0], args[1], args[3])
    assert plan["design"] == "wgmma-3xtf32" and plan["keys"] == _tf32_keys(D)
    ref = RPA.ragged_paged_attention_plain(*args, scale, **extra)
    for splits in list(range(1, 17)) + [None]:
        w = RPA.ragged_paged_attention.ROUTES["wgmma-3xtf32"]
        out = RPA.ragged_paged_attention(*args, scale, splits=splits, **extra)
        torch.cuda.synchronize()
        assert RPA.ragged_paged_attention.ROUTES["wgmma-3xtf32"] == w + 1
        _check(out, ref, args[4], 1e-5, f"{name} D={D} splits={splits}")


# the gathered ring's batches: the cases above at other page sizes (just
# enough pages, except where the table's width is the point)
GATHER_CASES = ("gqa-16-4-qlen-g-across-64", "kv-across-page-and-tile",
                "kv-across-split-ranges", "decode-batch-of-phase-3",
                "empty-rows-and-row-past-its-table", "mixed-of-phase-3")


@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32),
                         ids=("bf16", "fp32"))
@pytest.mark.parametrize("bs", (5, 12, 20, 100))
@pytest.mark.parametrize("name", GATHER_CASES)
def test_gathered_ring_vs_plain_at_every_split_count(card, name, bs, dtype,
                                                     pool):
    """Pages of 5, 12, 20 and 100 keys (not a multiple of 8: no TMA box of
    whole swizzle atoms fits them) on the gathered ring of the 16-bit
    kernel ("wgmma+gather") and of the TF32 kernel ("wgmma-3xtf32", which
    gathers every page size), over float, int8 and fp8 pools, at every
    forced split count 1-16 and at the plan's: the copies land through the
    generic proxy, so a missing proxy fence would read stale tiles now and
    then."""
    q_lens, kv_lens, C, hq, hkv, _, nb = CASES[name]
    keep_nb = name in ("kv-across-split-ranges",
                       "empty-rows-and-row-past-its-table")
    args, scale = _case(card, dtype, q_lens, kv_lens, C, hq, hkv, bs,
                        nb if keep_nb else None)
    extra = _quantize(args, pool) if pool is not None else {}
    design = "wgmma-3xtf32" if dtype == torch.float32 else "wgmma+gather"
    plan = RPA.kernel_plan(args[0], args[1], args[3])
    assert plan["design"] == design
    assert plan["keys"] == (32 if dtype == torch.float32 else 64)
    ref = RPA.ragged_paged_attention_plain(*args, scale, **extra)
    fp32 = dtype == torch.float32
    for splits in list(range(1, 17)) + [None]:
        n, c = (RPA.ragged_paged_attention.LAUNCHES,
                RPA.ragged_paged_attention.ROUTES[design])
        out = RPA.ragged_paged_attention(*args, scale, splits=splits, **extra)
        torch.cuda.synchronize()
        assert RPA.ragged_paged_attention.LAUNCHES == n + 1
        assert RPA.ragged_paged_attention.ROUTES[design] == c + 1
        _check(out, ref, args[4], 1e-5 if fp32 else 1e-2,
               f"{name} bs={bs} splits={splits}",
               slabs=pool is not None and not fp32)


@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
@pytest.mark.parametrize("D", (160, 256))
@pytest.mark.parametrize("bs", (5, 12, 32, 100))
@pytest.mark.parametrize("name", GATHER_CASES)
def test_tf32_wide_gathered_ring_at_every_split_count(card, name, bs, D,
                                                      pool):
    """fp32 queries at D 160 and 256 (D_pad 192 / 256: key tiles of 16, V^T
    rows shared by two split stages) over float, int8 and fp8 pools, pages
    of 5, 12, 32 and 100 keys, at every forced split count 1-16 and at the
    plan's, held at 1e-5 of max-abs."""
    q_lens, kv_lens, C, hq, hkv, _, nb = CASES[name]
    keep_nb = name in ("kv-across-split-ranges",
                       "empty-rows-and-row-past-its-table")
    args, scale = _case(card, torch.float32, q_lens, kv_lens, C, hq, hkv, bs,
                        nb if keep_nb else None, D=D)
    extra = _quantize(args, pool) if pool is not None else {}
    plan = RPA.kernel_plan(args[0], args[1], args[3])
    assert (plan["design"], plan["keys"]) == ("wgmma-3xtf32", 16)
    ref = RPA.ragged_paged_attention_plain(*args, scale, **extra)
    for splits in list(range(1, 17)) + [None]:
        c = RPA.ragged_paged_attention.ROUTES["wgmma-3xtf32"]
        out = RPA.ragged_paged_attention(*args, scale, splits=splits, **extra)
        torch.cuda.synchronize()
        assert RPA.ragged_paged_attention.ROUTES["wgmma-3xtf32"] == c + 1
        _check(out, ref, args[4], 1e-5, f"{name} D={D} bs={bs} "
               f"splits={splits}")


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32),
                         ids=("bf16", "fp32"))
def test_page_too_large_for_the_cuda_core_kernel(card, dtype):
    """Pages of 300 keys at D 128: the CUDA-core kernel held a whole page
    in shared memory and refused them (330 KB in bf16); the gathered ring
    walks them in key tiles."""
    args, scale = _case(card, dtype, [1, 1, 5, 0], [299, 300, 650, 0], 5,
                        16, 4, 300, None)
    design = "wgmma-3xtf32" if dtype == torch.float32 else "wgmma+gather"
    assert RPA.kernel_plan(args[0], args[1], args[3])["design"] == design
    ref = RPA.ragged_paged_attention_plain(*args, scale)
    c = RPA.ragged_paged_attention.ROUTES[design]
    out = RPA.ragged_paged_attention(*args, scale)
    torch.cuda.synchronize()
    assert RPA.ragged_paged_attention.ROUTES[design] == c + 1
    _check(out, ref, args[4], 1e-5 if dtype == torch.float32 else 1e-2,
           f"bs=300 {dtype}")


@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16,
                                   torch.float32), ids=("bf16", "fp16", "fp32"))
def test_plan_keeps_the_tma_ring_at_pages_of_whole_8_rows(card, dtype, pool):
    """Every page size that is a multiple of 8 keeps the 16-bit kernel's
    TMA design; the others take its gathered ring. fp32 queries take the
    TF32 kernel, which gathers every page size. The plan reads shapes
    only."""
    q = torch.empty(2, 1, 16, 128, dtype=dtype, device=card)
    tables = torch.empty(2, 4, dtype=torch.int32, device=card)
    for bs in range(1, 137):
        k = torch.empty(4, 8, bs, 128, dtype=pool or dtype, device=card)
        want = ("wgmma-3xtf32" if dtype == torch.float32 else
                "wgmma+tma" if bs % 8 == 0 else "wgmma+gather")
        assert RPA.kernel_plan(q, k, tables)["design"] == want, bs


@pytest.mark.parametrize("D", (100, 160, 256, 99))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("name", ("gqa-16-4-qlen-g-across-64",
                                  "decode-batch-of-phase-3",
                                  "mixed-of-phase-3"))
def test_wide_and_odd_head_dims(card, name, dtype, D):
    """D 160 and 256 in bf16 run the 16-bit wgmma kernel at D_pad 192 and
    256, in fp32 the TF32 kernel there; D 100 in bf16 (not a whole number
    of 16-byte words) and 99 (odd: one element a thread) the CUDA-core
    kernel, which refuses a split count above 1; D 100 in fp32 (25 words)
    the TF32 kernel, at D_pad 128."""
    args, scale = _case(card, dtype, *CASES[name], D=D)
    if dtype == torch.float32:
        design = "fp32" if D == 99 else "wgmma-3xtf32"
    else:
        design = "wgmma+tma" if D in (160, 256) else "fp32"
    assert RPA.kernel_plan(args[0], args[1], args[3])["design"] == design
    ref = RPA.ragged_paged_attention_plain(*args, scale)
    n, c = (RPA.ragged_paged_attention.LAUNCHES,
            RPA.ragged_paged_attention.ROUTES[design])
    out = RPA.ragged_paged_attention(*args, scale)
    torch.cuda.synchronize()
    assert RPA.ragged_paged_attention.LAUNCHES == n + 1
    assert RPA.ragged_paged_attention.ROUTES[design] == c + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    _check(out, ref, args[4], tol, f"{name} D={D} {dtype}")
    if design == "fp32":
        with pytest.raises(RuntimeError, match="invalid argument"):
            RPA.ragged_paged_attention(*args, scale, splits=2)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("fp32", "bf16"))
def test_misaligned_pools_on_the_cuda_core_kernel(card, dtype):
    """Pools that start 4 bytes past a 16-byte boundary (views one element
    into a larger buffer) run the CUDA-core kernel's element loads."""
    args, scale = _case(card, dtype, *CASES["gqa-16-4-qlen-g-across-64"])
    for i in (1, 2):
        flat = torch.empty(args[i].numel() + 8, dtype=dtype, device=card)
        view = flat[2 if dtype == torch.bfloat16 else 1:][:args[i].numel()]
        view.copy_(args[i].reshape(-1))
        args[i] = view.view(args[i].shape)
        assert args[i].data_ptr() % 16
    plan = RPA.kernel_plan(args[0], args[1], args[3], args[2])
    assert plan["design"] == "fp32"
    ref = RPA.ragged_paged_attention_plain(*args, scale)
    c = RPA.ragged_paged_attention.ROUTES["fp32"]
    out = RPA.ragged_paged_attention(*args, scale)
    torch.cuda.synchronize()
    assert RPA.ragged_paged_attention.ROUTES["fp32"] == c + 1
    _check(out, ref, args[4], 1e-5 if dtype == torch.float32 else 1e-2,
           f"misaligned {dtype}")


def test_head_dim_above_256_raises(card):
    args, scale = _case(card, torch.bfloat16, *CASES["decode-batch-of-phase-3"],
                        D=264)
    n = RPA.ragged_paged_attention.LAUNCHES
    with pytest.raises(ValueError, match="K15"):
        RPA.ragged_paged_attention(*args, scale)
    assert RPA.ragged_paged_attention.LAUNCHES == n
