"""The serving slice's third kernels on the card: the paged decode kernel,
the flash forward with an additive bias, and the ragged kernel over int8 and
fp8 pools, each against its plain PyTorch version on the same inputs; what
the wrappers and C entries refuse; and the two-program engine on the card
against the same engine on the CPU.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest tests/test_torch_serving_kernels_cuda.py --noconftest -q
"""

import ctypes

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.kernels import paged_attention as PA
from paddle_tpu_torch.kernels import ragged_paged_attention as RPA
from paddle_tpu_torch.models import gpt as G
from paddle_tpu_torch.nn.functional.flash_attention import (
    scaled_dot_product_attention)
from paddle_tpu_torch.quantization.kv_cache import append_tokens_quantized

pytestmark = pytest.mark.cuda

# flash: the worst (batch, 64-row tile, head) slab's ||got - ref|| / ||ref||,
# chip_smoke.py phase 6's limits; paged kernels: max-abs err / max-abs ref
# (test_ragged_serving's bf16 bound), fp32 to summation order
FLASH_TOL = {torch.float32: 5e-6, torch.bfloat16: 2e-2}
PAGED_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / max(ref.float().abs().max().item(), 1e-9)).item()


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
# paged decode
# ---------------------------------------------------------------------------
def _decode_case(dev, dtype, hq, hkv, D, bs, seed=0):
    """Row 0 is long, row 1 ends mid-page, row 2 is empty (len 0), row 3
    fills whole pages; the table is wider than any row's used pages."""
    rng = np.random.RandomState(seed)
    lens = np.array([5 * bs + 3, bs + 1, 0, 2 * bs], np.int32)
    nb, NB = 8, 40
    tables = np.zeros((4, nb), np.int32)
    free = list(rng.permutation(np.arange(1, NB)))
    for r in range(4):
        for j in range(nb):   # every slot real: a read past len would count
            tables[r, j] = free.pop()

    def t(a, dt=dtype):
        return torch.from_numpy(a).to(dev, dt)
    # q as the engine gives it: a strided [B, H, D] view of a head-major qkv
    qkv = t(rng.randn(4, hq, 3, D).astype(np.float32))
    return [qkv[:, :, 0], t(rng.randn(hkv, NB, bs, D).astype(np.float32)),
            t(rng.randn(hkv, NB, bs, D).astype(np.float32)),
            t(tables, torch.int32), t(lens, torch.int32)], 1.0 / np.sqrt(D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,D,bs", [(4, 4, 16, 8), (8, 2, 16, 8),
                                         (16, 16, 128, 32), (16, 4, 128, 32),
                                         (4, 4, 64, 16), (16, 1, 128, 32)])
def test_paged_decode_matches_plain(card, dtype, hq, hkv, D, bs):
    args, scale = _decode_case(card, dtype, hq, hkv, D, bs)
    before = PA.paged_decode_attention.LAUNCHES
    out = PA.paged_decode_attention(*args, scale)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention.LAUNCHES == before + 1
    ref = PA.paged_decode_attention_plain(*args, scale)
    assert out.dtype == dtype and out.shape == args[0].shape
    assert torch.isfinite(out.float()).all()
    assert _rel(out, ref) <= PAGED_TOL[dtype]
    assert (out[2] == 0).all()                  # len 0 -> zeros


@pytest.mark.parametrize("bad", ["fp64", "group_not_whole",
                                 "head_dim_above_256", "int64_lens",
                                 "q_d_stride"])
def test_paged_decode_refuses_what_it_does_not_take(card, bad):
    # group_not_whole: 6 query heads over 4 kv heads; head_dim_above_256:
    # D 264 (the reference's shapes end at the flash kernels' 256)
    hq, hkv, D = {"group_not_whole": (6, 4, 16),
                  "head_dim_above_256": (4, 4, 264)}.get(bad, (4, 4, 16))
    args, scale = _decode_case(card, torch.bfloat16, hq, hkv, D, 8)
    if bad == "fp64":
        args[:3] = [a.double() for a in args[:3]]
    elif bad == "int64_lens":
        args[4] = args[4].long()
    elif bad == "q_d_stride":
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    before = PA.paged_decode_attention.LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        PA.paged_decode_attention(*args, scale)
    assert PA.paged_decode_attention.LAUNCHES == before


# ---------------------------------------------------------------------------
# flash forward with a bias
# ---------------------------------------------------------------------------
def _flash_inputs(dev, dtype, B, S, Sk, H, Hkv, D, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)
    return rnd(B, S, H, D), rnd(B, Sk, Hkv, D), rnd(B, Sk, Hkv, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["1,1", "B,1", "1,H", "B,H"])
def test_flash_bias_matches_plain(card, dtype, shape):
    B, S, Sk, H, D = 2, 128, 192, 4, 64
    q, k, v = _flash_inputs(card, dtype, B, S, Sk, H, H, D)
    mb, mh = (B if shape[0] == "B" else 1), (H if shape[-1] == "H" else 1)
    gen = torch.Generator(device=card).manual_seed(1)
    bias = (torch.randn(mb, mh, S, Sk, generator=gen, device=card) * 2).to(
        dtype)
    bias[..., 5, :] = -1e30                      # a fully masked row
    before = FA.flash_fwd.LAUNCHES
    out, lse = FA.flash_fwd(q, k, v, False, 0.125, bias)
    torch.cuda.synchronize()
    assert FA.flash_fwd.LAUNCHES == before + 1
    out_p, lse_p = FA.flash_fwd_plain(q, k, v, False, 0.125, bias)
    assert torch.equal(lse > -1e29, lse_p > -1e29)
    assert (out[:, 5] == 0).all() and (lse[:, :, 5] == -1e30).all()
    assert _tile_rel(out, out_p) <= FLASH_TOL[dtype]
    live = lse_p > -1e29
    assert ((lse - lse_p).abs()[live].max() <= 1e-5
            * lse_p.abs()[live].max().clamp_min(1.0)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdpa_bool_mask_runs_the_bias_kernel(card, dtype):
    """The two-program prefill's call: q a strided view of a head-major qkv,
    k / v the gathered [P, cap, H, D] views, a [P, 1, C, cap] keep-mask."""
    P, C, cap, H, D = 3, 128, 320, 4, 128
    gen = torch.Generator(device=card).manual_seed(2)
    qkv = torch.randn(P, C, H, 3, D, generator=gen, device=card).to(dtype)
    pool = torch.randn(H, P, cap, D, generator=gen, device=card).to(dtype)
    q, k = qkv[:, :, :, 0], pool.movedim(0, 2)
    v = pool.flip(2).movedim(0, 2)
    pos = torch.tensor([0, 100, 190], device=card)[:, None] + torch.arange(
        C, device=card)
    mask = (torch.arange(cap, device=card)[None, None] <= pos[:, :, None])
    before = FA.flash_fwd.LAUNCHES
    out = scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None])
    assert FA.flash_fwd.LAUNCHES == before + 1
    bias = torch.where(mask[:, None], 0.0, -1e30).to(dtype)
    ref, _ = FA.flash_fwd_plain(q, k, v, False, D ** -0.5, bias)
    assert _tile_rel(out, ref) <= FLASH_TOL[dtype]


def test_flash_bias_refusals(card):
    q, k, v = _flash_inputs(card, torch.bfloat16, 1, 64, 64, 2, 2, 64)
    with pytest.raises(ValueError):              # does not broadcast
        FA.flash_fwd(q, k, v, False, 0.1, torch.zeros(5, 64, 64,
                                                      device=card))
    with pytest.raises(ValueError, match="flashmask"):   # rows off [B, 1|H, Sk]
        FA.flash_attention(q, k, v, window=(8, 0),
                           bias=torch.zeros(1, 1, 64, 64, device=card),
                           startend_row_indices=(q[..., 0], q[..., 0]))
    # with a bias, the C entry still refuses D = 320 with
    # cudaErrorInvalidValue (1)
    from paddle_tpu_torch.kernels._build import load_library
    q320, k320, v320 = _flash_inputs(card, torch.bfloat16, 1, 64, 64, 2, 2,
                                     320)
    bias = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16, device=card)
    out = torch.empty_like(q320)
    lse = torch.empty(1, 2, 64, device=card)
    strides = (ctypes.c_longlong * 13)(*(list(q320.stride()[:3]) * 3
                                         + [0, 0, 64, 1]))
    code = load_library().ptt_flash_fwd(
        q320.data_ptr(), k320.data_ptr(), v320.data_ptr(), bias.data_ptr(),
        None, None, None, None, out.data_ptr(), lse.data_ptr(), strides, 1,
        64, 64, 2, 2, 320, 0.1, 0, 0, 0, 0, 0, 1.0, 1, 1, 0, -1, -1,
        torch.cuda.current_stream().cuda_stream)
    assert code == 1


# ---------------------------------------------------------------------------
# the ragged kernel over quantized pools
# ---------------------------------------------------------------------------
def _quantized_case(dev, pool_dtype, dtype, hq, hkv, D, bs, seed=0):
    """The pools filled by the port's append (two appends per row, so pages
    are requantized), then rows as in test_torch_kernels_cuda: a decode
    row, a chunk mid-sequence, an empty row, a fresh prefill."""
    rng = np.random.RandomState(seed)
    NB, C = 48, 24
    kv_lens = np.array([5 * bs + 3, 3 * bs + 1, 0, 7], np.int32)
    q_lens = np.array([1, 24, 0, 7], np.int32)
    nb = -(-int(kv_lens.max()) // bs) + 1
    tables = np.zeros((4, nb), np.int32)
    free = list(rng.permutation(np.arange(1, NB)))
    for r in range(4):
        for j in range(-(-int(kv_lens[r]) // bs)):
            tables[r, j] = free.pop()
    tables_d = torch.from_numpy(tables).to(dev)
    pools = []
    for _ in range(2):
        pool = torch.zeros(hkv, NB, bs, D, dtype=pool_dtype, device=dev)
        scales = torch.zeros(hkv, NB, device=dev)
        vals = torch.from_numpy(rng.randn(4, int(kv_lens.max()), hkv, D)
                                .astype(np.float32)).to(dev)
        half = torch.from_numpy(kv_lens // 2).to(dev)
        zero = torch.zeros(4, dtype=torch.int32, device=dev)
        append_tokens_quantized(pool, scales, vals, zero, half, tables_d, bs)
        append_tokens_quantized(pool, scales, vals[:, kv_lens.max() // 2:],
                                half, torch.from_numpy(kv_lens).to(dev)
                                - half, tables_d, bs)
        pools += [pool, scales]
    q = torch.from_numpy(rng.randn(4, C, hq, D).astype(np.float32)).to(
        dev, dtype)
    i32 = lambda a: torch.from_numpy(a).to(dev)                # noqa: E731
    return ([q, pools[0], pools[2], tables_d, i32(q_lens), i32(kv_lens)],
            (pools[1], pools[3]), 1.0 / np.sqrt(D))


@pytest.mark.parametrize("pool_dtype", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,D,bs", [(4, 4, 16, 8), (8, 2, 32, 8),
                                         (16, 16, 128, 32)])
def test_quantized_ragged_matches_plain(card, pool_dtype, dtype, hq, hkv, D,
                                        bs):
    args, scales, scale = _quantized_case(card, pool_dtype, dtype, hq, hkv,
                                          D, bs)
    before = RPA.ragged_paged_attention.LAUNCHES
    out = RPA.ragged_paged_attention(*args, scale, *scales)
    torch.cuda.synchronize()
    assert RPA.ragged_paged_attention.LAUNCHES == before + 1
    ref = RPA.ragged_paged_attention_plain(*args, scale, *scales)
    assert torch.isfinite(out.float()).all()
    assert _rel(out, ref) <= PAGED_TOL[dtype]
    for r, ql in enumerate(args[4].tolist()):
        assert (out[r, ql:] == 0).all()


@pytest.mark.parametrize("bad", ["no_scales", "fp16_scales",
                                 "head_dim_not_vector"])
def test_quantized_ragged_refusals(card, bad):
    D = 24 if bad == "head_dim_not_vector" else 16   # int8 vectors are 16
    args, scales, scale = _quantized_case(card, torch.int8, torch.bfloat16,
                                          4, 4, D, 8)
    if bad == "no_scales":
        scales = ()
    elif bad == "fp16_scales":
        scales = tuple(s.half() for s in scales)
    before = RPA.ragged_paged_attention.LAUNCHES
    err = RuntimeError if bad == "head_dim_not_vector" else TypeError
    with pytest.raises(err):
        RPA.ragged_paged_attention(*args, scale, *scales)
    assert RPA.ragged_paged_attention.LAUNCHES == before


@pytest.mark.parametrize("pool_dtype", [torch.int8, torch.float8_e4m3fn])
def test_quantized_append_on_card_equals_cpu(card, pool_dtype):
    """The card's append writes the CPU append's pools and scales, bit for
    bit (the same IEEE ops in the same order)."""
    cases = [_quantized_case(dev, pool_dtype, torch.float32, 4, 4, 16, 8)
             for dev in (card, torch.device("cpu"))]
    (a_card, s_card, _), (a_cpu, s_cpu, _) = cases
    for got, want in ((a_card[1], a_cpu[1]), (a_card[2], a_cpu[2]),
                      (s_card[0], s_cpu[0]), (s_card[1], s_cpu[1])):
        assert torch.equal(got.cpu().view(torch.uint8) if got.dtype
                           != torch.float32 else got.cpu(),
                           want.view(torch.uint8) if want.dtype
                           != torch.float32 else want)


# ---------------------------------------------------------------------------
# the two-program engine, card vs CPU
# ---------------------------------------------------------------------------
def test_two_program_engine_on_card_matches_cpu(card):
    """D = 64 (hidden 128, 2 heads): a head dim the flash kernels take."""
    cfg = G.GPTConfig(vocab_size=97, hidden_size=128, num_layers=2,
                      num_heads=2, max_seq_len=128, dtype=torch.float32)
    kw = dict(max_batch=2, block_size=8, num_blocks=24, max_blocks_per_seq=8,
              chunk=8, decode_burst=4, adaptive_mix=False,
              adaptive_burst=True, ragged=False)
    params = G.init_hybrid_params(cfg, 0, "cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 97, (n,)) for n in (5, 13, 9, 16)]

    def run(device):
        eng = ServingEngine(params, cfg, device=device, **kw)
        rids = [eng.add_request(p, 6) for p in prompts]
        res = eng.run()
        return [res[r] for r in rids], eng

    dec0, fwd0 = PA.paged_decode_attention.LAUNCHES, FA.flash_fwd.LAUNCHES
    out_card, eng = run(card)
    assert (PA.paged_decode_attention.LAUNCHES - dec0
            == cfg.num_layers * eng.decode_microsteps > 0)
    assert FA.flash_fwd.LAUNCHES - fwd0 > 0
    assert eng.dispatches <= 2 * eng.engine_steps
    assert out_card == run("cpu")[0]
