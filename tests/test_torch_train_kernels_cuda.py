"""The training slice's CUDA kernels on the card: the flash attention forward,
its dQ and dK/dV kernels, and the one-pass Adam update, each against its
plain PyTorch version on the same inputs; the launch counters; what the
wrappers and C entries refuse. (``chip_smoke.py`` phase 8 trains a tiny GPT
on the card against the same model on the CPU.)

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest tests/test_torch_train_kernels_cuda.py --noconftest -q
"""

import ctypes

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import fused_adam as FAD
from paddle_tpu_torch.kernels import flash_attention as FA

pytestmark = pytest.mark.cuda

# (out, grads) tolerances on the worst tile's ||got - ref|| / ||ref||
# (_tile_rel), as chip_smoke.py holds the flagship's call: fp32 summation
# order; bf16 rounding of the outputs and of the tensor-core operands
TOL = {torch.float32: (5e-6, 5e-6), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, dtype, B, sq, sk, H, Hkv, D, seed=0):
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype)
    return t(B, sq, H, D), t(B, sk, Hkv, D), t(B, sk, Hkv, D), t(B, sq, H, D)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / max(b.float().abs().max().item(), 1.0)).item()


def _tile_rel(got, ref, rows=64):
    """Worst ||got - ref|| / ||ref|| over the (batch, 64-row tile, head)
    slabs of [B, S, H, D] tensors (chip_smoke.tile_rel_err): a dropped or
    wrong tile fails however small its values are."""
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


CASES = [  # B, sq, sk, H, Hkv, D, causal
    (2, 128, 128, 4, 4, 64, True),
    (2, 100, 100, 4, 4, 64, True),       # S not a multiple of the tile
    (1, 64, 192, 4, 2, 128, True),       # rectangular causal, GQA 4/2
    (1, 192, 64, 4, 1, 64, True),        # sq > sk: dead rows, MQA
    (2, 96, 160, 8, 2, 128, False),      # non-causal, GQA 8/2
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,sq,sk,H,Hkv,D,causal", CASES)
def test_flash_kernels_match_plain(card, dtype, B, sq, sk, H, Hkv, D, causal):
    q, k, v, do = _qkv(card, dtype, B, sq, sk, H, Hkv, D)
    scale = 1.0 / np.sqrt(D)
    n = (FA.flash_fwd.LAUNCHES, FA.flash_bwd_dq.LAUNCHES,
         FA.flash_bwd_dkv.LAUNCHES)
    out, lse = FA.flash_fwd(q, k, v, causal, scale)
    dq, dk, dv = FA.flash_bwd(q, k, v, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert (FA.flash_fwd.LAUNCHES, FA.flash_bwd_dq.LAUNCHES,
            FA.flash_bwd_dkv.LAUNCHES) == tuple(x + 1 for x in n)
    out_p, lse_p = FA.flash_fwd_plain(q, k, v, causal, scale)
    grads_p = FA.flash_bwd_plain(q, k, v, lse, do, causal, scale)
    assert FA.flash_fwd.LAUNCHES == n[0] + 1      # plain calls do not count
    tol_o, tol_g = TOL[dtype]
    assert out.dtype == dtype and out.shape == q.shape
    assert _tile_rel(out, out_p) <= tol_o
    live = lse_p > -1e29
    assert torch.equal(live, lse > -1e29)
    assert _rel(lse[live], lse_p[live]) <= 1e-5
    for got, ref, like in zip((dq, dk, dv), grads_p, (q, k, v)):
        assert got.dtype == dtype and got.shape == like.shape
        assert torch.isfinite(got.float()).all()
        assert _tile_rel(got, ref) <= tol_g
    if causal and sq > sk:
        assert (out[:, :sq - sk] == 0).all()
        assert (dq[:, :sq - sk] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_reads_head_major_qkv_views(card, dtype):
    """The model's q, k, v are strided views of qkv [B, S, H, 3, D]: the
    kernels read them in place and agree with contiguous copies."""
    rng = np.random.RandomState(1)
    qkv = torch.from_numpy(rng.randn(2, 80, 4, 3, 64).astype(np.float32)).to(
        card, dtype)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    assert not q.is_contiguous()
    out, lse = FA.flash_fwd(q, k, v, True, 0.125)
    out_c, lse_c = FA.flash_fwd(q.contiguous(), k.contiguous(),
                                v.contiguous(), True, 0.125)
    assert torch.equal(out, out_c) and torch.equal(lse, lse_c)


def test_flash_gqa_dkv_is_deterministic(card):
    q, k, v, do = _qkv(card, torch.bfloat16, 2, 256, 256, 16, 4, 128)
    lse = FA.flash_fwd(q, k, v, True, 0.088)[1]
    a = FA.flash_bwd(q, k, v, lse, do, True, 0.088)
    b = FA.flash_bwd(q, k, v, lse, do, True, 0.088)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_autograd_function(card):
    q, k, v, do = _qkv(card, torch.float32, 1, 64, 64, 2, 2, 64)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = FA.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    o_p, lse_p = FA.flash_fwd_plain(q.detach(), k.detach(), v.detach(), True,
                                    0.125)
    ref = FA.flash_bwd_plain(q.detach(), k.detach(), v.detach(), lse_p,
                             do, True, 0.125)
    tol_o, tol_g = TOL[torch.float32]
    assert _tile_rel(out.detach(), o_p) <= tol_o
    for g, r in zip(grads, ref):
        assert _tile_rel(g, r) <= tol_g


def test_flash_refusals(card):
    q, k, v, _ = _qkv(card, torch.float32, 1, 64, 64, 2, 2, 64)
    with pytest.raises(TypeError, match="float64"):
        FA.flash_fwd(q.double(), k.double(), v.double(), True, 0.1)
    with pytest.raises(ValueError):              # no unit stride over D
        FA.flash_fwd(q.transpose(1, 3), k.transpose(1, 3), v.transpose(1, 3),
                     True, 0.1)
    with pytest.raises(ValueError):              # D above 256
        q320, k320, v320, _ = _qkv(card, torch.float32, 1, 64, 64, 2, 2, 320)
        FA.flash_fwd(q320, k320, v320, True, 0.1)
    # the C entry itself refuses D = 320, and a bf16 D = 36 whose row is not
    # a whole number of 16-byte words (the wrapper pads that one), with
    # cudaErrorInvalidValue (1)
    from paddle_tpu_torch.kernels._build import load_library
    q36 = torch.zeros(1, 64, 2, 36, device=card, dtype=torch.bfloat16)
    for qq, D, code in ((q320, 320, 0), (q36, 36, 1)):
        out = torch.empty_like(qq)
        lse = torch.empty(1, 2, 64, device=card)
        strides = (ctypes.c_longlong * 13)(*(list(qq.stride()[:3]) * 3
                                             + [0] * 4))
        got = load_library().ptt_flash_fwd(
            qq.data_ptr(), qq.data_ptr(), qq.data_ptr(), None, None, None,
            None, None, out.data_ptr(), lse.data_ptr(), strides, 1, 64, 64, 2,
            2, D, 0.1, 1, 0, 0, 0, 0, 1.0, code, 0, 0, -1, -1,
            torch.cuda.current_stream().cuda_stream)
        assert got == 1, (D, got)
    # the window is ported (test_torch_flashmask_kernels_cuda.py); rows that
    # do not fit [B, 1|H, Sk] are refused
    with pytest.raises(ValueError, match="flashmask"):
        FA.flash_attention(q, k, v, causal=True,
                           startend_row_indices=(q[..., 0], q[..., 0]))


# ---------------------------------------------------------------------------
# fused Adam
# ---------------------------------------------------------------------------
def _adam_case(dev, shape, pdt, mdt, master=False, seed=0):
    rng = np.random.RandomState(seed)

    def t(scale, dt):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(dev, dt)
    p, g = t(1.0, pdt), t(0.01, pdt)
    slot = {"moment1": t(0.01, mdt), "moment2": t(1e-4, mdt).abs()}
    if master:
        slot["master"] = p.float() + 1e-4
    return p, g, slot


def _clone(p, g, slot):
    return p.clone(), g.clone(), {k: v.clone() for k, v in slot.items()}


@pytest.mark.parametrize("pdt,mdt,master", [
    (torch.float32, torch.float32, False),
    (torch.bfloat16, torch.bfloat16, False),
    (torch.float32, torch.bfloat16, False),
    (torch.bfloat16, torch.bfloat16, True),
    (torch.bfloat16, torch.float32, True)])
@pytest.mark.parametrize("l2,dec", [(0.02, 0.0), (0.0, 0.01)])
def test_fused_adam_matches_plain(card, pdt, mdt, master, l2, dec):
    case = _adam_case(card, (256, 300), pdt, mdt, master)
    kp, kg, ks = _clone(*case)
    pp, pg, ps = _clone(*case)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, l2=l2, decoupled=dec)
    n = FAD.adam_update.LAUNCHES
    FAD.adam_update(kp, kg, ks, 1e-3, 7, None, **kw)
    torch.cuda.synchronize()
    assert FAD.adam_update.LAUNCHES == n + 1
    FAD.adam_update_plain(pp, pg, ps, 1e-3, 7, None, **kw)
    assert FAD.adam_update.LAUNCHES == n + 1
    for got, ref in [(kp, pp)] + [(ks[k], ps[k]) for k in ks]:
        if got.dtype == torch.bfloat16:
            # the same fp32 operations in the same order: at most one bf16
            # ulp apart (chip_smoke.py holds the flagship leaves to the same)
            ulp = torch.finfo(torch.bfloat16).eps * ref.float().abs()
            assert ((got.float() - ref.float()).abs() <= ulp + 1e-30).all()
        else:
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-9)


def test_fused_adam_stochastic_rounding(card):
    """Each stored moment2 is one of the two bf16 neighbours of the fp32
    value, and over a million elements the rounding is unbiased."""
    p, g, slot = _adam_case(card, (1024, 1024), torch.bfloat16,
                            torch.bfloat16, seed=3)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled=0.01)
    exact = {"moment1": slot["moment1"].float(),
             "moment2": slot["moment2"].float()}
    FAD.adam_update_plain(p.clone(), g, exact, 1e-3, 5, None, **kw)
    FAD.adam_update(p, g, slot, 1e-3, 5, (5, 11), **kw)
    m2, x = slot["moment2"].float(), exact["moment2"]
    lo = (x.view(torch.int32) & -65536).view(torch.float32)
    hi = (lo.view(torch.int32) + 65536).view(torch.float32)
    assert ((m2 == lo) | (m2 == hi)).all()
    ulp = (hi - lo).mean().item()
    bias = (m2 - x).mean().item() / ulp
    assert abs(bias) < 0.01, bias            # 5 sigma is ~0.0025 ulp here
    # another seed gives other bits; the same seed the same bits
    p2, g2, slot2 = _adam_case(card, (1024, 1024), torch.bfloat16,
                               torch.bfloat16, seed=3)
    FAD.adam_update(p2, g2, slot2, 1e-3, 5, (5, 11), **kw)
    assert torch.equal(slot2["moment2"], slot["moment2"])


@pytest.mark.parametrize("shape", [(257, 301), (64, 1024)])
def test_fused_adam_tail_and_unaligned_paths(card, shape):
    """A count that is not a multiple of 8 (the tail loop) and a leaf that
    is not 16-byte aligned (one element per thread) give the plain version's
    values with the rounding off, and the aligned path's values, rounding
    words included, with it on."""
    p, g, slot = _adam_case(card, shape, torch.bfloat16, torch.bfloat16,
                            seed=7)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled=0.01)

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    up, ug = unaligned(p), unaligned(g)
    us = {k: unaligned(v) for k, v in slot.items()}
    assert up.data_ptr() % 16 and up.is_contiguous()
    ap, ag, as_ = _clone(p, g, slot)
    FAD.adam_update(ap, ag, as_, 1e-3, 3, (3, 5), **kw)
    FAD.adam_update(up, ug, us, 1e-3, 3, (3, 5), **kw)
    assert torch.equal(ap, up)
    assert all(torch.equal(as_[k], us[k]) for k in as_)
    kp, kg, ks = _clone(p, g, slot)
    pp, pg, ps = _clone(p, g, slot)
    FAD.adam_update(kp, kg, ks, 1e-3, 3, None, **kw)
    FAD.adam_update_plain(pp, pg, ps, 1e-3, 3, None, **kw)
    assert torch.equal(kp, pp)
    assert all(torch.equal(ks[k], ps[k]) for k in ks)


def test_fused_adam_refusals(card):
    p, g, slot = _adam_case(card, (256, 512), torch.float32, torch.float32)
    with pytest.raises(ValueError):
        FAD.adam_update(p.t(), g.t(), {k: v.t() for k, v in slot.items()},
                        1e-3, 1, None, beta1=0.9, beta2=0.999, epsilon=1e-8)
    with pytest.raises(TypeError):
        FAD.adam_update(p.double(), g.double(), slot, 1e-3, 1, None,
                        beta1=0.9, beta2=0.999, epsilon=1e-8)
