"""The flashmask rows and the sliding window in the flash kernels on the
card: the forward, dQ and dK/dV kernels with causal C = 1 rows (a document
mask), C = 2 rows with H_mask 1 and H, the window alone (causal and not),
``(left, right)``, the window with rows, rows with a bias, with segment ids
and with dropout (the Philox mask shared with the plain version), the
d-bias with rows, dead rows and Sq != Sk, in fp32, bf16 and fp16 at D 64,
128 and 256, each against its plain PyTorch version on the same inputs; the
C entries' refusals; and ``nn.functional.flashmask_attention``'s routes,
launch counts and card-vs-CPU agreement.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest tests/test_torch_flashmask_kernels_cuda.py --noconftest -q
"""

import ctypes
import importlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as FA

TNF = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")

pytestmark = pytest.mark.cuda

# flash (out, grads) on the worst 64-row tile's ||got - ref|| / ||ref||, as
# chip_smoke.py phase 28: fp32 summation order; 16-bit rounding of the
# outputs and of the tensor-core operands (fp16 held to the bf16 tier)
FLASH_TOL = {torch.float32: 5e-6, torch.bfloat16: 2e-2, torch.float16: 2e-2}
FWD_KEYS = ("bias", "q_seg", "kv_seg", "dropout_p", "seed", "fm", "window")


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


def _doc_rows(B, S, seed, lo=16, hi=97):
    """A causal document mask as C = 1 rows [B, 1, S]: start[j] = the end
    of the document holding key j (lengths from RandomState(seed), the last
    cut to fit), so a query sees only its own document's earlier keys."""
    rng = np.random.RandomState(seed)
    rows = np.zeros((B, 1, S), np.int32)
    for b in range(B):
        pos = 0
        while pos < S:
            n = min(rng.randint(lo, hi), S - pos)
            rows[b, 0, pos:pos + n] = pos + n
            pos += n
    return torch.from_numpy(rows)


def _band_rows(B, hm, Sk, Sq, seed, width=64):
    rng = np.random.RandomState(seed)
    start = rng.randint(0, Sq, size=(B, hm, Sk))
    end = np.minimum(start + rng.randint(1, width, size=start.shape), Sq)
    return (torch.from_numpy(start.astype(np.int32)),
            torch.from_numpy(end.astype(np.int32)))


def _forms(dev, dtype, D, seed=0):
    """(name, q, k, v, dO, causal, variant) of every form at B 2, S 256,
    GQA 4 / 2 (and Sq 128 / Sk 256)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)
    B, S, H, Hkv = 2, 256, 4, 2
    q, do, k, v = rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, Hkv, D), \
        rnd(B, S, Hkv, D)
    doc = _doc_rows(B, S, seed + 1).to(dev)
    full = torch.full_like(doc, S)
    st, en = (t.to(dev) for t in _band_rows(B, H, S, S, seed + 2))
    seg = torch.from_numpy(np.repeat(np.arange(4), [60, 70, 90, 36])[None]
                           .repeat(B, 0).astype(np.int32)).to(dev)
    rs, re_ = (t.to(dev) for t in _band_rows(B, 1, S, 128, seed + 3, 40))
    return [
        ("c1_causal_doc", q, k, v, do, True, dict(fm=(doc, full))),
        ("c2_causal_hm1", q, k, v, do, True, dict(fm=(st[:, :1], en[:, :1]))),
        ("c2_causal_hmH", q, k, v, do, True, dict(fm=(st, en))),
        ("window_causal", q, k, v, do, True, dict(window=(96, None))),
        ("window_not_causal", q, k, v, do, False, dict(window=(96, None))),
        ("window_left_right", q, k, v, do, False, dict(window=(40, 24))),
        ("rows_window", q, k, v, do, True,
         dict(fm=(doc, full), window=(80, None))),
        ("rows_bias", q, k, v, do, True,
         dict(fm=(st, en), bias=rnd(B, 1, S, S))),
        ("rows_segments", q, k, v, do, True,
         dict(fm=(st[:, :1], en[:, :1]), q_seg=seg, kv_seg=seg)),
        ("rows_dropout", q, k, v, do, True,
         dict(fm=(doc, full), dropout_p=0.1, seed=2 ** 33 + 7)),
        ("rows_window_rect", q[:, :128], k, v, do[:, :128], True,
         dict(fm=(rs, re_), window=(48, None))),
        ("dead_rows", q, k, v, do, True,
         dict(fm=(torch.arange(S, device=dev, dtype=torch.int32)
                  .expand(B, 1, S).contiguous(), full)))]


def _check(q, k, v, do, causal, var, bias_grad=False):
    """Kernels vs plain: lse and dead rows, out, dq, dk, dv (and the
    d-bias); returns the kernels' (out, lse, dq, dk, dv)."""
    tol = FLASH_TOL[q.dtype]
    scale = q.shape[-1] ** -0.5
    fwd = {n: var[n] for n in FWD_KEYS if n in var}
    out, lse = FA.flash_fwd(q, k, v, causal, scale, **fwd)
    grads = FA.flash_bwd(q, k, v, lse, do, causal, scale, bias_grad=bias_grad,
                         **var)
    torch.cuda.synchronize()
    out_p, lse_p = FA.flash_fwd_plain(q, k, v, causal, scale, **fwd)
    ref = FA.flash_bwd_plain(q, k, v, lse, do, causal, scale,
                             bias_grad=bias_grad, **var)
    live = lse_p > -1e29
    assert torch.equal(live, lse > -1e29)
    if live.any():
        assert ((lse - lse_p).abs()[live].max()
                <= 1e-5 * lse_p.abs()[live].max().clamp_min(1.0)).item()
    assert bool((lse[~live] == -1e30).all())
    assert (out.transpose(1, 2)[~live] == 0).all()        # dead rows
    assert _tile_rel(out, out_p) <= tol
    for got, want in zip(grads[:3], ref[:3]):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.isfinite(got.float()).all()
        assert _tile_rel(got, want) <= tol
    assert (grads[0].transpose(1, 2)[~live] == 0).all()   # no dq there
    if bias_grad:
        db, want = grads[3], ref[3]
        assert db.shape == var["bias"].shape
        assert ((db.float() - want.float()).norm()
                / want.float().norm().clamp_min(1e-30)).item() <= tol
    return out, lse, grads


FORMS = ["c1_causal_doc", "c2_causal_hm1", "c2_causal_hmH", "window_causal",
         "window_not_causal", "window_left_right", "rows_window", "rows_bias",
         "rows_segments", "rows_dropout", "rows_window_rect", "dead_rows"]


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("form", FORMS)
def test_forms_match_plain(card, form, dtype, D):
    name, q, k, v, do, causal, var = next(
        f for f in _forms(card, dtype, D, seed=D) if f[0] == form)
    out, lse, _ = _check(q, k, v, do, causal, var)
    if name == "dead_rows":
        assert not out.any() and bool((lse == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dbias_with_rows(card, dtype):
    _, q, k, v, do, causal, var = _forms(card, dtype, 64)[7]   # rows_bias
    _check(q, k, v, do, causal, var, bias_grad=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_mask_is_shared_with_rows(card, dtype):
    """q = k = 0 makes every visible probability equal; v = I reads the
    dropped row out of the forward and dO = I reads it out of dK/dV's dV:
    both are the plain keep-mask on the pairs the rows and the window
    leave, bit for bit."""
    B, S, H, p, seed = 2, 128, 2, 0.1, 2 ** 40 + 777
    z = torch.zeros(B, S, H, S, device=card, dtype=dtype)
    eye = torch.eye(S, device=card, dtype=dtype)[None, :, None, :].expand(
        B, S, H, S).contiguous()
    fm = (_doc_rows(B, S, 5).to(card), torch.full((B, 1, S), S,
                                                  dtype=torch.int32,
                                                  device=card))
    var = dict(fm=fm, window=(70, None), dropout_p=p, seed=seed)
    out, lse = FA.flash_fwd(z, z, eye, True, 1.0, **var)
    _, dv = FA.flash_bwd_dkv(z, z, eye, lse, torch.zeros_like(lse), eye,
                             True, 1.0, **var)
    ok = FA._visible(S, S, True, card, fm=fm, window=(70, None))
    keep = FA.dropout_keep_mask(seed, B, H, S, S, p, card) & ok
    assert torch.equal(out.permute(0, 2, 1, 3) > 0, keep)
    assert torch.equal(dv.permute(0, 2, 3, 1) > 0, keep)


def _fwd_entry(q, fms, fme, fm_hs):
    from paddle_tpu_torch.kernels._build import load_library
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1], device=q.device)
    strides = (ctypes.c_longlong * 13)(*(list(q.stride()[:3]) * 3 + [0] * 4))
    return load_library().ptt_flash_fwd(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), None, None, None, fms, fme,
        out.data_ptr(), lse.data_ptr(), strides, 1, 64, 64, 2, 2, 64, 0.1, 1,
        0, 0, 0, 0, 1.0, 1, 0, fm_hs, -1, -1,
        torch.cuda.current_stream().cuda_stream)


def test_entry_refusals(card):
    """The C entry refuses one flashmask array without the other and a
    head stride other than 0 and Sk (cudaErrorInvalidValue, 1); the
    wrapper refuses rows of the wrong shape."""
    q = torch.zeros(1, 64, 2, 64, device=card, dtype=torch.bfloat16)
    rows = torch.zeros(1, 2, 64, device=card, dtype=torch.int32)
    assert _fwd_entry(q, rows.data_ptr(), rows.data_ptr(), 64) == 0
    assert _fwd_entry(q, rows.data_ptr(), None, 0) == 1
    assert _fwd_entry(q, rows.data_ptr(), rows.data_ptr(), 32) == 1
    with pytest.raises(ValueError, match="rows must be integer"):
        FA.flash_fwd(q, q, q, True, 0.1, fm=(rows[:, :, :8], rows[:, :, :8]))


def test_flashmask_attention_routes_and_launches(card):
    """The op on the card: causal C = 1 / 2 rows and a window launch the
    three kernels once each per forward and backward (COMPOSED and
    DENSE_MASK unchanged); the bidirectional C = 2 / 4 forms take the
    counted dense mask into the bias kernels; a tiny fp32 case agrees with
    the CPU (the composed path) in out and the q / k / v gradients."""
    gen = torch.Generator().manual_seed(3)
    B, S, H, Hkv, D = 2, 192, 4, 2, 32
    host = [torch.randn(B, S, h, D, generator=gen) for h in (H, Hkv, Hkv)]
    do = torch.randn(B, S, H, D, generator=gen)
    doc = _doc_rows(B, S, 9)[..., None]
    rng = np.random.RandomState(4)
    r1 = rng.randint(0, S, size=(B, H, S, 1))
    c2 = np.concatenate([r1, np.minimum(r1 + 30, S)], -1).astype(np.int32)
    c4 = np.concatenate([c2, c2[..., ::-1]], -1).copy()
    cases = [(doc, True, None), (torch.from_numpy(c2), True, 50),
             (None, True, 64), (None, False, (48, 3)),
             (torch.from_numpy(c2), False, None),
             (torch.from_numpy(c4), False, 40)]
    for idx, causal, w in cases:
        results = []
        for dev in ("cpu", card):
            ts = [t.to(dev).requires_grad_(True) for t in host]
            n = (FA.flash_fwd.LAUNCHES, FA.flash_bwd_dq.LAUNCHES,
                 FA.flash_bwd_dkv.LAUNCHES, TNF.flashmask_attention.DENSE_MASK,
                 TNF.scaled_dot_product_attention.COMPOSED)
            out = TNF.flashmask_attention(
                *ts, None if idx is None else idx.to(dev), causal=causal,
                window_size=w)[0]
            grads = torch.autograd.grad(out, ts, do.to(dev))
            torch.cuda.synchronize()
            got = (FA.flash_fwd.LAUNCHES - n[0], FA.flash_bwd_dq.LAUNCHES
                   - n[1], FA.flash_bwd_dkv.LAUNCHES - n[2],
                   TNF.flashmask_attention.DENSE_MASK - n[3],
                   TNF.scaled_dot_product_attention.COMPOSED - n[4])
            dense = idx is not None and not causal
            want = ((0,) * 5 if dev == "cpu"
                    else (1, 1, 1, int(dense), 0))
            assert got == want, (dev, idx is None, causal, w, got)
            results.append([out.detach().cpu()] + [g.cpu() for g in grads])
        for a, b in zip(*results):           # fp32 summation order
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
