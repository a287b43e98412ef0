"""The LayerNorm forward and backward and the RMSNorm forward as redesigned
for Hopper, on the card, each against its plain PyTorch version on the same
inputs.

* The LayerNorm forward (``csrc/layer_norm.cu``): the held row's persistent
  grid (the weight and bias in registers or in shared memory) and the walk,
  on every route ``layer_norm.fwd_plan`` can take, with and without a bias,
  in the three dtypes, at the timed shapes ([8192, 2048] and [5120, 768])
  and the held row's width edges (16-bit H 1536 / 1544 and 2048 / 2056, fp32
  H 1024 / 1028) at row counts that are no multiple of the grid's warps.
  The held row sums in the walk's order: against the walk kernel on the
  same values (a weight off a 16-byte boundary sends the call to the walk
  with x's 16-byte loads) its mean and rstd are held bit for bit.

* The LayerNorm backward with dw and db summed in the kernel
  (``csrc/layer_norm.cu``, one cooperative launch): every route
  ``layer_norm.bwd_plan`` can take (the held row, the column-tiled partial,
  the dx-only kernel), with and without a bias, a frozen weight and a frozen
  x, in fp32, bf16 and fp16, at 1, 13, 37 and 5120 rows; the same bits from
  two calls, from twenty calls in a row, and from a call on a fresh stream
  right after another (a stale arrival counter would hang or change them).
* The RMSNorm forward (``csrc/rms_norm.cu``): the held row's persistent
  grid and the walk, on every route ``rms_norm.fwd_plan`` can take, in the
  three dtypes at 1, 13, 37 and 8192 rows.

Tolerance: max-abs error over the plain version's max-abs, 1e-2 for a
16-bit output, 1e-5 for fp32; dw and db, fp32 sums of the same products on
both sides (the plain version given the kernel's statistics), 1e-5 whatever
x's dtype; rstd 1e-5 relative.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_norm_hopper_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import layer_norm as LN
from paddle_tpu_torch.kernels import rms_norm as RN

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
SUM_TOL = 1e-5      # dw, db: fp32 sums in another order, whatever x's dtype
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
DT_IDS = ("fp32", "bf16", "fp16")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / max(b.float().abs().max().item(), 1e-30)).item()


def _held(H, dtype):
    """The held row's gate: whole 16-byte words, at most 8 a lane."""
    n = 16 // torch.tensor([], dtype=dtype).element_size()
    return H % n == 0 and H // n <= 32 * 8


def _rows(card, rows, H, dtype, seed=0):
    rng = np.random.RandomState(seed + rows + H)
    t = lambda a, dt=dtype: torch.from_numpy(a.astype(np.float32)).to(card, dt)
    x = t(rng.randn(rows, H) * 3.0 + 1.0)
    w = t(rng.randn(H), torch.float32)
    b = t(rng.randn(H), torch.float32)
    dy = t(rng.randn(rows, H))
    return x, w, b, dy


# ---------------------------------------------------------------------------
# the LayerNorm backward with dw and db in the kernel
# ---------------------------------------------------------------------------
LN_SHAPES = [(1, 768), (13, 768), (37, 768), (5120, 768), (9, 1024),
             (37, 2048), (13, 100), (37, 4100), (3, 28680), (300, 28680)]


def _ln_check(card, x, w, b, dy, need_dx=True, need_dw=True):
    """Run the backward twice, hold it to the plain version, return the
    plan and the outputs."""
    has_bias = b is not None
    _, mean, rstd = LN.layer_norm_fwd(x, w, b, 1e-5)
    plan = LN.bwd_plan(x, w, dy, need_dw=need_dw, need_db=has_bias)
    n, routes = LN.layer_norm_bwd.LAUNCHES, dict(LN.layer_norm_bwd.ROUTES)
    kw = dict(need_dx=need_dx, need_dw=need_dw, need_db=has_bias)
    first = LN.layer_norm_bwd(x, w, mean, rstd, dy, **kw)
    second = LN.layer_norm_bwd(x, w, mean, rstd, dy, **kw)
    torch.cuda.synchronize()
    assert LN.layer_norm_bwd.LAUNCHES == n + 2
    assert LN.layer_norm_bwd.ROUTES[plan["path"]] == routes[plan["path"]] + 2
    for u, v in zip(first, second):
        assert (u is None and v is None) or torch.equal(u, v)
    # the plain version on the kernel's statistics: only the order of the
    # sums differs
    dx_p, dw_p, db_p = LN.layer_norm_bwd_plain(x, w, mean, rstd, dy, has_bias,
                                               need_dx, need_dw)
    for got, ref, tol in zip(first, (dx_p, dw_p, db_p),
                             (TOL[x.dtype], SUM_TOL, SUM_TOL)):
        assert (got is None) == (ref is None)
        if got is not None:
            assert got.dtype == ref.dtype and got.shape == ref.shape
            assert torch.isfinite(got.float()).all()
            assert _rel(got, ref) <= tol, _rel(got, ref)
    return plan, first


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("rows,H", LN_SHAPES,
                         ids=[f"{r}x{h}" for r, h in LN_SHAPES])
def test_ln_backward_dx_dw_db_in_one_launch(card, rows, H, dtype, bias):
    x, w, b, dy = _rows(card, rows, H, dtype)
    plan, _ = _ln_check(card, x, w, b if bias else None, dy)
    assert plan["path"] == ("held" if _held(H, dtype) else "tiled"), plan
    assert 1 <= plan["blocks"] <= max(1, rows)


@pytest.mark.parametrize("case", ["frozen-weight", "frozen-weight-bias",
                                  "frozen-x", "frozen-x-bias"])
def test_ln_backward_frozen_weight_or_x(card, case):
    """Through the autograd Function: one launch, on the route the need
    flags pick (the dx-only kernel when no sum is asked for), with only the
    gradients asked for formed."""
    x, w, b, dy = _rows(card, 64, 768, torch.bfloat16)
    bias = case.endswith("bias")
    xr = x.clone().requires_grad_(case.startswith("frozen-weight"))
    wr = w.clone().requires_grad_(case.startswith("frozen-x"))
    br = b.clone().requires_grad_(True) if bias else None
    targets = [t for t in (xr, wr, br) if t is not None and t.requires_grad]
    n, routes = LN.layer_norm_bwd.LAUNCHES, dict(LN.layer_norm_bwd.ROUTES)
    got = torch.autograd.grad(LN.layer_norm(xr, wr, br, 1e-5), targets, dy)
    torch.cuda.synchronize()
    want = "dx-only" if case == "frozen-weight" else "held"
    assert LN.layer_norm_bwd.LAUNCHES == n + 1
    assert LN.layer_norm_bwd.ROUTES[want] == routes[want] + 1
    _, mean, rstd = LN.layer_norm_fwd(x, w, b if bias else None, 1e-5)
    dx_p, dw_p, db_p = LN.layer_norm_bwd_plain(x, w, mean, rstd, dy, bias)
    refs = ([(dx_p, TOL[torch.bfloat16])] if xr.requires_grad else []) + \
        ([(dw_p, SUM_TOL)] if wr.requires_grad else []) + \
        ([(db_p, SUM_TOL)] if bias else [])
    assert len(got) == len(refs)
    for g, (ref, tol) in zip(got, refs):
        assert g.shape == ref.shape and _rel(g, ref) <= tol


@pytest.mark.parametrize("H", [768, 4100])
def test_ln_backward_frozen_x_writes_no_dx(card, H):
    x, w, b, dy = _rows(card, 37, H, torch.bfloat16)
    _, (dx, dw, db) = _ln_check(card, x, w, b, dy, need_dx=False)
    assert dx is None and dw is not None and db is not None


def test_ln_backward_repeats_and_a_fresh_stream(card):
    """Twenty calls in a row on one stream, then one on a new stream right
    after them: every call gives the first call's bits (the grid barrier's
    counters are back at 0 after each call, and a new stream has its own)."""
    x, w, b, dy = _rows(card, 5120, 768, torch.bfloat16)
    _, mean, rstd = LN.layer_norm_fwd(x, w, b, 1e-5)
    ref = LN.layer_norm_bwd(x, w, mean, rstd, dy)
    outs = [LN.layer_norm_bwd(x, w, mean, rstd, dy) for _ in range(20)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fresh = LN.layer_norm_bwd(x, w, mean, rstd, dy)
    torch.cuda.synchronize()
    for out in outs + [fresh]:
        assert all(torch.equal(u, v) for u, v in zip(out, ref))


def test_ln_backward_unaligned_rows(card):
    """A row base that is not 16-byte aligned takes the column-tiled
    partial with one element a thread."""
    H = 768
    big = torch.randn(65 * H + 3, device=card)
    x = big[3:].view(65, H)
    assert x.data_ptr() % 16
    _, w, b, dy = _rows(card, 65, H, torch.float32)
    plan, _ = _ln_check(card, x, w, b, dy)
    assert plan["path"] == "tiled"


# ---------------------------------------------------------------------------
# the LayerNorm forward
# ---------------------------------------------------------------------------
LN_FWD_SHAPES = [(8192, 2048), (5120, 768), (1, 2048), (13, 2056),
                 (37, 1536), (37, 1544), (37, 1024), (13, 1028), (5, 100),
                 (1, 8)]


def _misaligned(t):
    """A copy of the 1-D fp32 ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = flat[1:t.numel() + 1]
    view.copy_(t)
    assert view.data_ptr() % 16
    return view


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("rows,H", LN_FWD_SHAPES,
                         ids=[f"{r}x{h}" for r, h in LN_FWD_SHAPES])
def test_ln_forward_held_and_walk_match_plain(card, rows, H, dtype, bias):
    x, w, b, _ = _rows(card, rows, H, dtype)
    b = b if bias else None
    plan = LN.fwd_plan(x, w, b)
    assert plan["path"] == ("held" if _held(H, dtype) else "walk"), plan
    assert 1 <= plan["blocks"] <= max(1, rows)
    n = LN.layer_norm_fwd.LAUNCHES
    y, mean, rstd = LN.layer_norm_fwd(x, w, b, 1e-5)
    again = LN.layer_norm_fwd(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert LN.layer_norm_fwd.LAUNCHES == n + 2
    assert all(torch.equal(u, v) for u, v in zip((y, mean, rstd), again))
    y_p, mean_p, rstd_p = LN.layer_norm_fwd_plain(x, w, b, 1e-5)
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    assert _rel(y, y_p) <= TOL[dtype], _rel(y, y_p)
    scale = max(mean_p.abs().max().item(), 1.0)
    assert (mean - mean_p).abs().max().item() <= 1e-5 * scale
    assert ((rstd - rstd_p).abs() / rstd_p).max().item() <= 1e-5
    if plan["path"] == "held":
        # the walk kernel on the same values, with x's 16-byte loads
        w_off = _misaligned(w)
        assert LN.fwd_plan(x, w_off, b)["path"] == "walk"
        y_w, mean_w, rstd_w = LN.layer_norm_fwd(x, w_off, b, 1e-5)
        assert torch.equal(mean, mean_w) and torch.equal(rstd, rstd_w)
        assert _rel(y, y_w) <= TOL[dtype]


def test_ln_forward_unaligned_rows_walk(card):
    H = 2048
    big = torch.randn(37 * H + 3, device=card).to(torch.bfloat16)
    x = big[3:].view(37, H)
    assert x.data_ptr() % 16
    _, w, b, _ = _rows(card, 37, H, torch.float32)
    assert LN.fwd_plan(x, w, b)["path"] == "walk"
    y, _, _ = LN.layer_norm_fwd(x, w, b, 1e-6)
    y_p, _, _ = LN.layer_norm_fwd_plain(x, w, b, 1e-6)
    assert _rel(y, y_p) <= TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# the RMSNorm forward
# ---------------------------------------------------------------------------
RMS_SHAPES = [(1, 2048), (13, 2048), (37, 2048), (8192, 2048), (5, 768),
              (8192, 256), (1, 4096), (4096, 4096), (37, 100), (13, 4095)]


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("rows,H", RMS_SHAPES,
                         ids=[f"{r}x{h}" for r, h in RMS_SHAPES])
def test_rms_forward_matches_plain(card, rows, H, dtype):
    x, w, _, _ = _rows(card, rows, H, dtype)
    plan = RN.fwd_plan(x, w)
    assert plan["path"] == ("held" if _held(H, dtype) else "walk"), plan
    assert 1 <= plan["blocks"] <= max(1, rows)
    n = RN.rms_norm_fwd.LAUNCHES
    y, rstd = RN.rms_norm_fwd(x, w, 1e-5)
    y2, rstd2 = RN.rms_norm_fwd(x, w, 1e-5)
    torch.cuda.synchronize()
    assert RN.rms_norm_fwd.LAUNCHES == n + 2
    assert torch.equal(y, y2) and torch.equal(rstd, rstd2)
    y_p, rstd_p = RN.rms_norm_fwd_plain(x, w, 1e-5)
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    assert _rel(y, y_p) <= TOL[dtype], _rel(y, y_p)
    assert ((rstd - rstd_p).abs() / rstd_p).max().item() <= 1e-5


def test_rms_forward_unaligned_rows_walk(card):
    H = 2048
    big = torch.randn(37 * H + 3, device=card).to(torch.bfloat16)
    x = big[3:].view(37, H)
    assert x.data_ptr() % 16
    w = torch.randn(H, device=card)
    assert RN.fwd_plan(x, w)["path"] == "walk"
    y, _ = RN.rms_norm_fwd(x, w, 1e-6)
    y_p, _ = RN.rms_norm_fwd_plain(x, w, 1e-6)
    assert _rel(y, y_p) <= TOL[torch.bfloat16]
