"""The port's flashmask rows and sliding window
(``paddle_tpu_torch.kernels.flash_attention`` ``startend_row_indices=`` /
``window=``, and ``nn.functional.flashmask_attention``) against the JAX
package: the Pallas flash kernels with the same operands, run in interpret
mode on the CPU, and the JAX ``flashmask_attention`` (composed on the CPU).

On the CPU the port's wrappers take the kernels' plain PyTorch versions
through ``flash_attention``'s ``torch.autograd.Function``, so these tests
hold what ``chip_smoke.py`` and ``test_torch_flashmask_kernels_cuda.py``
compare the CUDA kernels with on the card to the JAX kernels. Inputs are
made with numpy from a seed and handed to both packages. Tolerances are the
JAX tests' own (``test_pallas_kernels.py`` ``test_flash_attention_window``,
``test_flash_attention_flashmask_rows``, the flashmask goldens): 2e-4 for
the forward, 3e-4 for the q / k / v gradients, fp32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas import flash_attention as JFA
from paddle_tpu_torch.kernels import flash_attention as FA

JNF = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
TNF = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")

FWD_TOL, GRAD_TOL = 2e-4, 3e-4


def _qkv(seed, b, sq, h, d, sk=None, hkv=None):
    rng = np.random.RandomState(seed)
    sk, hkv = sk or sq, hkv or h
    return ((rng.randn(b, sq, h, d) * 0.3).astype(np.float32),
            (rng.randn(b, sk, hkv, d) * 0.3).astype(np.float32),
            rng.randn(b, sk, hkv, d).astype(np.float32),
            rng.randn(b, sq, h, d).astype(np.float32))


def _rows(seed, b, hm, sk, sq, width=64):
    """Random flashmask rows: start in [0, sq), end = start + [1, width)."""
    rng = np.random.RandomState(seed)
    start = rng.randint(0, sq, size=(b, hm, sk)).astype(np.int32)
    end = np.minimum(start + rng.randint(1, width, size=(b, hm, sk)),
                     sq).astype(np.int32)
    return start, end


def _jax(q, k, v, do, causal, **kw):
    """The Pallas kernel in interpret mode: out and the vjp of
    sum(out * dO) in q, k and v."""
    if "startend_row_indices" in kw:
        kw["startend_row_indices"] = tuple(
            jnp.asarray(t) for t in kw["startend_row_indices"])
    for name in ("bias", "q_segment_ids", "kv_segment_ids"):
        if name in kw:
            kw[name] = jnp.asarray(kw[name])

    def f(q_, k_, v_):
        return JFA.flash_attention(q_, k_, v_, causal, None, **kw)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch(q, k, v, do, causal, **kw):
    """The port on the CPU (the plain versions through autograd)."""
    if "startend_row_indices" in kw:
        kw["startend_row_indices"] = tuple(
            torch.from_numpy(t) for t in kw["startend_row_indices"])
    for name in ("bias", "q_segment_ids", "kv_segment_ids"):
        if name in kw:
            kw[name] = torch.from_numpy(kw[name])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = FA.flash_attention(*ts, causal, **kw)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _match(got, want, what=""):
    np.testing.assert_allclose(got[0], want[0], rtol=FWD_TOL, atol=FWD_TOL,
                               err_msg=f"{what} out")
    for name, a, b in zip(("dq", "dk", "dv"), got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# the kernel API against the Pallas kernels
# ---------------------------------------------------------------------------
def _case(name):
    """(q, k, v, dO, causal, kwargs) of one kernel-API case."""
    if name == "window_96":            # test_flash_attention_window
        return (*_qkv(34, 1, 256, 2, 64), True, dict(window=(96, None)))
    if name == "rows_causal":          # test_flash_attention_flashmask_rows
        return (*_qkv(37, 1, 256, 2, 64), True,
                dict(startend_row_indices=_rows(40, 1, 1, 256, 256)))
    if name == "rows_gqa_per_head":    # Hm = H = 4 query heads over 2 kv heads
        return (*_qkv(41, 2, 128, 4, 32, hkv=2), True,
                dict(startend_row_indices=_rows(42, 2, 4, 128, 128)))
    if name == "window_left_right":    # both sides, not causal
        return (*_qkv(43, 2, 128, 2, 32), False, dict(window=(32, 16)))
    if name == "rows_window_rect":     # Sq 128 < Sk 256: rows raw, window aligned
        return (*_qkv(44, 1, 128, 2, 64, sk=256), True,
                dict(startend_row_indices=_rows(45, 1, 1, 256, 128, 40),
                     window=(48, None)))
    if name == "rows_not_causal":
        return (*_qkv(46, 1, 128, 2, 32), False,
                dict(startend_row_indices=_rows(47, 1, 2, 128, 128, 90)))
    if name == "rows_bias":
        rng = np.random.RandomState(48)
        return (*_qkv(49, 1, 128, 2, 32), True,
                dict(startend_row_indices=_rows(50, 1, 1, 128, 128),
                     bias=(rng.randn(1, 2, 128, 128) * 0.5).astype(np.float32)))
    if name == "rows_segments":
        seg = np.repeat(np.array([[0, 1, 2]]), [40, 50, 38], axis=1).astype(
            np.int32)
        return (*_qkv(51, 1, 128, 2, 32), True,
                dict(startend_row_indices=_rows(52, 1, 1, 128, 128),
                     q_segment_ids=seg, kv_segment_ids=seg))
    raise KeyError(name)


KERNEL_CASES = ["window_96", "rows_causal", "rows_gqa_per_head",
                "window_left_right", "rows_window_rect", "rows_not_causal",
                "rows_bias", "rows_segments"]


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_api_matches_jax(name):
    q, k, v, do, causal, kw = _case(name)
    _match(_torch(q, k, v, do, causal, **dict(kw)),
           _jax(q, k, v, do, causal, **dict(kw)), name)


def test_dead_rows_give_zeros_like_jax():
    """C = 1 rows with start[j] = j under causal masking leave no key to
    any query: zeros, lse -1e30 and no gradient, with no NaN; with half the
    columns opened (start = S), the live rows still match JAX."""
    q, k, v, do = _qkv(53, 1, 128, 2, 32)
    start = np.tile(np.arange(128, dtype=np.int32), (1, 1, 1))
    end = np.full_like(start, 128)
    got = _torch(q, k, v, do, True, startend_row_indices=(start, end))
    assert not np.abs(got[0]).any() and all(not np.abs(g).any()
                                            for g in got[1])
    _match(got, _jax(q, k, v, do, True, startend_row_indices=(start, end)))
    _, lse = FA.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)), True,
                          0.1, fm=(torch.from_numpy(start),
                                   torch.from_numpy(end)))
    assert bool((lse == -1e30).all())
    start[..., ::2] = 128                          # every other key opens
    _match(_torch(q, k, v, do, True, startend_row_indices=(start, end)),
           _jax(q, k, v, do, True, startend_row_indices=(start, end)))


@pytest.mark.parametrize("window,want", [
    ((4, -1), (4, None)), ((-1, -2), None), ((None, None), None),
    ((None, 3), (None, 3)), (None, None)])
def test_window_normalized_like_jax(window, want):
    assert FA._norm_window(window) == want


def test_rows_take_int64_and_give_no_gradient():
    q, k, v, do = _qkv(54, 1, 64, 2, 16)
    start, end = _rows(55, 1, 2, 64, 64)
    rows = tuple(torch.from_numpy(t).long() for t in (start, end))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = FA.flash_attention(*ts, True, startend_row_indices=rows)
    ref = _torch(q, k, v, do, True, startend_row_indices=(start, end))[0]
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    out.backward(torch.from_numpy(do))
    assert all(t.grad is not None for t in ts)
    assert not any(r.requires_grad for r in rows)


@pytest.mark.parametrize("rows,match", [
    (lambda s, e: (s[:, :, :10], e[:, :, :10]), "rows must be integer"),
    (lambda s, e: (s.float(), e), "rows must be integer"),
    (lambda s, e: (s.repeat(1, 3, 1), e.repeat(1, 3, 1)),
     "rows must be integer"),
    (lambda s, e: (s, e.repeat(1, 2, 1)), "differ")],
    ids=["short", "float", "three_heads", "start_end_heads_differ"])
def test_kernel_rows_refused(rows, match):
    q = torch.zeros(1, 64, 2, 16)
    start, end = (torch.from_numpy(t) for t in _rows(56, 1, 1, 64, 64))
    with pytest.raises(ValueError, match=match):
        FA.flash_attention(q, q, q, True,
                           startend_row_indices=rows(start, end))


# ---------------------------------------------------------------------------
# nn.functional.flashmask_attention against the JAX op
# ---------------------------------------------------------------------------
def _fm_idx(seed, b, hm, s, C, causal):
    """startend_row_indices [b, hm, s, C] as the JAX goldens draw them."""
    rng = np.random.RandomState(seed)
    r1 = rng.randint(0 if causal or C != 2 else 1, s, size=(b, hm, s, 1))
    if C == 1:
        return r1.astype(np.int32)
    if C == 2 and not causal:
        return np.concatenate([r1, rng.randint(0, s, size=r1.shape)],
                              -1).astype(np.int32)
    r2 = np.minimum(r1 + rng.randint(1, 8, size=r1.shape), s)
    if C == 2:
        return np.concatenate([r1, r2], -1).astype(np.int32)
    r3 = rng.randint(0, s, size=r1.shape)
    r4 = np.minimum(r3 + rng.randint(1, 8, size=r1.shape), s)
    return np.concatenate([r1, r2, r3, r4], -1).astype(np.int32)


def _op_pair(q, k, v, do, **kw):
    """(port, JAX) flashmask_attention: out and the q / k / v gradients."""
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("startend_row_indices") is not None:
        jkw["startend_row_indices"] = jnp.asarray(kw["startend_row_indices"])
        tkw["startend_row_indices"] = torch.from_numpy(
            kw["startend_row_indices"])

    def f(q_, k_, v_):
        return JNF.flashmask_attention(q_, k_, v_, **jkw)[0]
    out_j, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = (np.asarray(out_j), [np.asarray(g) for g in vjp(jnp.asarray(do))])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = TNF.flashmask_attention(*ts, **tkw)[0]
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    return (out.detach().numpy(), [g.numpy() for g in grads]), want


@pytest.mark.parametrize("C,causal,hm", [(1, True, 1), (2, True, 1),
                                         (2, True, 2), (2, False, 1),
                                         (4, False, 1), (1, False, 2)])
def test_flashmask_attention_matches_jax(C, causal, hm):
    q, k, v, do = _qkv(60 + C, 1, 32, 2, 16)
    idx = _fm_idx(61 + C, 1, hm, 32, C, causal)
    got, want = _op_pair(q, k, v, do, startend_row_indices=idx,
                         causal=causal)
    _match(got, want, f"C={C} causal={causal}")


def test_flashmask_window_rectangular_alignment():
    """Sq 128, Sk 256, w 32 (test_flashmask_window_rectangular_alignment):
    the window is bottom-right aligned on both packages."""
    q, k, v, do = _qkv(73, 1, 128, 2, 64, sk=256)
    got, want = _op_pair(q, k, v, do, causal=True, window_size=32)
    _match(got, want, "window")
    got2, _ = _op_pair(q, k, v, do, causal=True, window_size=(32, 7))
    np.testing.assert_array_equal(got2[0], got[0])


@pytest.mark.parametrize("C", [1, 2])
def test_kernel_route_equals_dense_route(C):
    """On the CPU the op composes the dense mask; the causal C 1 / 2 forms
    go to the kernels' rows on the card (start = r1, end = r2 or S): both
    give the same attention, with GQA and a window."""
    q, k, v, do = _qkv(80 + C, 2, 96, 4, 16, hkv=2)
    idx = _fm_idx(82 + C, 2, 4, 96, C, True)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    dense = TNF.flashmask_attention(*ts, torch.from_numpy(idx), causal=True,
                                    window_size=40)[0]
    start = torch.from_numpy(idx[..., 0])
    end = (torch.from_numpy(idx[..., 1]) if C == 2
           else torch.full_like(start, 96))
    rows = FA.flash_attention(*ts, True, startend_row_indices=(start, end),
                              window=(40, None))
    torch.testing.assert_close(rows, dense, rtol=1e-5, atol=1e-5)


def test_flashmask_routes_and_counters():
    """The route by device and shape (meta tensors stand for the card's):
    the kernels for no rows and the causal C 1 / 2 forms, the counted
    dense mask for the bidirectional forms, the counted composed path for
    D > 256, and the CPU composes without a count."""
    route = TNF._flashmask_route
    q = torch.empty(1, 8, 2, 64, device="meta")
    idx = {c: torch.empty(1, 1, 8, c, device="meta") for c in (1, 2, 4)}
    TNF.flashmask_attention.DENSE_MASK = 0
    TNF.scaled_dot_product_attention.COMPOSED = 0
    assert route(q, None, False) == "kernels"
    assert route(q, None, True) == "kernels"
    assert route(q, idx[1], True) == route(q, idx[2], True) == "kernels"
    assert TNF.flashmask_attention.DENSE_MASK == 0
    assert route(q, idx[2], False) == route(q, idx[4], False) == "dense"
    assert route(q, idx[1], False) == route(q, idx[4], True) == "dense"
    assert TNF.flashmask_attention.DENSE_MASK == 4
    assert route(torch.empty(1, 8, 2, 320, device="meta"), idx[1],
                 True) == "composed"
    assert TNF.scaled_dot_product_attention.COMPOSED == 1
    assert route(torch.zeros(1, 8, 2, 64), idx[1], True) == "composed"
    assert TNF.flashmask_attention.DENSE_MASK == 4
    assert TNF.scaled_dot_product_attention.COMPOSED == 1


@pytest.mark.parametrize("shape,err", [((1, 1, 32, 3), "1, 2 or 4"),
                                       ((1, 3, 32, 2), "does not fit"),
                                       ((1, 1, 31, 1), "does not fit"),
                                       ((1, 32, 1), "must be")])
def test_flashmask_argument_errors(shape, err):
    """C = 3 and a mismatched H_mask (or key length) raise on both
    packages; the port's errors are ValueErrors."""
    q, k, v, _ = _qkv(90, 1, 32, 2, 16)
    idx = np.zeros(shape, np.int32)
    with pytest.raises(ValueError, match=err):
        TNF.flashmask_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(idx), causal=True)
    if len(shape) == 4:
        with pytest.raises(Exception):
            out = JNF.flashmask_attention(
                *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(idx),
                causal=True)[0]
            jax.block_until_ready(out)
