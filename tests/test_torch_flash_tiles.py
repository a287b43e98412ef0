"""The port's flash forward and dQ (out, lse, dq, delta), run on the CPU
through their plain versions, against the JAX package's Pallas kernels in
interpret mode, at the edges of the tiles of the card's 16-bit forward and
dQ kernels (128 query rows a block; key tiles of 128 and 64): sequence
lengths 127, 128, 129, 255 and 257 mixed, causal with Sq < Sk and with dead
rows, windows across a 128 boundary, GQA 8/2, segment boundaries at 127 and
129, document flashmask rows across tiles. Inputs come from numpy with a
seed and go to both packages; the JAX dq comes from its backward kernels,
its delta from rowsum(dO * O) of its output (the port's from rowsum(p dP)).
Tolerances are those of ``test_torch_flash_attention.py`` in fp32: 2e-5 on
out, 2e-4 on the gradients, relative to their max-abs. Also the wrapper's
copy of a 16-bit view broadcast over a dim (its TMA tensor maps take no
zero stride). The CUDA kernels are held to these plain versions on the
card by ``test_torch_flash_hopper_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas import flash_attention as JFA
from paddle_tpu_torch.kernels import flash_attention as FA

TOL_OUT, TOL_GRAD = 2e-5, 2e-4


def _segments(S, cuts):
    ids = np.zeros((1, S), np.int32)
    for c in cuts:
        ids[0, c:] += 1
    return ids


def _doc_rows(S, lens):
    """C = 1 causal document rows [1, 1, S]: start[j] = the end of the
    document that holds key j; end = S."""
    start, pos = np.zeros((1, 1, S), np.int32), 0
    for n in lens:
        start[0, 0, pos:pos + n] = pos + n
        pos += n
    return start, np.full_like(start, S)


# sq, sk, H, Hkv, causal, window, segment cuts, document lengths, JAX block
CASES = {
    "causal-127x257-gqa-8-2": (127, 257, 8, 2, True, None, None, None, None),
    "causal-257x128-dead-rows": (257, 128, 2, 2, True, None, None, None, None),
    "window-129x255-across-128": (129, 255, 2, 2, False, (100, 30), None,
                                  None, None),
    "causal-window-255-gqa-2-1": (255, 255, 2, 1, True, (130, None), None,
                                  None, None),
    "segments-cut-at-127-129": (256, 256, 2, 2, False, None, (127, 129),
                                None, 128),
    "document-rows-across-tiles": (256, 256, 2, 2, True, None, None,
                                   (100, 60, 96), 128),
}


def _close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_fwd_dq_match_jax_at_tile_edges(case):
    sq, sk, H, Hkv, causal, window, cuts, docs, block = CASES[case]
    D = 16
    rng = np.random.RandomState(sq + 3 * sk + H)
    q, k, v, do = (rng.randn(*s).astype(np.float32)
                   for s in ((1, sq, H, D), (1, sk, Hkv, D), (1, sk, Hkv, D),
                             (1, sq, H, D)))
    seg = None if cuts is None else _segments(sq, cuts)
    fm = None if docs is None else _doc_rows(sk, docs)
    scale = 1.0 / np.sqrt(D)
    bq, bk = block or sq, block or sk
    jseg = None if seg is None else jnp.asarray(seg)
    extras = None if fm is None else (None, *map(jnp.asarray, fm))
    out_j, res = JFA._flash_fwd(*map(jnp.asarray, (q, k, v)), extras, jseg,
                                jseg, None, causal, scale, bq, bk, window,
                                0.0)
    dq_j = np.asarray(JFA._flash_bwd(causal, scale, bq, bk, window, 0.0,
                                     False, res, jnp.asarray(do))[0])
    out_j = np.asarray(out_j)
    lse_j = np.asarray(res[4]).reshape(1, H, sq)
    delta_j = (out_j * do).sum(-1).transpose(0, 2, 1)

    T = torch.from_numpy
    var = dict(q_seg=None if seg is None else T(seg),
               kv_seg=None if seg is None else T(seg),
               fm=None if fm is None else tuple(map(T, fm)), window=window)
    n = FA.flash_fwd.LAUNCHES, FA.flash_bwd_dq.LAUNCHES
    out_t, lse_t = FA.flash_fwd(T(q), T(k), T(v), causal, scale, **var)
    dq_t, delta_t = FA.flash_bwd_dq(T(q), T(k), T(v), lse_t, T(do), causal,
                                    scale, **var)
    assert (FA.flash_fwd.LAUNCHES, FA.flash_bwd_dq.LAUNCHES) == n
    live = lse_j > -1e29
    assert np.array_equal(lse_t.numpy() > -1e29, live)
    np.testing.assert_allclose(lse_t.numpy()[live], lse_j[live], rtol=1e-5,
                               atol=2e-5)
    _close(out_t.numpy(), out_j, TOL_OUT, "out")
    _close(dq_t.numpy(), dq_j, TOL_GRAD, "dq")
    _close(delta_t.numpy(), delta_j, TOL_GRAD, "delta")
    if case.endswith("dead-rows"):
        assert not live.all() and (out_t[:, :sq - sk] == 0).all()


@pytest.mark.parametrize("dtype,broadcast", [
    (torch.bfloat16, True), (torch.float16, True), (torch.float32, True)])
def test_broadcast_views_copied_for_the_16_bit_kernels(dtype, broadcast):
    """A view repeated over its batch (stride 0) is copied to a contiguous
    buffer before the launch, in 16 bits and in fp32 alike (every kernel
    reads through TMA tensor maps, which take no zero stride); ordinary
    strided views (the model's head-major qkv) are read in place."""
    k = torch.randn(1, 8, 2, 16).to(dtype).expand(3, 8, 2, 16)
    assert FA._broadcasts(k) == broadcast
    (got,) = FA._padded(16, k)
    assert torch.equal(got, k)
    assert got.is_contiguous() == broadcast
    qkv = torch.randn(2, 8, 4, 3, 16).to(dtype)
    view = qkv[:, :, :, 1]
    assert not FA._broadcasts(view)
    (same,) = FA._padded(16, view)
    assert same.data_ptr() == view.data_ptr()
    one = torch.randn(1, 8, 1, 16).to(dtype)   # size-1 dims: nothing to copy
    assert not FA._broadcasts(one.expand(1, 8, 1, 16))
