"""The port's flash dK/dV (dk, dv), run on the CPU through its plain
backward, against the JAX package's Pallas backward in interpret mode, at
the edges of the tiles of the card's 16-bit dK/dV kernel
(``csrc/flash_dkv_hopper.cu``: 128 keys a block in two warpgroups of 64,
query tiles of 64 streamed over the group's heads): key lengths 127, 128,
129, 255 and 257 mixed with query lengths, causal with Sq < Sk, a window
across a 128 boundary, GQA 8/2 and 16/4 (the group summed over its query
heads), segment boundaries at 127 and 129, document flashmask rows across
key tiles. At D 160, 192 and 256 the same at the edges of the kernel's
split design (64 keys a block, two warpgroups over the same keys): key
lengths 63, 64, 65, 127 and 129, causal and not, GQA 8/2, a window across
a 64 boundary, segment cuts at 63 and 65, document rows across 64-key
tiles (small shapes: the Pallas kernel runs in interpret mode).
Inputs come from numpy with a seed and go to both packages, as
``test_torch_flash_tiles.py`` runs them; the port's dK/dV takes the delta of
its own dQ (rowsum(p dP)). Tolerance: 2e-4 in fp32, relative to the
reference's max-abs. The CUDA kernel is held to this plain backward on the
card by ``test_torch_flash_hopper_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas import flash_attention as JFA
from paddle_tpu_torch.kernels import flash_attention as FA

TOL_GRAD = 2e-4


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
    "causal-129x127": (129, 127, 2, 2, True, None, None, None, None),
    "noncausal-63x128": (63, 128, 2, 2, False, None, None, None, None),
    "causal-200x129-gqa-8-2": (200, 129, 8, 2, True, None, None, None, None),
    "causal-127x255-sq-below-sk": (127, 255, 2, 2, True, None, None, None,
                                   None),
    "noncausal-64x257-gqa-16-4": (64, 257, 16, 4, False, None, None, None,
                                  None),
    "window-255x255-across-128": (255, 255, 2, 1, False, (100, 40), None,
                                  None, None),
    "segments-cut-at-127-129": (256, 256, 2, 2, False, None, (127, 129),
                                None, 128),
    "document-rows-across-key-tiles": (256, 256, 2, 2, True, None, None,
                                       (100, 60, 96), 128),
}


# the same at the split design's widths: + D
WIDE_CASES = {
    "causal-65x63-d256": (65, 63, 2, 2, True, None, None, None, None, 256),
    "noncausal-64x129-gqa-8-2-d192": (64, 129, 8, 2, False, None, None, None,
                                      None, 192),
    "causal-129x65-d160": (129, 65, 2, 2, True, None, None, None, None, 160),
    "causal-63x127-gqa-8-2-d256": (63, 127, 8, 2, True, None, None, None,
                                   None, 256),
    "window-128x128-across-64-d256": (128, 128, 2, 1, False, (50, 20), None,
                                      None, None, 256),
    "segments-cut-at-63-65-d192": (128, 128, 2, 2, False, None, (63, 65),
                                   None, 64, 192),
    "document-rows-across-key-tiles-d256": (128, 128, 2, 2, True, None, None,
                                            (50, 30, 48), 64, 256),
}


def _close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_dkv_match_jax_at_tile_edges(case):
    sq, sk, H = CASES[case][:3]
    _check_case(*CASES[case], D=16, seed=5 * sq + sk + H)


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_plain_dkv_match_jax_at_split_tile_edges(case):
    *rest, D = WIDE_CASES[case]
    sq, sk, H = rest[:3]
    _check_case(*rest, D=D, seed=5 * sq + sk + H + D)


def _check_case(sq, sk, H, Hkv, causal, window, cuts, docs, block, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(*s).astype(np.float32)
                   for s in ((1, sq, H, D), (1, sk, Hkv, D), (1, sk, Hkv, D),
                             (1, sq, H, D)))
    seg = None if cuts is None else _segments(sq, cuts)
    fm = None if docs is None else _doc_rows(sk, docs)
    scale = 1.0 / np.sqrt(D)
    bq, bk = block or sq, block or sk
    jseg = None if seg is None else jnp.asarray(seg)
    extras = None if fm is None else (None, *map(jnp.asarray, fm))
    _, res = JFA._flash_fwd(*map(jnp.asarray, (q, k, v)), extras, jseg, jseg,
                            None, causal, scale, bq, bk, window, 0.0)
    grads = JFA._flash_bwd(causal, scale, bq, bk, window, 0.0, False, res,
                           jnp.asarray(do))
    dk_j, dv_j = np.asarray(grads[1]), np.asarray(grads[2])

    T = torch.from_numpy
    var = dict(q_seg=None if seg is None else T(seg),
               kv_seg=None if seg is None else T(seg),
               fm=None if fm is None else tuple(map(T, fm)), window=window)
    n = FA.flash_bwd_dkv.LAUNCHES
    _, lse = FA.flash_fwd(T(q), T(k), T(v), causal, scale, **var)
    _, delta = FA.flash_bwd_dq(T(q), T(k), T(v), lse, T(do), causal, scale,
                               **var)
    dk_t, dv_t = FA.flash_bwd_dkv(T(q), T(k), T(v), lse, delta, T(do), causal,
                                  scale, **var)
    assert FA.flash_bwd_dkv.LAUNCHES == n
    assert dk_t.shape == (1, sk, Hkv, D) and dv_t.shape == (1, sk, Hkv, D)
    _close(dk_t.numpy(), dk_j, TOL_GRAD, "dk")
    _close(dv_t.numpy(), dv_j, TOL_GRAD, "dv")
