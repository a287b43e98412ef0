"""The port's flash forward and backward in fp32 (out, lse, dq, dk, dv and
the d-bias), run on the CPU through its plain versions, against the JAX
package's Pallas kernels in interpret mode, at the edges of the tiles of
the card's fp32 kernels on the TF32 tensor cores. The forward
(``csrc/flash_fwd_tf32_hopper.cu``: 128 query rows a block over key tiles
of 32 up to D_pad 128, 64 rows over key tiles of 16 at D_pad 192 and
256): Sk on both sides of the key tile, Sq on both sides of the row block,
a window, a segment boundary and a flashmask boundary inside a tile, S
1000 non-causal, GQA 16/4 and GQA 8/2 with a bias, Sq != Sk, at D 40, 64
and 128 and at D 160 and 256; tolerance 2e-5 on out relative to its
max-abs (as
``test_torch_flash_tiles.py`` holds the forward in fp32). The backward
(dQ and dK/dV (``csrc/flash_dq_tf32_hopper.cu``: 64 query rows a block over
key tiles of 32 up to D_pad 192 and of 16 at 256;
``csrc/flash_dkv_tf32_hopper.cu``: 64 keys a block over query tiles of 32
up to D_pad 128 and of 16 at 192 and 256, streamed over the group's
heads): lengths 31, 33, 63, 65, 95 and 97
mixed, causal with Sq < Sk, GQA 8/2 (the group summed over its query
heads), a window across a 64-key block boundary, segment cuts at 31 and
65, document flashmask rows across key blocks, and an additive bias with
its gradient, at D 40 (read into the 64 width with zero columns), 64 and
128; and at D 160 and 256 (D_pad 192 and 256) lengths 15 / 17 and 63 / 65
on both sides of the 16-row tiles and the 64-row blocks, causal with Sq <
Sk, GQA 8/2, a window and segment cuts and document rows across 16-key
tiles, and a bias with its gradient. Inputs come
from numpy with a seed and go to both packages, as
``test_torch_flash_dkv_tiles.py`` runs them. Tolerance: 2e-4 on the
gradients in fp32, relative to the reference's max-abs. The CUDA kernels
are held to these plain versions on the card by
``test_torch_flash_fp32_hopper_cuda.py``.
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


# sq, sk, H, Hkv, causal, window, segment cuts, document lengths, JAX block,
# D, bias
CASES = {
    "causal-65x63-d64": (65, 63, 2, 2, True, None, None, None, None, 64,
                         False),
    "noncausal-33x97-d128": (33, 97, 2, 2, False, None, None, None, None,
                             128, False),
    "causal-31x129-sq-below-sk-d40": (31, 129, 2, 2, True, None, None, None,
                                      None, 40, False),
    "causal-97x95-gqa-8-2-d64": (97, 95, 8, 2, True, None, None, None, None,
                                 64, False),
    "noncausal-64x32-gqa-8-2-d128": (64, 32, 8, 2, False, None, None, None,
                                     None, 128, False),
    "window-129x129-across-64-d64": (129, 129, 2, 1, False, (40, 20), None,
                                     None, None, 64, False),
    "segments-cut-at-31-65-d40": (128, 128, 2, 2, False, None, (31, 65),
                                  None, 64, 40, False),
    "document-rows-across-key-blocks-d128": (128, 128, 2, 2, True, None,
                                             None, (33, 30, 65), 64, 128,
                                             False),
    "bias-dbias-65x97-d64": (65, 97, 2, 2, False, None, None, None, None, 64,
                             True),
    "bias-dbias-causal-96x96-d128": (96, 96, 2, 2, True, None, None, None,
                                     None, 128, True),
    # D_pad 192 / 256: 16-row streamed tiles (D 160 reads into 192 with zero
    # columns)
    "causal-17x15-across-16-d256": (17, 15, 2, 2, True, None, None, None,
                                    None, 256, False),
    "noncausal-15x17-across-16-d160": (15, 17, 2, 2, False, None, None, None,
                                       None, 160, False),
    "causal-65x63-d160": (65, 63, 2, 2, True, None, None, None, None, 160,
                          False),
    "noncausal-63x65-d256": (63, 65, 2, 2, False, None, None, None, None,
                             256, False),
    "causal-31x97-sq-below-sk-d160": (31, 97, 2, 2, True, None, None, None,
                                      None, 160, False),
    "causal-97x95-gqa-8-2-d256": (97, 95, 8, 2, True, None, None, None, None,
                                  256, False),
    "window-80x80-across-16-d160": (80, 80, 2, 1, False, (21, 9), None, None,
                                    None, 160, False),
    "segments-cut-at-15-49-d256": (96, 96, 2, 2, False, None, (15, 49), None,
                                   32, 256, False),
    "document-rows-across-16-d160": (96, 96, 2, 2, True, None, None,
                                     (17, 30, 49), 32, 160, False),
    "bias-dbias-65x97-d256": (65, 97, 2, 2, False, None, None, None, None,
                              256, True),
    "bias-dbias-causal-gqa-8-2-48x48-d160": (48, 48, 8, 2, True, None, None,
                                             None, None, 160, True),
}


def _close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_fp32_bwd_matches_jax_at_tf32_tile_edges(case):
    sq, sk, H, Hkv, causal, window, cuts, docs, block, D, with_bias = \
        CASES[case]
    rng = np.random.RandomState(7 * sq + sk + H + D)
    q, k, v, do = (rng.randn(*s).astype(np.float32)
                   for s in ((1, sq, H, D), (1, sk, Hkv, D), (1, sk, Hkv, D),
                             (1, sq, H, D)))
    bias = ((rng.randn(1, H, sq, sk) * 0.5).astype(np.float32)
            if with_bias else None)
    seg = None if cuts is None else _segments(sq, cuts)
    fm = None if docs is None else _doc_rows(sk, docs)
    scale = 1.0 / np.sqrt(D)
    bq, bk = block or sq, block or sk
    jseg = None if seg is None else jnp.asarray(seg)
    extras = (jnp.asarray(bias) if bias is not None else
              None if fm is None else (None, *map(jnp.asarray, fm)))
    _, res = JFA._flash_fwd(*map(jnp.asarray, (q, k, v)), extras, jseg, jseg,
                            None, causal, scale, bq, bk, window, 0.0,
                            bias_grad=with_bias)
    grads = JFA._flash_bwd(causal, scale, bq, bk, window, 0.0, with_bias,
                           res, jnp.asarray(do))

    T = torch.from_numpy
    var = dict(q_seg=None if seg is None else T(seg),
               kv_seg=None if seg is None else T(seg),
               fm=None if fm is None else tuple(map(T, fm)), window=window,
               bias=None if bias is None else T(bias))
    launches = (FA.flash_bwd_dq.LAUNCHES, FA.flash_bwd_dkv.LAUNCHES)
    _, lse = FA.flash_fwd(T(q), T(k), T(v), causal, scale, **var)
    got = FA.flash_bwd(T(q), T(k), T(v), lse, T(do), causal, scale,
                       bias_grad=with_bias, **var)
    assert (FA.flash_bwd_dq.LAUNCHES, FA.flash_bwd_dkv.LAUNCHES) == launches
    assert got[0].shape == (1, sq, H, D)
    assert got[1].shape == got[2].shape == (1, sk, Hkv, D)
    for what, g, j in zip(("dq", "dk", "dv"), got[:3], grads[:3]):
        _close(g.numpy(), np.asarray(j), TOL_GRAD, what)
    if with_bias:
        assert got[3].shape == bias.shape
        _close(got[3].numpy(), np.asarray(grads[3]), TOL_GRAD, "dbias")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=("fp32", "bf16"))
def test_fp32_broadcast_views_copied_for_the_tf32_backward(dtype):
    """A view repeated over its batch (stride 0) is copied to a contiguous
    buffer before any launch: every kernel, the fp32 ones on the TF32
    tensor cores too, reads its inputs through TMA tensor maps, which take
    no zero stride. The model's strided qkv views are read in place."""
    k = torch.randn(1, 8, 2, 16).to(dtype).expand(3, 8, 2, 16)
    assert FA._broadcasts(k)
    (got,) = FA._padded(16, k)
    assert torch.equal(got, k) and got.is_contiguous()
    view = torch.randn(2, 8, 4, 3, 16).to(dtype)[:, :, :, 1]
    assert not FA._broadcasts(view)
    (same,) = FA._padded(16, view)
    assert same.data_ptr() == view.data_ptr()


# sq, sk, H, Hkv, causal, window, segment cuts, document lengths, D, bias
FWD_CASES = {
    # Sk one short of and one past the 32-key tile; the rows past Sk under
    # the bottom-right causal rule see no key
    "noncausal-64x31-sk-below-key-tile-d64": (64, 31, 2, 2, False, None, None,
                                              None, 64, False),
    "causal-65x33-sk-above-key-tile-d128": (65, 33, 2, 2, True, None, None,
                                            None, 128, False),
    # a window whose edges fall inside 32-key tiles
    "window-100x100-inside-tiles-d40": (100, 100, 2, 1, False, (13, 5), None,
                                        None, 40, False),
    # segment boundaries and flashmask document boundaries inside tiles
    "segments-cut-at-45-77-d64": (96, 96, 2, 2, False, None, (45, 77), None,
                                  64, False),
    "document-rows-inside-tiles-d128": (128, 128, 2, 2, True, None, None,
                                        (45, 40, 43), 128, False),
    "noncausal-s1000-d64": (1000, 1000, 2, 2, False, None, None, None, 64,
                            False),
    "causal-129-gqa-16-4-d128": (129, 129, 16, 4, True, None, None, None, 128,
                                 False),
    "bias-causal-97x129-d64": (97, 129, 2, 2, True, None, None, None, 64,
                               True),
    # D_pad 192 / 256: 64 query rows a block over 16-key tiles (D 160 reads
    # into 192 with zero columns)
    "causal-65x15-sk-below-key-tile-d256": (65, 15, 2, 2, True, None, None,
                                            None, 256, False),
    "noncausal-63x17-sk-above-key-tile-d160": (63, 17, 2, 2, False, None,
                                               None, None, 160, False),
    "causal-65x63-rows-across-64-d160": (65, 63, 2, 2, True, None, None,
                                         None, 160, False),
    "window-100x100-inside-tiles-d256": (100, 100, 2, 1, False, (13, 5),
                                         None, None, 256, False),
    "segments-cut-at-45-77-d160": (96, 96, 2, 2, False, None, (45, 77), None,
                                   160, False),
    "document-rows-inside-tiles-d256": (128, 128, 2, 2, True, None, None,
                                        (45, 40, 43), 256, False),
    "bias-gqa-8-2-causal-97x129-d160": (97, 129, 8, 2, True, None, None, None,
                                        160, True),
    "noncausal-200x33-d256": (200, 33, 2, 2, False, None, None, None, 256,
                              False),
}


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_plain_fp32_fwd_matches_jax_at_tf32_tile_edges(case):
    sq, sk, H, Hkv, causal, window, cuts, docs, D, with_bias = FWD_CASES[case]
    rng = np.random.RandomState(3 * sq + sk + H + D)
    q, k, v = (rng.randn(*s).astype(np.float32)
               for s in ((1, sq, H, D), (1, sk, Hkv, D), (1, sk, Hkv, D)))
    bias = ((rng.randn(1, H, sq, sk) * 0.5).astype(np.float32)
            if with_bias else None)
    seg = None if cuts is None else _segments(sq, cuts)
    fm = None if docs is None else _doc_rows(sk, docs)
    scale = 1.0 / np.sqrt(D)
    jseg = None if seg is None else jnp.asarray(seg)
    extras = (jnp.asarray(bias) if bias is not None else
              None if fm is None else (None, *map(jnp.asarray, fm)))
    out_j, res = JFA._flash_fwd(*map(jnp.asarray, (q, k, v)), extras, jseg,
                                jseg, None, causal, scale, sq, sk, window,
                                0.0)
    out_j = np.asarray(out_j)
    lse_j = np.asarray(res[4]).reshape(1, H, sq)

    T = torch.from_numpy
    var = dict(q_seg=None if seg is None else T(seg),
               kv_seg=None if seg is None else T(seg),
               fm=None if fm is None else tuple(map(T, fm)), window=window,
               bias=None if bias is None else T(bias))
    n = FA.flash_fwd.LAUNCHES
    out_t, lse_t = FA.flash_fwd(T(q), T(k), T(v), causal, scale, **var)
    assert FA.flash_fwd.LAUNCHES == n
    assert out_t.shape == (1, sq, H, D) and lse_t.shape == (1, H, sq)
    live = lse_j > -1e29
    assert np.array_equal(lse_t.numpy() > -1e29, live)
    np.testing.assert_allclose(lse_t.numpy()[live], lse_j[live], rtol=1e-5,
                               atol=2e-5)
    _close(out_t.numpy(), out_j, TOL_OUT, "out")
    if not live.all():
        dead = ~live[0].transpose()                      # [sq, H]
        assert (out_t[0][torch.from_numpy(dead)] == 0).all()
