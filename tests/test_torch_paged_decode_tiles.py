"""The port's paged decode attention, run on the CPU through its plain
version, against the JAX package's Pallas kernel in interpret mode, at the
edges of the card's redesigned kernel (``csrc/paged_decode_hopper.cu``: a
row's pages split into ranges of ceil(nb / splits) pages over blocks, pages
through a ring, a lane per key, up to 8 of the group's query rows a block)
and of the kernel that takes the other shapes
(``csrc/paged_decode_attention.cu``: 32 keys a tile, 2048 / D query rows a
block): lengths one short of, at and one past a page and a split boundary;
g = 1, 4, 16 and MQA 32/1; D 64, 128 and 256; pages of 8, 16, 32 and 64
keys; tables wider than the used pages, with real blocks in the unused
slots; len 0; a length past the table; and the serving decode batch of
``chip_smoke.py`` phase 10. In fp32 alone, the edges of the fp32 calls on
the ring (``PART_CASES``): pages carried in parts of 16 or 32 keys (fp32
at D 256, pages of 64 keys at D 128), lengths one short of, at and one past
a part, a page and a split boundary, g 1 / 4 / 16, D 64 / 100 / 128 / 256
(100: whole 16-byte words of fp32, not of 16 bits), pages of 8 to 64 keys.
Inputs come from numpy with a seed and go to
both packages, as ``test_torch_paged_decode.py`` runs them. Tolerances:
fp32 1e-5 max-abs (summation order); bf16 1e-2 of the largest output (the
rounding of q, the pages, the probabilities before p v in the JAX kernel,
and the output). The CUDA kernels are held to this plain version on the
card, every split count forced, by ``test_torch_paged_decode_hopper_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas.paged_attention import (
    paged_decode_attention as jax_paged)
from paddle_tpu_torch.kernels import paged_attention as PA

NAMES = ("q", "k_pool", "v_pool", "block_tables", "seq_lens")

# lens, H_q, H_kv, D, bs, nb
CASES = {
    # pages of 16 in a table of 8: 15 / 16 / 17 around a page, 63 / 64 / 65
    # around the boundary of two splits (4 pages each), the full table
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
    # a table of 12 slots of which 1-3 are used
    "wide-table": ([5, 20], 4, 4, 64, 8, 12),
    # a length past the table's 3 pages sees the table's keys only
    "len-past-table": ([100, 48], 2, 2, 64, 16, 3),
    # chip_smoke.py phase 10's case (a) at 2 of its 16 heads (the
    # interpreter walks every (row, head, table slot) grid step)
    "serving-decode-batch": ([100, 173, 256, 311, 400, 467, 555, 640], 2, 2,
                             128, 32, 20),
}


# the fp32 calls at the ring route's edges (lens, H_q, H_kv, D, bs, nb):
# a stage of 16 keys, half a page (fp32 D 256 bs 32: 15 / 16 / 17 around a
# part, 31 / 32 / 33 around a page, 63 / 64 / 65 around two splits of 2
# pages), a stage of 32 keys of a 64-key page at D 128 under g 16, whole
# pages of 8 keys in a wide table (many splits), g 4 at D 100
PART_CASES = {
    "d256-bs32-parts-of-16": ([15, 16, 17, 31, 32, 33, 63, 64, 65, 0], 2, 2,
                              256, 32, 4),
    "d128-bs64-g16-parts-of-32": ([31, 32, 33, 64, 129], 16, 1, 128, 64, 3),
    "d64-bs8-g1-split-edges": ([15, 16, 17, 95, 96, 97], 2, 2, 64, 8, 16),
    "d100-bs16-g4": ([40, 65, 0], 8, 2, 100, 16, 6),
}


def _case(lens, hq, hkv, D, bs, nb, seed=0):
    """Every table slot is a distinct real block, so a read past a row's
    length would change the answer."""
    rng = np.random.RandomState(seed + sum(lens) + hq + D + bs)
    B = len(lens)
    NB = B * nb + 1
    tables = rng.permutation(np.arange(1, NB))[:B * nb].reshape(B, nb)
    return dict(q=rng.randn(B, hq, D).astype(np.float32),
                k_pool=rng.randn(hkv, NB, bs, D).astype(np.float32),
                v_pool=rng.randn(hkv, NB, bs, D).astype(np.float32),
                block_tables=tables.astype(np.int32),
                seq_lens=np.asarray(lens, np.int32), scale=1.0 / np.sqrt(D))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_at_tile_and_split_edges(name, dtype):
    case = _case(*CASES[name])
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jargs = [jnp.asarray(case[n]) for n in NAMES]
    targs = [torch.from_numpy(case[n]) for n in NAMES]
    for i in range(3):
        jargs[i] = jargs[i].astype(jdtype)
        targs[i] = targs[i].to(dtype)
    ref = np.asarray(jax_paged(*jargs, case["scale"]).astype(jnp.float32))
    n = PA.paged_decode_attention.LAUNCHES
    out = PA.paged_decode_attention(*targs, case["scale"])
    assert PA.paged_decode_attention.LAUNCHES == n
    assert out.dtype == dtype and out.shape == targs[0].shape
    got = out.float().numpy()
    assert np.isfinite(got).all()
    if dtype == torch.float32:
        err = np.abs(got - ref).max()
        assert err <= 1e-5, (name, err)
    else:
        rel = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-9)
        assert rel <= 1e-2, (name, rel)
    for b, ln in enumerate(case["seq_lens"]):
        if ln == 0:
            assert (got[b] == 0).all(), (name, b)


@pytest.mark.parametrize("name", list(PART_CASES))
def test_plain_matches_jax_fp32_at_the_ring_edges(name):
    case = _case(*PART_CASES[name])
    ref = np.asarray(jax_paged(*[jnp.asarray(case[n]) for n in NAMES],
                               case["scale"]))
    n = PA.paged_decode_attention.LAUNCHES
    out = PA.paged_decode_attention(
        *[torch.from_numpy(case[n]) for n in NAMES], case["scale"])
    assert PA.paged_decode_attention.LAUNCHES == n
    assert out.dtype == torch.float32 and out.shape == case["q"].shape
    err = np.abs(out.numpy() - ref).max()
    assert err <= 1e-5, (name, err)
    for b, ln in enumerate(case["seq_lens"]):
        if ln == 0:
            assert (out[b] == 0).all(), (name, b)


@pytest.mark.parametrize("hq,hkv,D", [(32, 1, 128), (4, 4, 256), (6, 2, 40),
                                      (64, 1, 64)])
def test_kernel_checks_take_every_group_and_head_dim_up_to_256(hq, hkv, D):
    """The host checks a CUDA call passes before its launch, run on host
    tensors: MQA 32/1, D 256, a head dim that is not whole 16-byte words
    and a group of 64 heads pass; D above 256 and H_q not a multiple of
    H_kv are refused."""
    case = _case([5, 0], hq, hkv, D, 8, 2)
    args = [torch.from_numpy(case[n]) for n in NAMES]
    args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
    PA._check_cuda(*args)
    big = _case([5], 2, 2, 264, 8, 1)
    with pytest.raises(ValueError, match="256"):
        PA._check_cuda(*[torch.from_numpy(big[n]) for n in NAMES])
    odd = _case([5], 6, 4, 16, 8, 1)
    with pytest.raises(ValueError, match="multiple"):
        PA._check_cuda(*[torch.from_numpy(odd[n]) for n in NAMES])
