"""The port's paged decode attention (``paddle_tpu_torch.kernels
.paged_attention``) against the JAX package's Pallas kernel, run in
interpret mode on the CPU.

On the CPU the port's wrapper takes the kernel's plain PyTorch version, so
these tests hold that version (what ``chip_smoke.py`` phase 10 compares the
CUDA kernel with on the card) to the JAX kernel. Inputs are made with numpy
from a seed and handed to both packages. Tolerances: fp32 1e-5 max-abs
(summation order); bf16 1e-2 of the largest output (``test_ragged_serving``'s
bf16 bound: the rounding of q, the pages, the probabilities before p v in
the JAX kernel, and the output). The CUDA kernel itself is tested on the
card by ``test_torch_serving_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas.paged_attention import (
    paged_decode_attention as jax_paged)
from paddle_tpu_torch.kernels import paged_attention as PA

NAMES = ("q", "k_pool", "v_pool", "block_tables", "seq_lens")


def _case(hq, hkv, seed=0, D=16, bs=8, nb=6, NB=32):
    """Row 0 spans 3 pages and ends mid-page, row 1 has len 0, row 2 fills
    exactly 2 pages, row 3 ends one token into its second page; every row's
    table is wider than its used pages and the unused slots hold real
    blocks, so a read past len would change the answer."""
    rng = np.random.RandomState(seed)
    lens = np.array([19, 0, 16, 9], np.int32)
    perm = rng.permutation(np.arange(1, NB))
    tables = perm[:4 * nb].reshape(4, nb).astype(np.int32)
    return dict(q=rng.randn(4, hq, D).astype(np.float32),
                k_pool=rng.randn(hkv, NB, bs, D).astype(np.float32),
                v_pool=rng.randn(hkv, NB, bs, D).astype(np.float32),
                block_tables=tables, seq_lens=lens, scale=1.0 / np.sqrt(D))


def _run_both(case, jdtype, tdtype):
    jargs = [jnp.asarray(case[n]) for n in NAMES]
    targs = [torch.from_numpy(case[n]) for n in NAMES]
    for i in range(3):
        jargs[i] = jargs[i].astype(jdtype)
        targs[i] = targs[i].to(tdtype)
    ref = np.asarray(jax_paged(*jargs, case["scale"]).astype(jnp.float32))
    out = PA.paged_decode_attention(*targs, case["scale"])
    assert out.dtype == tdtype and out.shape == targs[0].shape
    return out.float().numpy(), ref


GROUPS = [(4, 4), (4, 1), (8, 2)]   # MHA, MQA, GQA


@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_plain_matches_jax_kernel_fp32(hq, hkv):
    case = _case(hq, hkv)
    out, ref = _run_both(case, jnp.float32, torch.float32)
    assert np.abs(out - ref).max() <= 1e-5
    assert (out[1] == 0).all()                    # len 0 -> zeros


@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_plain_matches_jax_kernel_bf16(hq, hkv):
    case = _case(hq, hkv, seed=3)
    out, ref = _run_both(case, jnp.bfloat16, torch.bfloat16)
    rel = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-9)
    assert rel <= 1e-2, rel
    assert (out[1] == 0).all()


def test_only_keys_before_len_count():
    """Changing a key at or past len, in a used page or an unused table
    slot, leaves the output alone; changing one before len does not."""
    case = _case(4, 4, seed=1)
    args = [torch.from_numpy(case[n]) for n in NAMES]
    base = PA.paged_decode_attention(*args, case["scale"])
    tables = case["block_tables"]
    k = args[1].clone()
    k[:, tables[0, 2], 3:] = 100.0                # row 0: positions 19..23
    k[:, tables[0, 4]] = 100.0                    # row 0: an unused slot
    same = PA.paged_decode_attention(args[0], k, *args[2:], case["scale"])
    assert torch.equal(same[0], base[0])
    k[:, tables[0, 2], 2] = 100.0                 # position 18 < len 19
    moved = PA.paged_decode_attention(args[0], k, *args[2:], case["scale"])
    assert not torch.allclose(moved[0], base[0])


def test_cpu_wrapper_takes_plain_and_counts_no_launch():
    case = _case(8, 2)
    args = [torch.from_numpy(case[n]) for n in NAMES]
    before = PA.paged_decode_attention.LAUNCHES
    a = PA.paged_decode_attention(*args, case["scale"])
    b = PA.paged_decode_attention_plain(*args, case["scale"])
    assert PA.paged_decode_attention.LAUNCHES == before
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["fp64", "int8_pool", "q_d_stride",
                                 "int64_lens", "mixed_dtype", "tables_1d"])
def test_kernel_checks_refuse_what_the_kernel_does_not_take(bad):
    """The checks a CUDA call passes before its launch, run on host
    tensors. A strided q (a view of the head-major qkv) is taken."""
    case = _case(4, 4)
    args = [torch.from_numpy(case[n]) for n in NAMES]
    args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
    qkv = torch.zeros(4, 4, 3, 16, dtype=torch.bfloat16)
    PA._check_cuda(qkv[:, :, 0], *args[1:])      # strided q passes
    if bad == "fp64":
        args[:3] = [a.to(torch.float64) for a in args[:3]]
    elif bad == "int8_pool":
        args[1], args[2] = args[1].to(torch.int8), args[2].to(torch.int8)
    elif bad == "q_d_stride":
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "int64_lens":
        args[4] = args[4].long()
    elif bad == "mixed_dtype":
        args[1] = args[1].float()
    elif bad == "tables_1d":
        args[3] = args[3].reshape(-1)
    with pytest.raises((TypeError, ValueError)):
        PA._check_cuda(*args)
