"""The port's ragged paged attention (``paddle_tpu_torch.kernels``) against
the JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper takes the kernel's plain PyTorch version, so
these tests hold that version (the arithmetic ``chip_smoke.py`` compares the
CUDA kernel with on the card) to the JAX kernel. Inputs are made with numpy
from a seed and handed to both packages. The CUDA kernel itself is tested on
the card by ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa)
from paddle_tpu_torch.kernels import ragged_paged_attention as RPA


def _case(hq, hkv, seed=0, R=4, C=6, D=16, bs=8, nb=5, NB=16):
    """The layout of test_ragged_serving: row 0 decode, row 1 a prefill
    chunk mid-sequence, row 2 empty (a finished slot), row 3 a fresh
    prefill."""
    rng = np.random.RandomState(seed)
    q_lens = np.array([1, 6, 0, 3], np.int32)
    kv_lens = np.array([19, 11, 0, 3], np.int32)
    tables = np.zeros((R, nb), np.int32)
    blk = 1
    for r in range(R):
        for j in range(-(-int(kv_lens[r]) // bs)):
            tables[r, j] = blk
            blk += 1
    return dict(q=rng.randn(R, C, hq, D).astype(np.float32),
                k_pool=rng.randn(hkv, NB, bs, D).astype(np.float32),
                v_pool=rng.randn(hkv, NB, bs, D).astype(np.float32),
                block_tables=tables, q_lens=q_lens, kv_lens=kv_lens,
                scale=1.0 / np.sqrt(D))


def _run_both(case, jdtype, tdtype):
    names = ("q", "k_pool", "v_pool", "block_tables", "q_lens", "kv_lens")
    jargs = [jnp.asarray(case[n]) for n in names]
    targs = [torch.from_numpy(case[n]) for n in names]
    for i in range(3):
        jargs[i] = jargs[i].astype(jdtype)
        targs[i] = targs[i].to(tdtype)
    ref = np.asarray(jax_rpa(*jargs, case["scale"]).astype(jnp.float32))
    out = RPA.ragged_paged_attention(*targs, case["scale"])
    assert out.dtype == tdtype and out.shape == targs[0].shape
    return out.float().numpy(), ref


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])  # MHA + GQA
def test_plain_matches_jax_kernel_fp32(hq, hkv):
    case = _case(hq, hkv)
    out, ref = _run_both(case, jnp.float32, torch.float32)
    assert np.abs(out - ref).max() <= 1e-5
    # the empty row and every column past a row's q_len are exact zeros
    for r, ql in enumerate(case["q_lens"]):
        assert (out[r, ql:] == 0).all()


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_plain_matches_jax_kernel_bf16(hq, hkv):
    case = _case(hq, hkv, seed=3)
    out, ref = _run_both(case, jnp.bfloat16, torch.bfloat16)
    rel = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-9)
    assert rel <= 1e-2, rel  # bf16 rounding of q/k/v and of the output
    assert (out[2] == 0).all()


def test_row_with_no_visible_key_is_zero():
    # kv_len < q_len puts every query before position 0: nothing visible
    case = _case(4, 4)
    case["kv_lens"] = np.array([19, 4, 0, 3], np.int32)
    out, ref = _run_both(case, jnp.float32, torch.float32)
    assert np.isfinite(out).all()
    assert (out[1, :2] == 0).all()
    assert np.abs(out - ref).max() <= 1e-5


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_row_longer_than_its_table_sees_only_table_pages(hq, hkv):
    # kv_len past nb * bs: the JAX grid stops at the table's nb slots, so
    # keys past nb * bs are never read; the port holds to the same
    case = _case(hq, hkv)
    case["kv_lens"] = np.array([45, 11, 0, 3], np.int32)   # nb * bs = 40
    case["block_tables"][0, 3:] = [14, 15]
    out, ref = _run_both(case, jnp.float32, torch.float32)
    assert np.abs(out - ref).max() <= 1e-5
    # the decode row's answer is attention over exactly the 40 table keys
    short = dict(case, kv_lens=np.array([40, 11, 0, 3], np.int32),
                 q=case["q"].copy())
    out40, _ = _run_both(short, jnp.float32, torch.float32)
    assert np.abs(out[0, 0] - out40[0, 0]).max() <= 1e-5


def test_cpu_wrapper_takes_plain_and_counts_no_launch():
    case = _case(4, 4)
    args = [torch.from_numpy(case[n]) for n in
            ("q", "k_pool", "v_pool", "block_tables", "q_lens", "kv_lens")]
    before = RPA.ragged_paged_attention.LAUNCHES
    a = RPA.ragged_paged_attention(*args, case["scale"])
    b = RPA.ragged_paged_attention_plain(*args, case["scale"])
    assert RPA.ragged_paged_attention.LAUNCHES == before
    assert torch.equal(a, b)


def _kernel_args(dtype=torch.bfloat16):
    case = _case(4, 4)
    args = [torch.from_numpy(case[n]) for n in
            ("q", "k_pool", "v_pool", "block_tables", "q_lens", "kv_lens")]
    for i in range(3):
        args[i] = args[i].to(dtype)
    return args


@pytest.mark.parametrize("bad", ["fp64", "int8_pool", "noncontig_q",
                                 "int64_lens", "mixed_dtype", "head_dim"])
def test_kernel_checks_refuse_what_the_kernel_does_not_take(bad):
    """The checks a CUDA call passes before its launch, run on host
    tensors: wrong dtype, an int8 pool, a non-contiguous view."""
    args = _kernel_args()
    if bad == "fp64":
        args[:3] = [a.to(torch.float64) for a in args[:3]]
    elif bad == "int8_pool":
        args[1] = args[1].to(torch.int8)
        args[2] = args[2].to(torch.int8)
    elif bad == "noncontig_q":
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "int64_lens":
        args[4] = args[4].long()
    elif bad == "mixed_dtype":
        args[1] = args[1].float()
    elif bad == "head_dim":
        args[0] = args[0][..., :12].contiguous()
    with pytest.raises((TypeError, ValueError)):
        RPA._check_cuda(*args)
    RPA._check_cuda(*_kernel_args())  # the unchanged inputs pass
