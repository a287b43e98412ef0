"""The port's ragged paged attention, run on the CPU through its plain
version, against the JAX package's Pallas kernel in interpret mode, at the
calls the card's wgmma kernels take through their gathered page ring and
over 1-byte pools with fp32 queries:

* page sizes that are not a multiple of 8 (5, 12, 20 and 100 keys; the
  card gathers them key row by key row into the tiles its 16-bit kernel's
  TMA ring fills at other sizes; its TF32 kernel gathers every size), in
  fp32 and bf16: a decode batch with kv_len one short
  of, at and one past a page and a 64-key tile, and a GQA 16/4 mixed batch
  with q_len * g on both sides of 64 and a row longer than its table;
* fp32 and bf16 queries over int8 and fp8 e4m3 pools with per-(kv head,
  page) scales at D 64 and 128, pages of 12 and 16 keys (the reference's
  quantized branch; fp32 queries run the card's TF32 kernel).

Inputs come from numpy with a seed and go to both packages, as
``test_torch_ragged_tiles.py`` runs them. Tolerances, relative to the
reference's max-abs: 2e-5 in fp32 (summation order) and 1e-2 in bf16 (the
rounding of the inputs and of the output); over quantized pools the bound
of the reference's own int8 test, 0.08 absolute
(``tests/test_ragged_serving.py``), and 2e-5 relative as well for fp32
queries. The CUDA kernels are held to this plain version on the card by
``test_torch_ragged_hopper_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa)
from paddle_tpu_torch.kernels import ragged_paged_attention as RPA

TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
PAGE_SIZES = (5, 12, 20, 100)


def _cases(bs):
    """q_lens, kv_lens, C, hq, hkv, nb (None: just enough pages)."""
    tile = -(-65 // bs)          # the pages of 65 keys
    return {
        # kv_len one short of, at and one past a page and a 64-key tile
        "decode": ([1] * 6, [bs - 1, bs, bs + 1, 63, 64, 65], 1, 4, 4, None),
        # q_len * g (g = 4) on both sides of 64; the last row runs 7 keys
        # past its table of `tile` pages
        "gqa-16-4-mixed": ([15, 16, 17, 1], [15, 64, 65, tile * bs + 7], 20,
                           16, 4, tile),
    }


def _case(q_lens, kv_lens, C, hq, hkv, nb, bs, D=16, seed=0):
    rng = np.random.RandomState(seed + sum(kv_lens) + C + hkv + bs)
    R = len(q_lens)
    nb = nb or max(-(-k // bs) for k in kv_lens)
    NB = R * nb + 1
    tables = rng.permutation(np.arange(1, NB))[:R * nb].reshape(R, nb)
    return dict(q=rng.randn(R, C, hq, D).astype(np.float32),
                k_pool=rng.randn(hkv, NB, bs, D).astype(np.float32),
                v_pool=rng.randn(hkv, NB, bs, D).astype(np.float32),
                block_tables=tables.astype(np.int32),
                q_lens=np.asarray(q_lens, np.int32),
                kv_lens=np.asarray(kv_lens, np.int32),
                scale=1.0 / np.sqrt(D))


def _compare(name, out, ref, q_lens, dtype, abs_tol=None):
    assert out.dtype == dtype
    got = out.float().numpy()
    assert np.isfinite(got).all(), name
    err = np.abs(got - ref).max()
    if abs_tol is not None:
        assert err < abs_tol, (name, err)
    if abs_tol is None or dtype == torch.float32:
        rel = err / max(np.abs(ref).max(), 1e-9)
        assert rel <= TOL[dtype], (name, rel)
    for r, ql in enumerate(q_lens):
        assert (got[r, ql:] == 0).all(), (name, r)   # columns past q_len


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("batch", ("decode", "gqa-16-4-mixed"))
@pytest.mark.parametrize("bs", PAGE_SIZES)
def test_plain_matches_jax_at_page_sizes_off_8(bs, batch, dtype):
    q_lens, kv_lens, C, hq, hkv, nb = _cases(bs)[batch]
    case = _case(q_lens, kv_lens, C, hq, hkv, nb, bs)
    names = ("q", "k_pool", "v_pool", "block_tables", "q_lens", "kv_lens")
    jargs = [jnp.asarray(case[n]) for n in names]
    targs = [torch.from_numpy(case[n]) for n in names]
    for i in range(3):
        jargs[i] = jargs[i].astype(JDTYPE[dtype])
        targs[i] = targs[i].to(dtype)
    ref = np.asarray(jax_rpa(*jargs, case["scale"]).astype(jnp.float32))
    n = RPA.ragged_paged_attention.LAUNCHES
    out = RPA.ragged_paged_attention(*targs, case["scale"])
    assert RPA.ragged_paged_attention.LAUNCHES == n     # CPU: the plain one
    _compare(f"bs={bs} {batch}", out, ref, case["q_lens"], dtype)


def _quantized_pools(shape, kind, rng):
    """(JAX pool, torch pool) of ``kind``: int8 values, or values on the
    e4m3 grid (exact in both packages)."""
    if kind == "int8":
        vals = rng.randint(-127, 128, shape).astype(np.int8)
        return jnp.asarray(vals), torch.from_numpy(vals)
    t = torch.from_numpy(np.clip(rng.randn(*shape) * 100, -448, 448)
                         .astype(np.float32)).to(torch.float8_e4m3fn)
    return jnp.asarray(t.float().numpy()).astype(jnp.float8_e4m3fn), t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("kind", ("int8", "fp8_e4m3"))
@pytest.mark.parametrize("D", (64, 128))
@pytest.mark.parametrize("bs", (12, 16))
def test_plain_matches_jax_over_quantized_pools(bs, D, kind, dtype):
    """GQA 16/4 with q_len * g on both sides of 64 and a decode row, over
    pages of 12 (the gathered ring on the card) and 16 keys (the 16-bit
    kernel's TMA ring)."""
    case = _case([15, 16, 17, 1], [15, 40, 65, 100], 20, 16, 4, None, bs,
                 D=D, seed=7)
    rng = np.random.RandomState(bs + D)
    pools = [_quantized_pools(case[n].shape, kind, rng)
             for n in ("k_pool", "v_pool")]
    hkv, NB = case["k_pool"].shape[:2]
    scales = [(rng.rand(hkv, NB) + 0.5).astype(np.float32) for _ in range(2)]
    rest = ("block_tables", "q_lens", "kv_lens")
    ref = jax_rpa(jnp.asarray(case["q"]).astype(JDTYPE[dtype]), pools[0][0],
                  pools[1][0], *(jnp.asarray(case[n]) for n in rest),
                  case["scale"], *(jnp.asarray(sc) for sc in scales))
    ref = np.asarray(ref.astype(jnp.float32))
    n = RPA.ragged_paged_attention.LAUNCHES
    out = RPA.ragged_paged_attention(
        torch.from_numpy(case["q"]).to(dtype), pools[0][1], pools[1][1],
        *(torch.from_numpy(case[n]) for n in rest), case["scale"],
        *(torch.from_numpy(sc) for sc in scales))
    assert RPA.ragged_paged_attention.LAUNCHES == n     # CPU: the plain one
    _compare(f"bs={bs} D={D} {kind}", out, ref, case["q_lens"], dtype,
             abs_tol=0.08)
