"""The port's ragged paged attention, run on the CPU through its plain
version, against the JAX package's Pallas kernel in interpret mode, at the
edges of the tiles and splits of the card's wgmma kernel
(``csrc/ragged_paged_attention_hopper.cu``: 64 folded (chunk, group) query
rows a block, key tiles of 64, a row's key tiles split by the table width,
D_pad 64 to 256):
q_len * g on both sides of 64, kv_len on both sides of page and key-tile
boundaries, pages of 16, 32 and 64, GQA 16/16 and 16/4, the serving decode
batch of ``chip_smoke.py`` phase 3 (8 rows, kv_len 100-640), rows with
q_len 0, and a row longer than its table; at wide and odd head dims (D
100, not a whole number of 16-byte words in bf16, on the card's CUDA-core
route; D 160 and 256, on the 16-bit wgmma kernel at D_pad 192 and 256 and
on the CUDA-core route in fp32), decode and mixed, GQA 16/4 with q_len * g
on both sides of 64; at D 192 and 256 with kv_len on both sides of a
64-key tile and of a page (pages of 16 and 32); over int8 and fp8
e4m3 pools at D 256 (the reference's quantized branch); and in fp32 at the
TF32 kernel's D_pad 192 and 256 (D 160 and 256: key tiles of 16), a
decode batch with kv_len across a 16-key tile and a page, a GQA 16/4
mixed batch and a decode batch across the table's split edge, over fp32
and int8 pools, pages of 12 and 32. Inputs come from
numpy with a seed and go to both packages, as
``test_torch_ragged_attention.py`` runs them.
Tolerances, relative to the reference's max-abs: 2e-5 in fp32 (summation
order) and 1e-2 in bf16 (that file's bound: the rounding of the inputs and
of the output); over quantized pools 0.08 absolute, the bound of the
reference's own int8 test (``tests/test_ragged_serving.py``), and 2e-5
relative as well for fp32 queries.
The CUDA kernels are held to this plain version on the card by
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


# q_lens, kv_lens, C, hq, hkv, bs, nb (None: just enough pages)
CASES = {
    # 16 query heads over 4 kv heads fold g = 4 per chunk column: q_len 15,
    # 16 and 17 put q_len * g on both sides of one 64-row block
    "gqa-16-4-qlen-g-across-64": ([15, 16, 17, 1], [15, 80, 130, 200], 20, 16,
                                  4, 16, None),
    # g = 1: q_len 63, 64, 65 rows of one (row, kv head)
    "mha-16-16-qlen-across-64": ([63, 64, 65, 0], [63, 127, 129, 0], 65, 16,
                                 16, 32, None),
    # kv_len one short of, at, and one past a page (32) and a key tile (64)
    "kv-across-page-and-tile": ([1, 1, 1, 1, 1, 1], [31, 32, 33, 63, 64, 65],
                                1, 16, 4, 32, None),
    # kv_len across split boundaries of a wide table (33 pages of 16: 9 key
    # tiles, cut into ranges of 2 to 5 tiles by the split counts)
    "kv-across-split-ranges": ([1, 1, 4, 1], [128, 129, 320, 513], 4, 16, 16,
                               16, 33),
    "pages-of-64": ([1, 40, 0, 7], [130, 100, 0, 7], 40, 16, 4, 64, None),
    # chip_smoke.py phase 3's decode batch
    "decode-batch-of-phase-3": ([1] * 8, [100, 173, 256, 311, 400, 467, 555,
                                          640], 1, 16, 16, 32, 20),
    # q_len 0 rows around a live one, and a row longer than its 3-page table
    "empty-rows-and-row-past-its-table": ([0, 5, 0, 1], [0, 9, 40, 70], 5, 16,
                                          4, 16, 3),
}


def _case(q_lens, kv_lens, C, hq, hkv, bs, nb, D=16, seed=0):
    rng = np.random.RandomState(seed + sum(kv_lens) + C + hkv + bs)
    R = len(q_lens)
    need = max(-(-k // bs) for k in kv_lens)
    nb = nb or max(need, 1)
    NB = R * nb + 1
    tables = np.zeros((R, nb), np.int32)
    free = list(rng.permutation(np.arange(1, NB)))
    for r in range(R):
        for j in range(nb):      # every slot a distinct page (the table's
            tables[r, j] = free.pop()   # width, not the row's use, decides)
    return dict(q=rng.randn(R, C, hq, D).astype(np.float32),
                k_pool=rng.randn(hkv, NB, bs, D).astype(np.float32),
                v_pool=rng.randn(hkv, NB, bs, D).astype(np.float32),
                block_tables=tables,
                q_lens=np.asarray(q_lens, np.int32),
                kv_lens=np.asarray(kv_lens, np.int32),
                scale=1.0 / np.sqrt(D))


def _matches_jax(name, case, dtype):
    names = ("q", "k_pool", "v_pool", "block_tables", "q_lens", "kv_lens")
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jargs = [jnp.asarray(case[n]) for n in names]
    targs = [torch.from_numpy(case[n]) for n in names]
    for i in range(3):
        jargs[i] = jargs[i].astype(jdtype)
        targs[i] = targs[i].to(dtype)
    ref = np.asarray(jax_rpa(*jargs, case["scale"]).astype(jnp.float32))
    n = RPA.ragged_paged_attention.LAUNCHES
    out = RPA.ragged_paged_attention(*targs, case["scale"])
    assert RPA.ragged_paged_attention.LAUNCHES == n
    assert out.dtype == dtype and out.shape == targs[0].shape
    got = out.float().numpy()
    assert np.isfinite(got).all()
    rel = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-9)
    assert rel <= TOL[dtype], (name, rel)
    for r, ql in enumerate(case["q_lens"]):
        assert (got[r, ql:] == 0).all(), (name, r)   # columns past q_len


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_at_tile_and_split_edges(name, dtype):
    _matches_jax(name, _case(*CASES[name]), dtype)


# decode rows across a page (16) and a key tile, and a mixed batch whose
# q_len * g (g = 4) sits on both sides of 64 (the wgmma kernels' block)
WIDE_CASES = {
    "decode-gqa-16-4": ([1, 1, 1, 1], [15, 33, 64, 97], 1, 16, 4, 16, None),
    "mixed-gqa-16-4-qlen-g-across-64": ([15, 16, 17, 1], [15, 80, 130, 200],
                                        20, 16, 4, 16, None),
}


@pytest.mark.parametrize("D", (100, 160, 256))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_plain_matches_jax_at_wide_and_odd_head_dims(name, dtype, D):
    _matches_jax(f"{name} D={D}", _case(*WIDE_CASES[name], D=D), dtype)


# the 16-bit kernel's D_pad 192 and 256: q_len * g on both sides of 64 (GQA
# 16/4, q_len 15 / 16 / 17), kv_len on both sides of a page and of a 64-key
# tile with pages of 16 and of 32
WGMMA_WIDE_CASES = {
    "gqa-16-4-qlen-g-across-64": ([15, 16, 17, 1], [15, 80, 130, 200], 20,
                                  16, 4, 16, None),
    "kv-across-page-and-tile-bs-16": ([1] * 6, [15, 16, 17, 63, 64, 65], 1,
                                      16, 4, 16, None),
    "kv-across-page-and-tile-bs-32": ([1] * 6, [31, 32, 33, 63, 64, 65], 1,
                                      16, 4, 32, None),
}


@pytest.mark.parametrize("D", (192, 256))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("name", list(WGMMA_WIDE_CASES))
def test_plain_matches_jax_at_wgmma_wide_tile_edges(name, dtype, D):
    _matches_jax(f"{name} D={D}", _case(*WGMMA_WIDE_CASES[name], D=D), dtype)


QUANT = {"int8": (np.int8, jnp.int8, torch.int8, 127.0),
         "fp8_e4m3": (None, jnp.float8_e4m3fn, torch.float8_e4m3fn, 448.0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("kind", list(QUANT))
def test_plain_matches_jax_over_quantized_pools_at_d256(kind, dtype):
    """int8 / fp8 e4m3 pools with per-(kv head, page) scales at D 256 (the
    card's wgmma kernel for bf16 q, its CUDA-core kernel for fp32 q) against
    the reference's quantized branch, GQA 16/4 with q_len * g on both sides
    of 64 and a decode row, pages of 16."""
    case = _case([15, 16, 17, 1], [15, 80, 130, 200], 20, 16, 4, 16, None,
                 D=256, seed=5)
    npdt, jdt, tdt, qmax = QUANT[kind]
    rng = np.random.RandomState(6)
    pools = []
    for name in ("k_pool", "v_pool"):
        if npdt is not None:
            vals = rng.randint(-127, 128, case[name].shape).astype(np.int8)
            pools.append((jnp.asarray(vals), torch.from_numpy(vals)))
        else:     # values on the e4m3 grid, exact in both packages
            t = torch.from_numpy(np.clip(rng.randn(*case[name].shape) * 100,
                                         -448, 448).astype(np.float32))
            t = t.to(tdt)
            pools.append((jnp.asarray(t.float().numpy()).astype(jdt), t))
    hkv, NB = case["k_pool"].shape[:2]
    scales = [(rng.rand(hkv, NB) + 0.5).astype(np.float32) for _ in range(2)]
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rest = ("block_tables", "q_lens", "kv_lens")
    ref = jax_rpa(jnp.asarray(case["q"]).astype(jdtype), pools[0][0],
                  pools[1][0], *(jnp.asarray(case[n]) for n in rest),
                  case["scale"], *(jnp.asarray(sc) for sc in scales))
    ref = np.asarray(ref.astype(jnp.float32))
    n = RPA.ragged_paged_attention.LAUNCHES
    out = RPA.ragged_paged_attention(
        torch.from_numpy(case["q"]).to(dtype), pools[0][1], pools[1][1],
        *(torch.from_numpy(case[n]) for n in rest), case["scale"],
        *(torch.from_numpy(sc) for sc in scales))
    assert RPA.ragged_paged_attention.LAUNCHES == n     # CPU: the plain one
    assert out.dtype == dtype
    got = out.float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() < 0.08, np.abs(got - ref).max()
    for r, ql in enumerate(case["q_lens"]):
        assert (got[r, ql:] == 0).all(), r


def _tf32_wide_cases(bs):
    """q_lens, kv_lens, C, hq, hkv, nb at pages of bs keys: the TF32
    kernel's 16-key tiles at D_pad 192 / 256."""
    nb = -(-544 // bs)                  # a table of about 34 key tiles
    tiles = -(-nb * bs // 16)
    edge = -(-tiles // 2) * 16          # where two splits cut the table
    return {
        # kv_len one short of, at and one past a 16-key tile and a page
        "decode-across-key-tile-and-page": ([1] * 6, [15, 16, 17, bs - 1, bs,
                                                      bs + 1], 1, 16, 4, None),
        # q_len * g (g = 4) on both sides of 64
        "gqa-16-4-mixed": ([15, 16, 17, 1], [15, 80, 130, 200], 20, 16, 4,
                           None),
        # kv_len one short of, at and one past the split edge
        "decode-across-split-edge": ([1] * 4, [edge - 1, edge, edge + 1,
                                               nb * bs], 1, 4, 4, nb),
    }


@pytest.mark.parametrize("pool", ("float", "int8"))
@pytest.mark.parametrize("D", (160, 256))
@pytest.mark.parametrize("bs", (12, 32))
@pytest.mark.parametrize("name", ("decode-across-key-tile-and-page",
                                  "gqa-16-4-mixed",
                                  "decode-across-split-edge"))
def test_plain_fp32_matches_jax_at_tf32_wide_tile_edges(name, bs, D, pool):
    q_lens, kv_lens, C, hq, hkv, nb = _tf32_wide_cases(bs)[name]
    case = _case(q_lens, kv_lens, C, hq, hkv, bs, nb, D=D, seed=11)
    if pool == "float":
        _matches_jax(f"{name} bs={bs} D={D}", case, torch.float32)
        return
    rng = np.random.RandomState(bs + D)
    vals = [rng.randint(-127, 128, case[n].shape).astype(np.int8)
            for n in ("k_pool", "v_pool")]
    hkv, NB = case["k_pool"].shape[:2]
    scales = [(rng.rand(hkv, NB) + 0.5).astype(np.float32) for _ in range(2)]
    rest = ("block_tables", "q_lens", "kv_lens")
    ref = jax_rpa(jnp.asarray(case["q"]), *map(jnp.asarray, vals),
                  *(jnp.asarray(case[n]) for n in rest), case["scale"],
                  *map(jnp.asarray, scales))
    ref = np.asarray(ref)
    n = RPA.ragged_paged_attention.LAUNCHES
    out = RPA.ragged_paged_attention(
        torch.from_numpy(case["q"]), *map(torch.from_numpy, vals),
        *(torch.from_numpy(case[n]) for n in rest), case["scale"],
        *map(torch.from_numpy, scales))
    assert RPA.ragged_paged_attention.LAUNCHES == n     # CPU: the plain one
    got = out.numpy()
    assert out.dtype == torch.float32 and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err < 0.08 and err <= TOL[torch.float32] * np.abs(ref).max(), err
    for r, ql in enumerate(case["q_lens"]):
        assert (got[r, ql:] == 0).all(), r
