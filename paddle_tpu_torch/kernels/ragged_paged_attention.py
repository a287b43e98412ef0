"""Unified ragged prefill+decode paged attention (counterpart:
``paddle_tpu/kernels/pallas/ragged_paged_attention.py``
``ragged_paged_attention``, kernel body ``_ragged_kernel``).

The TPU kernel is replaced by CUDA kernels written by hand for Hopper (built
for ``sm_90a`` by ``kernels/_build.py`` at first use), on routes that
``kernel_plan`` reports:

* ``"wgmma+tma"`` (``paddle_tpu_torch/csrc/ragged_paged_attention_hopper.cu``):
  bf16 / fp16 queries over pools of their dtype or int8 / fp8 e4m3 pools
  (fp32 per-(kv head, page) absmax scales, ``quantization/kv_cache.py``),
  a page size that is a multiple of 8, D <= 256 a whole number of 16-byte
  words of the pool type (read into D_pad 64, 128, 192 or 256). A block
  owns 64 folded (chunk, group) query rows of one (row, kv head); S = Q K^T
  and O += P V run on wgmma with the scores and the output in registers
  (128 fp32 a consumer thread at D_pad 256, one block an SM); the pages come
  through a two-stage TMA ring, the block reading ``block_tables[r, j]``
  itself (a quantized page is dequantized as ``v * scale / qmax`` by the
  consumer into the 16-bit tile wgmma reads, so a decode row reads half the
  bytes of a bf16 pool). When the grid leaves most SMs idle (a few long
  decode rows), each row's key tiles are split over contiguous ranges (the
  count from the table width, on the host), the splits write partial O, m
  and l into fp32 scratch that this wrapper allocates, and a second small
  kernel merges them;
* ``"wgmma+gather"`` (the same file): the same kernel at a page size that
  is not a multiple of 8 (any size, pages larger than a tile too), the
  pages gathered into the same stages key row by key row by the producer
  warp's ``cp.async`` copies, since no TMA box of whole 8-row swizzle atoms
  fits such a page;
* ``"wgmma-3xtf32"``
  (``paddle_tpu_torch/csrc/ragged_paged_attention_tf32_hopper.cu``): fp32
  queries over fp32, int8 or fp8 e4m3 pools, any page size, D <= 256, on
  the TF32 tensor cores: each fp32 operand split into two TF32 halves and
  every product taken as three (about 2^-21 of a product), the same block
  and splits with key tiles of 32 (of 16 at D_pad 192 and 256, where a
  split element's 8 bytes fill shared memory sooner), the pages always
  gathered key row by key row by ``cp.async`` (a TMA ring ran no faster
  here), then split (V transposed, a 1-byte page dequantized to the
  reference's fp32 value first) in shared memory by the producer
  warpgroup;
* ``"fp32"`` (``paddle_tpu_torch/csrc/ragged_paged_attention.cu``): what
  stays on the CUDA cores up to D 256: D not a whole number of 16-byte
  words (fp32 D 99 or 250), pools that are not 16-byte aligned. One block
  per (row, kv head, 16 folded rows) walks the row's pages in fp32 shared
  tiles.

What bounds the function on an H100 SXM (published peaks at its 700 W
limit): decode rows are bandwidth-bound, each row needing
``2 * H_kv * kv_len * D * itemsize`` bytes of K/V rows against 3.35
TB/s; prefill chunks do ``4 * D`` FLOPs per visible (query
head, key) pair against 989 TFLOP/s bf16 (495 TF32, three times over, in
fp32).

``ragged_paged_attention`` is the wrapper: a CUDA tensor goes to a kernel
(or the call raises), a CPU tensor goes to ``ragged_paged_attention_plain``,
plain PyTorch with the same signature. ``ragged_paged_attention.LAUNCHES``
counts wrapper calls that launched (the split route's merge kernel rides in
the same call), and ``.ROUTES`` the same by route, so a run can show its
main path went through the kernel it expected.
"""

from __future__ import annotations

import torch

__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain",
           "kernel_plan"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pool element codes of the C entry: 0 = q's float dtype, then the
# quantized storage dtypes with the top of their grid (qmax)
_POOL_CODE = {torch.int8: 1, torch.float8_e4m3fn: 2}
_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}
_DESIGNS = {0: "fp32", 2: "wgmma+tma", 3: "wgmma-3xtf32", 4: "wgmma+gather"}
# the widest head the kernels take (the 16-bit wgmma kernel's D_pad 256);
# the reference's kernel takes any: D above 256 is ROADMAP Queue 2 K15
MAX_HEAD_DIM = 256


def _pages(pool, scales, tables):
    """[H_kv, R, nb, bs, D] fp32 pages of every table slot, dequantized as
    ``q * (scale / qmax)`` (the reference's order) when ``scales`` is
    given."""
    pages = pool[:, tables].float()
    if scales is None:
        return pages
    mul = scales.float()[:, tables] / _QMAX[pool.dtype]            # [H, R, nb]
    return pages * mul[..., None, None]


def ragged_paged_attention_plain(q, k_pool, v_pool, block_tables, q_lens,
                                 kv_lens, scale: float, k_scales=None,
                                 v_scales=None):
    """Plain PyTorch version of the kernel: gather each row's table pages
    (dequantized when scales are given), masked softmax in fp32. Same
    contract as ``ragged_paged_attention``."""
    R, C, hq, D = q.shape
    hkv, _, bs, _ = k_pool.shape
    nb = block_tables.shape[1]
    g = hq // hkv
    tables = block_tables.long()
    # [H_kv, R, nb * bs, D]: every table slot, past-end ones masked below
    k = _pages(k_pool, k_scales, tables).reshape(hkv, R, nb * bs, D)
    v = _pages(v_pool, v_scales, tables).reshape(hkv, R, nb * bs, D)
    qf = q.float().reshape(R, C, hkv, g, D)
    s = torch.einsum("rchgd,hrkd->rhgck", qf, k) * scale
    c = torch.arange(C, device=q.device)
    col = torch.arange(nb * bs, device=q.device)
    qpos = (kv_lens - q_lens).long()[:, None] + c[None, :]          # [R, C]
    ok = ((c[None, :] < q_lens.long()[:, None])[:, :, None]
          & (col[None, None, :] <= qpos[:, :, None]))                # [R, C, K]
    s = torch.where(ok[:, None, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1) * ok[:, None, None]
    out = torch.einsum("rhgck,hrkd->rchgd", p, v)
    live = ok.any(-1)[:, :, None, None, None]                        # no key -> 0
    out = torch.where(live, out, torch.zeros_like(out))
    return out.reshape(R, C, hq, D).to(q.dtype)


def _check_cuda(q, k_pool, v_pool, block_tables, q_lens, kv_lens,
                k_scales=None, v_scales=None):
    R, C, hq, D = q.shape
    hkv, NB, _, D2 = k_pool.shape
    dev = q.device
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"ragged_paged_attention kernel takes float32, "
                        f"bfloat16 or float16, got {q.dtype}")
    quantized = k_pool.dtype in _POOL_CODE
    if (k_scales is None) != (v_scales is None) or \
            quantized != (k_scales is not None):
        raise TypeError(f"{k_pool.dtype} pools take k_scales and v_scales "
                        f"exactly when they are int8 or float8_e4m3fn")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != (k_pool.dtype if quantized else q.dtype):
            raise TypeError(f"{name} dtype {t.dtype} does not fit q dtype "
                            f"{q.dtype} and k_pool dtype {k_pool.dtype}")
        if t.shape != k_pool.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != k_pool "
                             f"shape {tuple(k_pool.shape)}")
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("block_tables", block_tables), ("q_lens", q_lens),
             ("kv_lens", kv_lens)]
    if quantized:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if t.dtype != torch.float32 or t.shape != (hkv, NB):
                raise TypeError(f"{name} must be float32 [{hkv}, {NB}], got "
                                f"{t.dtype} {tuple(t.shape)}")
        named += [("k_scales", k_scales), ("v_scales", v_scales)]
    for name, t in (("block_tables", block_tables), ("q_lens", q_lens),
                    ("kv_lens", kv_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D2 != D or hq % hkv:
        raise ValueError(f"q [R, C, {hq}, {D}] does not fit pools "
                         f"[{hkv}, NB, bs, {D2}]")
    if block_tables.dim() != 2 or block_tables.shape[0] != R \
            or q_lens.shape != (R,) or kv_lens.shape != (R,):
        raise ValueError("block_tables [R, nb], q_lens [R], kv_lens [R] "
                         f"expected for R={R}")


def _check_head_dim(D):
    if D > MAX_HEAD_DIM:
        raise ValueError(f"ragged_paged_attention: head_dim {D} > "
                         f"{MAX_HEAD_DIM} has no kernel (ROADMAP Queue 2 "
                         f"K15: head dims above 256)")


def kernel_plan(q, k_pool, block_tables, v_pool=None) -> dict:
    """How the built library serves a call with these tensors' shapes,
    dtypes and pool alignment (no data is read): ``design`` ("wgmma+tma",
    "wgmma+gather", "wgmma-3xtf32" or "fp32", the routes of the module
    note: which kernel, and which page ring),
    ``query_rows`` (folded rows a block), ``keys`` (keys a tile) and
    ``splits`` (of a row's key tiles, from the table width). Read from the
    library's ``ptt_ragged_plan``; it builds the library on first use."""
    import ctypes
    from ._build import load_library
    R, C, hq, D = q.shape
    hkv, _, bs, _ = k_pool.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel_plan: no ragged kernel for {q.dtype}")
    _check_head_dim(D)
    aligned = all(t.data_ptr() % 16 == 0 for t in (k_pool, v_pool)
                  if t is not None)
    out = (ctypes.c_int * 4)()
    code = load_library().ptt_ragged_plan(
        R, C, hq, hkv, bs, D, block_tables.shape[1], _DTYPE_CODE[q.dtype],
        _POOL_CODE.get(k_pool.dtype, 0), int(aligned), out)
    if code != 0:
        raise ValueError(f"kernel_plan: no ragged kernel for {q.dtype} q, "
                         f"{k_pool.dtype} pools")
    return dict(design=_DESIGNS[out[0]], query_rows=out[1], keys=out[2],
                splits=out[3])


def ragged_paged_attention(q, k_pool, v_pool, block_tables, q_lens, kv_lens,
                           scale: float, k_scales=None, v_scales=None,
                           splits=None):
    """q: [R, C, H_q, D] (row r's chunk occupies columns [0, q_lens[r]));
    pools: [H_kv, num_blocks, bs, D] of q's dtype, or int8 / float8_e4m3fn
    with ``k_scales`` / ``v_scales``: fp32 [H_kv, num_blocks] per-page absmax
    scales (dequantized as ``q * scale / qmax``, qmax 127 or 448);
    block_tables: [R, nb] int32; q_lens: [R] int32 (0 = inactive row);
    kv_lens: [R] int32, the TOTAL kv length including this chunk (query c
    sits at absolute position kv_lens - q_lens + c) -> [R, C, H_q, D] in q's
    dtype. ``splits``: on the wgmma routes (TMA or gathered ring), the
    splits of a row's key tiles, 1 to 16 (``kernel_plan``'s when None,
    which callers take; a count is given to test the merge and to time the
    counts, ``profiler/ragged_splits.py``); the "fp32" route takes None or
    1.

    CPU tensors take the plain version; CUDA tensors launch a kernel or
    raise: TypeError or ValueError for a dtype, device, layout or head_dim
    (above 256) the kernels do not take, RuntimeError for a shape the
    kernels' C entry refuses (shared memory, a split count) or a failed
    launch."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pool, v_pool, block_tables,
                                            q_lens, kv_lens, scale, k_scales,
                                            v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: unsupported device "
                         f"{q.device}")
    _check_cuda(q, k_pool, v_pool, block_tables, q_lens, kv_lens, k_scales,
                v_scales)
    from ._build import check, load_library
    lib = load_library()
    R, C, hq, D = q.shape
    hkv, NB, bs, _ = k_pool.shape
    pool_code = _POOL_CODE.get(k_pool.dtype, 0)
    plan = kernel_plan(q, k_pool, block_tables, v_pool)
    n_split = plan["splits"] if splits is None else int(splits)
    if q.data_ptr() % 16:
        q = q.clone()     # the wgmma routes read q in 16-byte words
    out = torch.empty_like(q)
    part_o = part_ml = None
    if n_split > 1:
        # the splits' fp32 scratch: O [blocks, 64, D], then (m, l) [blocks,
        # 64, 2], in one buffer
        rows = (R * hkv * -(-C * (hq // hkv) // plan["query_rows"]) * n_split
                * plan["query_rows"])
        scratch = torch.empty(rows * (D + 2), dtype=torch.float32,
                              device=q.device)
        part_o, part_ml = scratch[:rows * D], scratch[rows * D:]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ptt_ragged_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), q_lens.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), k_scales.data_ptr() if pool_code else None,
            v_scales.data_ptr() if pool_code else None,
            None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(), R, C, hq, hkv,
            NB, bs, D, block_tables.shape[1], n_split, float(scale),
            _DTYPE_CODE[q.dtype], pool_code, stream)
    check(code, f"ragged_paged_attention launch (R={R} C={C} H_q={hq} "
          f"H_kv={hkv} bs={bs} D={D} {q.dtype}, {k_pool.dtype} pools, "
          f"{plan['design']}, splits {n_split})")
    ragged_paged_attention.LAUNCHES += 1
    ragged_paged_attention.ROUTES[plan["design"]] += 1
    return out


ragged_paged_attention.LAUNCHES = 0
ragged_paged_attention.ROUTES = {d: 0 for d in _DESIGNS.values()}
