"""Unified ragged prefill+decode paged attention (counterpart:
``paddle_tpu/kernels/pallas/ragged_paged_attention.py``
``ragged_paged_attention``, kernel body ``_ragged_kernel``).

The TPU kernel is replaced by a CUDA kernel written by hand for Hopper,
``paddle_tpu_torch/csrc/ragged_paged_attention.cu`` (built for ``sm_90a`` by
``kernels/_build.py`` at first use). Its source note states the design; in
short:

* what bounds it on an H100 SXM (published peaks at its 700 W limit):
  decode rows are bandwidth-bound, each row reading
  ``2 * H_kv * ceil(kv_len/bs) * bs * D * itemsize`` bytes of K/V pages
  against 3.35 TB/s; prefill chunks are bounded by their FLOPs (``4 * D``
  per visible (query head, key) pair) against 989 TFLOP/s bf16;
* what the design does about it: one CUDA block per (row, kv head, tile of
  16 folded (chunk, group) query rows) loops over only that row's pages
  (cut further by the tile's last causal column), reading each page once
  with 16-byte coalesced loads; online softmax in fp32 with the accumulator
  in registers. No load/compute overlap and no tensor cores yet;
* quantized pools (int8 or fp8 e4m3 with fp32 per-(kv head, page) scales,
  ``quantization/kv_cache.py``) are dequantized as ``v * scale / qmax`` in
  the load into the fp32 shared tile, so a decode row reads half the bytes
  of a bf16 pool.

``ragged_paged_attention`` is the wrapper: a CUDA tensor goes to the kernel
(or the call raises), a CPU tensor goes to ``ragged_paged_attention_plain``,
plain PyTorch with the same signature. ``ragged_paged_attention.LAUNCHES``
counts kernel launches (not plain calls), so a run can show its main path
went through the kernel.
"""

from __future__ import annotations

import torch

__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pool element codes of the C entry: 0 = q's float dtype, then the
# quantized storage dtypes with the top of their grid (qmax)
_POOL_CODE = {torch.int8: 1, torch.float8_e4m3fn: 2}
_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


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


def ragged_paged_attention(q, k_pool, v_pool, block_tables, q_lens, kv_lens,
                           scale: float, k_scales=None, v_scales=None):
    """q: [R, C, H_q, D] (row r's chunk occupies columns [0, q_lens[r]));
    pools: [H_kv, num_blocks, bs, D] of q's dtype, or int8 / float8_e4m3fn
    with ``k_scales`` / ``v_scales``: fp32 [H_kv, num_blocks] per-page absmax
    scales (dequantized as ``q * scale / qmax``, qmax 127 or 448);
    block_tables: [R, nb] int32; q_lens: [R] int32 (0 = inactive row);
    kv_lens: [R] int32, the TOTAL kv length including this chunk (query c
    sits at absolute position kv_lens - q_lens + c) -> [R, C, H_q, D] in q's
    dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise: TypeError or ValueError for a dtype, device or layout the kernel
    does not take, RuntimeError for a shape the kernel's C entry refuses
    (head_dim, alignment, shared memory) or a failed launch."""
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
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ptt_ragged_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), q_lens.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), k_scales.data_ptr() if pool_code else None,
            v_scales.data_ptr() if pool_code else None, R, C, hq, hkv, NB,
            bs, D, block_tables.shape[1], float(scale), _DTYPE_CODE[q.dtype],
            pool_code, stream)
    check(code, f"ragged_paged_attention launch (R={R} C={C} H_q={hq} "
          f"H_kv={hkv} bs={bs} D={D} {q.dtype}, {k_pool.dtype} pools)")
    ragged_paged_attention.LAUNCHES += 1
    return out


ragged_paged_attention.LAUNCHES = 0
