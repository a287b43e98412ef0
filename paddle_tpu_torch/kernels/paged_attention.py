"""Decode-only paged attention (counterpart:
``paddle_tpu/kernels/pallas/paged_attention.py`` ``paged_decode_attention``,
kernel body ``_decode_kernel``): the attention of the two-program engine's
decode burst.

The TPU kernel is replaced by a CUDA kernel written by hand for Hopper,
``paddle_tpu_torch/csrc/paged_decode_attention.cu`` (built for ``sm_90a`` by
``kernels/_build.py`` at first use). Its source note states the design; in
short: decode is bandwidth-bound (a row reads its K/V pages once and does
about one FLOP per byte), so one CUDA block per (row, kv head) carries the
group's query heads and walks only the row's used pages, reading each once
with 16-byte loads; online softmax in fp32, fp32 accumulation.

``paged_decode_attention`` is the wrapper: a CUDA tensor goes to the kernel
(or the call raises), a CPU tensor goes to ``paged_decode_attention_plain``,
plain PyTorch with the same signature. ``paged_decode_attention.LAUNCHES``
counts kernel launches (not plain calls).
"""

from __future__ import annotations

import torch

__all__ = ["paged_decode_attention", "paged_decode_attention_plain"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, seq_lens,
                                 scale: float):
    """Plain PyTorch version of the kernel: gather each row's table pages,
    masked softmax in fp32. Same contract as ``paged_decode_attention``."""
    B, hq, D = q.shape
    hkv, _, bs, _ = k_pool.shape
    nb = block_tables.shape[1]
    g = hq // hkv
    tables = block_tables.long()
    # [H_kv, B, nb * bs, D]: every table slot, those at or past len masked
    k = k_pool[:, tables].reshape(hkv, B, nb * bs, D).float()
    v = v_pool[:, tables].reshape(hkv, B, nb * bs, D).float()
    s = torch.einsum("bhgd,hbkd->bhgk", q.float().reshape(B, hkv, g, D),
                     k) * scale
    col = torch.arange(nb * bs, device=q.device)
    ok = col[None, :] < seq_lens.long()[:, None]                 # [B, K]
    s = torch.where(ok[:, None, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1) * ok[:, None, None]
    out = torch.einsum("bhgk,hbkd->bhgd", p, v)
    live = ok.any(-1)[:, None, None, None]                       # len 0 -> 0
    out = torch.where(live, out, torch.zeros_like(out))
    return out.reshape(B, hq, D).to(q.dtype)


def _check_cuda(q, k_pool, v_pool, block_tables, seq_lens):
    """What the kernel takes: one card, q fp32, bf16 or fp16 [B, H_q, D]
    with a unit stride over D, contiguous pools of q's dtype, int32 tables
    and lengths. Head dim, group size and alignment are the C entry's checks."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_decode_attention kernel takes float32, "
                        f"bfloat16 or float16, got {q.dtype}")
    if q.dim() != 3 or q.stride(2) != 1:
        raise ValueError(f"q must be [B, H_q, D] with a unit stride over D "
                         f"(shape {tuple(q.shape)}, strides {q.stride()})")
    B, hq, D = q.shape
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.dim() != 4 or t.shape != k_pool.shape or t.shape[3] != D:
            raise ValueError(f"{name} shape {tuple(t.shape)} does not fit q "
                             f"{tuple(q.shape)} and k_pool "
                             f"{tuple(k_pool.shape)}")
    for name, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name != "q" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or seq_lens.shape != (B,):
        raise ValueError(f"block_tables [B, nb] and seq_lens [B] expected "
                         f"for B={B}")


def paged_decode_attention(q, k_pool, v_pool, block_tables, seq_lens,
                           scale: float):
    """q: [B, H_q, D] (any batch and head strides); pools:
    [H_kv, num_blocks, bs, D]; block_tables: [B, nb] int32; seq_lens: [B]
    int32 (keys 0 .. len - 1 of the row's table pages are visible; 0 gives
    zeros) -> [B, H_q, D] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise: TypeError or ValueError for a dtype, device or layout the kernel
    does not take, RuntimeError for a shape its C entry refuses or a failed
    launch."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            seq_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    _check_cuda(q, k_pool, v_pool, block_tables, seq_lens)
    from ._build import check, load_library
    B, hq, D = q.shape
    hkv, NB, bs, _ = k_pool.shape
    out = torch.empty(B, hq, D, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = load_library().ptt_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), B,
            hq, hkv, NB, bs, D, block_tables.shape[1], q.stride(0),
            q.stride(1), float(scale), _DTYPE_CODE[q.dtype], stream)
    check(code, f"paged_decode_attention launch (B={B} H_q={hq} H_kv={hkv} "
          f"bs={bs} D={D} {q.dtype})")
    paged_decode_attention.LAUNCHES += 1
    return out


paged_decode_attention.LAUNCHES = 0
