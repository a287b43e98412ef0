"""Quantized paged KV-cache pool, int8 or fp8-e4m3 storage (counterpart:
``paddle_tpu/quantization/kv_cache.py``).

Decode attention is bandwidth-bound: per generated token the kernel streams
every referenced KV page. Storing the pool in one byte per element halves
those bytes and doubles the sequences a fixed device-memory budget admits.
Scales live per (layer, kv head, page) in the absmax convention
(dequant = q * scale / qmax, qmax 127 for int8 and 448 for e4m3), so one
scalar dequantizes a whole ``[bs, D]`` page inside the ragged kernel
(``kernels/ragged_paged_attention.py``).

Append semantics: pages accept tokens incrementally, so a page's scale is a
running absmax. When a new token raises it, the page's existing contents are
requantized to the grown scale (q' = round(q * s_old / s_new)) in the same
write that stores the new tokens. A block re-admitted to a new request has
its scales reset to zero first (``reset_page_scales``), so it never inherits
a stale range.

Where the JAX functions return new arrays, these update the pool and the
scales IN PLACE (the engine's pools are the layer views it passes in) and
return the same tensors. The arithmetic is the reference's, op for op:
``torch.round`` rounds half to even as ``jnp.round`` does, and the cast to
``float8_e4m3fn`` rounds to nearest even after a clip to +-448, so the pools
and scales equal the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

from ..enforce import enforce

__all__ = ["kv_cache_dtype", "kv_pool_blocks_for_budget",
           "append_tokens_quantized", "append_plan", "append_planned",
           "reset_page_scales", "KV_CACHE_DTYPES"]

# storage dtypes the pool supports; "auto" in the engine resolves to the
# model compute dtype (unquantized)
KV_CACHE_DTYPES = ("auto", "bf16", "f32", "int8", "fp8_e4m3")

_EPS = 1e-8
_QUANTIZED = (torch.int8, torch.float8_e4m3fn)


def kv_cache_dtype(name):
    """Resolve a ``kv_cache_dtype`` flag / argument value to (torch dtype,
    quantized: bool). ``auto`` is resolved by the caller (the engine) to the
    model dtype."""
    allowed = sorted(set(KV_CACHE_DTYPES) - {"auto"})
    enforce(name in allowed, f"{name!r} not in allowed set {allowed!r}",
            op="kv_cache_dtype", kv_cache_dtype=name)
    if name == "int8":
        return torch.int8, True
    if name == "fp8_e4m3":
        return torch.float8_e4m3fn, True
    return {"bf16": torch.bfloat16, "f32": torch.float32}[name], False


def _qmax(dtype):
    return 127.0 if dtype == torch.int8 else 448.0  # e4m3 finite max


def kv_pool_blocks_for_budget(budget_bytes: int, num_layers: int,
                              num_kv_heads: int, block_size: int,
                              head_dim: int, dtype) -> int:
    """How many pool blocks a fixed device-memory budget admits (k + v
    pools plus, for quantized dtypes, their fp32 per-page scales)."""
    per_block = (2 * num_layers * num_kv_heads * block_size * head_dim
                 * dtype.itemsize)
    if dtype in _QUANTIZED:
        per_block += 2 * num_layers * num_kv_heads * 4  # k+v scale entries
    return int(budget_bytes // per_block)


def reset_page_scales(scales, tables, fresh):
    """Zero the per-page scales of every block in a freshly admitted row's
    table, in place. scales: [L, H, NB] fp32; tables: [R, nb] int32; fresh:
    [R] bool, the rows admitted this step. Other rows route their write at
    block 0 (the reserved scratch block), whose scale is never read."""
    idx = torch.where(fresh[:, None], tables, 0).reshape(-1).long()
    scales[:, :, idx] = 0.0
    return scales


def append_plan(pos0, q_lens, tables, bs, C):
    """Where a quantize-on-append of C-column chunk tiles lands: (blk
    [R, PT], the pool block of each touched page slot; tok_c [R, PT, bs],
    the chunk column that lands in each page cell; valid [R, PT, bs],
    whether one does). It depends on the positions alone, so a pass
    computes it once for every layer's K and V appends (JAX forms it in
    each append, and its compiled program shares it)."""
    R, nb = tables.shape
    dev = tables.device
    # a C-token span starting anywhere touches at most this many pages
    PT = min(nb, (C + bs - 2) // bs + 1)
    p0b = (pos0 // bs).long()
    slot = p0b[:, None] + torch.arange(PT, device=dev)[None, :]   # [R, PT]
    # slots past the table's end (a chunk landing in the last page) route to
    # the scratch block 0: clipping to nb - 1 would alias the row's real last
    # block, and the duplicate write could replace the fresh tokens
    blk = torch.where(slot < nb,
                      torch.gather(tables.long(), 1,
                                   torch.clamp(slot, 0, nb - 1)),
                      torch.zeros_like(slot))                     # [R, PT]
    # which chunk token (if any) lands in each page cell
    gpos = slot[:, :, None] * bs + torch.arange(bs, device=dev)[None, None]
    tok = gpos - pos0.long()[:, None, None]                      # [R, PT, bs]
    valid = (tok >= 0) & (tok < q_lens.long()[:, None, None])
    return blk, torch.clamp(tok, 0, C - 1), valid


def append_planned(pool, scales, val, plan):
    """``append_tokens_quantized`` at the targets of an ``append_plan``
    (made for val's C), in place; returns (pool, scales)."""
    blk, tok_c, valid = plan
    R, C, H, D = val.shape
    qmax = _qmax(pool.dtype)
    # vals_sel[r, u, o] = val[r, tok_c[r, u, o]]: [R, PT, bs, H, D]
    vals_sel = val[torch.arange(R, device=val.device)[:, None, None], tok_c]
    av = torch.where(valid[..., None, None], vals_sel.float().abs(), 0.0)
    vmax = av.amax(dim=(2, 4))                                   # [R, PT, H]
    # read the touched pages and their old scales before any write
    s_old = scales[:, blk]                                       # [H, R, PT]
    pages = pool[:, blk].float()                         # [H, R, PT, bs, D]
    # grow the touched pages' scales (a max is order-free, so pages hit by
    # several tokens, or several idle rows at scratch, are safe)
    scales.scatter_reduce_(1, blk.reshape(1, -1).expand(H, -1),
                           vmax.permute(2, 0, 1).reshape(H, -1), "amax")
    s_new = scales[:, blk]                                       # [H, R, PT]
    ratio = torch.where(s_new > 0, s_old / torch.clamp(s_new, min=_EPS), 1.0)
    requant = pages * ratio[..., None, None]
    vt = vals_sel.permute(3, 0, 1, 2, 4).float()         # [H, R, PT, bs, D]
    q_new = vt * qmax / torch.clamp(s_new, min=_EPS)[..., None, None]
    if pool.dtype == torch.int8:  # fp8 storage keeps fractions
        requant = torch.round(requant)
        q_new = torch.round(q_new)
    q_new = torch.clamp(q_new, -qmax, qmax)
    merged = torch.where(valid[None, :, :, :, None], q_new, requant)
    pool[:, blk] = merged.to(pool.dtype)
    return pool, scales


def append_tokens_quantized(pool, scales, val, pos0, q_lens, tables, bs):
    """Quantize-on-append into one layer's paged pool with per-(head, page)
    running-absmax scales, in place.

    pool: [H, NB, bs, D] int8 / float8_e4m3fn; scales: [H, NB] fp32; val:
    [R, C, H, D] float chunk tiles (row r's tokens occupy columns
    [0, q_lens[r]) and land at positions pos0[r] .. pos0[r] + q_lens[r] - 1);
    tables: [R, nb] int32. Returns (pool, scales), the same tensors. Rows
    with q_len 0 rewrite their own pages unchanged (a ratio-1 requantize);
    idle rows' writes land in the scratch block 0."""
    return append_planned(pool, scales, val, append_plan(
        pos0, q_lens, tables, bs, val.shape[1]))
