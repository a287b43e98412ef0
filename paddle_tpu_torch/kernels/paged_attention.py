"""Decode-only paged attention (counterpart:
``paddle_tpu/kernels/pallas/paged_attention.py`` ``paged_decode_attention``,
kernel body ``_decode_kernel``): the attention of the two-program engine's
decode burst.

The TPU kernel is replaced by CUDA kernels written by hand for Hopper
(built for ``sm_90a`` by ``kernels/_build.py`` at first use), on two routes
that ``kernel_plan`` reports. Decode is bandwidth-bound (a row reads its
K / V pages once and does about one FLOP per byte), so both read each used
page once and never a table slot past the row's length:

* ``"bulk-ring"`` (``paddle_tpu_torch/csrc/paged_decode_hopper.cu``): fp32,
  bf16 and fp16 with a head dim of whole 16-byte words up to 256 (a
  multiple of 4 in fp32, of 8 in 16 bits), 16-byte aligned pools and pages
  of at most 128 keys. A row's pages are split into contiguous ranges over
  blocks (the count from B x H_kv and the table width, on the host); in a
  block a producer warp carries whole pages (or, where four pages' K and V
  do not fit the ring, parts of ``stage_keys`` keys) into a shared-memory
  ring with 1-D bulk copies, four consumer warps take different pages with
  a lane per key for q . k and D / 32 columns a lane for p . v (fp32 FFMA,
  no TF32), and the last split to finish merges the others (an atomic
  ticket) in a fixed order. The splits' fp32 scratch and the tickets come
  from this wrapper;
* ``"fp32-tiles"`` (``paddle_tpu_torch/csrc/paged_decode_attention.cu``):
  other head dims up to 256, misaligned pools and pages above 128 keys:
  one block per (row, kv head, chunk of the group) walks the row's live
  keys 32 at a time in fp32 shared tiles on the CUDA cores.

Both take any group size g = H_q / H_kv; online softmax in fp32, fp32
accumulation.

``paged_decode_attention`` is the wrapper: a CUDA tensor goes to a kernel
(or the call raises), a CPU tensor goes to ``paged_decode_attention_plain``,
plain PyTorch with the same signature. ``paged_decode_attention.LAUNCHES``
counts kernel launches (not plain calls), ``.ROUTES`` the same by route.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "kernel_plan"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DESIGNS = {0: "fp32-tiles", 2: "bulk-ring"}
MAX_HEAD_DIM = 256


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
    """What the kernels take: one card, q fp32, bf16 or fp16 [B, H_q, D]
    with a unit stride over D and D <= 256, H_q a multiple of H_kv,
    contiguous pools of q's dtype, int32 tables and lengths."""
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
    if D > MAX_HEAD_DIM or hq % k_pool.shape[0]:
        raise ValueError(f"paged_decode_attention takes head dims up to "
                         f"{MAX_HEAD_DIM} and H_q a multiple of H_kv (D={D}, "
                         f"H_q={hq}, H_kv={k_pool.shape[0]})")


@functools.lru_cache(maxsize=256)
def _plan(device_index, B, hq, hkv, bs, D, nb, code, aligned):
    """The built library's plan for one set of shapes (cached: the wrapper
    reads it on every launch and passes its split count on)."""
    import ctypes
    from ._build import load_library
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device_index):
        status = load_library().ptt_paged_decode_plan(
            B, hq, hkv, bs, D, nb, code, int(aligned), out)
    if status != 0:
        raise ValueError(f"kernel_plan: no paged decode kernel for code "
                         f"{code}, H_q={hq} H_kv={hkv} D={D} bs={bs}")
    return dict(design=_DESIGNS[out[0]], rows=out[1], stages=out[2],
                splits=out[3], max_splits=out[4], stage_keys=out[5])


def _plan_of(q, k_pool, block_tables, v_pool):
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel_plan: no paged decode kernel for {q.dtype}")
    B, hq, D = q.shape
    hkv, _, bs, _ = k_pool.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (k_pool, v_pool)
                  if t is not None)
    return _plan(q.device.index, B, hq, hkv, bs, D, block_tables.shape[1],
                 _DTYPE_CODE[q.dtype], aligned)


def kernel_plan(q, k_pool, block_tables, v_pool=None) -> dict:
    """How the built library serves a call with these tensors' shapes,
    dtypes and pool alignment (no data is read): ``design`` ("bulk-ring" or
    "fp32-tiles", the two routes of the module note), ``rows`` (the group's
    query rows a block), ``stages`` (pages the ring holds; 0 off the ring),
    ``stage_keys`` (the keys a stage carries: the page, or a part of it
    where four pages do not fit the ring; the 32-key tile off the ring),
    ``splits`` (of a row's pages, from the table width) and ``max_splits``.
    Read from the library's ``ptt_paged_decode_plan``; it builds the library
    on first use."""
    return dict(_plan_of(q, k_pool, block_tables, v_pool))


def paged_decode_attention(q, k_pool, v_pool, block_tables, seq_lens,
                           scale: float, splits=None):
    """q: [B, H_q, D] (any batch and head strides); pools:
    [H_kv, num_blocks, bs, D]; block_tables: [B, nb] int32; seq_lens: [B]
    int32 (keys 0 .. len - 1 of the row's table pages are visible; 0 gives
    zeros) -> [B, H_q, D] in q's dtype. ``splits``: on the "bulk-ring"
    route, the splits of a row's pages, 1 to 16 (``kernel_plan``'s when
    None, which callers take; a count is given to test the merge and to time
    the counts); the other route takes None or 1.

    CPU tensors take the plain version; CUDA tensors launch a kernel or
    raise: TypeError or ValueError for a dtype, device, layout or shape the
    kernels do not take, RuntimeError for a split count the C entry refuses
    or a failed launch."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            seq_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    _check_cuda(q, k_pool, v_pool, block_tables, seq_lens)
    from ._build import check, load_library, zeroed_counters
    B, hq, D = q.shape
    hkv, NB, bs, _ = k_pool.shape
    plan = _plan_of(q, k_pool, block_tables, v_pool)
    n_split = plan["splits"] if splits is None else int(splits)
    out = torch.empty(B, hq, D, dtype=q.dtype, device=q.device)
    part = tickets = None
    if plan["design"] == "bulk-ring" and n_split > 1:
        g = hq // hkv
        slots = B * hkv * -(-g // plan["rows"])
        part = torch.empty(slots * n_split * plan["rows"] * (D + 2),
                           dtype=torch.float32, device=q.device)
        # one merge ticket a (row, kv head, chunk)
        tickets = zeroed_counters("paged_decode", q.device, slots)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = load_library().ptt_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(), B, hq, hkv, NB,
            bs, D, block_tables.shape[1], q.stride(0), q.stride(1),
            n_split, float(scale), _DTYPE_CODE[q.dtype], stream)
    check(code, f"paged_decode_attention launch (B={B} H_q={hq} H_kv={hkv} "
          f"bs={bs} D={D} {q.dtype}, {plan['design']}, splits {n_split})")
    paged_decode_attention.LAUNCHES += 1
    paged_decode_attention.ROUTES[plan["design"]] += 1
    return out


paged_decode_attention.LAUNCHES = 0
paged_decode_attention.ROUTES = {d: 0 for d in _DESIGNS.values()}
