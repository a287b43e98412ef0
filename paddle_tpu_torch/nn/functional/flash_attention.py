"""Attention ops (counterpart: ``paddle_tpu/nn/functional/flash_attention.py``
``_sdpa_reference``, ``scaled_dot_product_attention``, ``flash_attention``,
``flash_attn_unpadded``, ``flashmask_attention``, with the dispatch of
``paddle_tpu/kernels/pallas/register.py`` ``_sdpa_pallas``,
``_unpadded_supported``, ``_flash_attn_unpadded_pallas``,
``_flashmask_supported`` and ``_flashmask_pallas``).

``scaled_dot_product_attention`` is the registry op the model calls. The JAX
package sends it to the Pallas flash kernel on the TPU when its gate
(``kernels/pallas/flash_attention.py`` ``supported``) allows, and to the
composed ``_sdpa_reference`` otherwise. The port decides by device and
shape, never on failure: CUDA tensors with a head dim up to 256
(``MAX_HEAD_DIM``) go to the flash kernels (``kernels/flash_attention.py``,
fp32, bf16 or fp16) or the call raises; a head dim above 256 goes to
``_sdpa_reference`` on the card, as the JAX gate sends it there, and is
counted in ``scaled_dot_product_attention.COMPOSED``; CPU tensors go to
``_sdpa_reference``. The kernels take every sequence length and any mask
that broadcasts to ``[B, H, Sq, Sk]``, together with segment ids and
dropout, so the JAX gate's ``S % 128`` and mask-shape rules (TPU tiling
rules) have no counterpart. Layouts are ``[B, S, H, D]``.

Dropout in training draws one seed per call as a Python int from the
caller's CPU generator (``paddle_tpu_torch.random``; the JAX
``_dropout_seed`` draws it from the framework key), so the card never
waits for the host.

``flashmask_attention`` sends the forms the JAX registry sends to Pallas
(no rows, or causal rows with C 1 or 2) to the flash kernels' flashmask and
window operands on the card; the bidirectional forms build the dense
keep-mask as JAX composes it and go through
``scaled_dot_product_attention`` (on the card, the bias kernels; counted in
``flashmask_attention.DENSE_MASK``). ``sdp_kernel`` (ROADMAP Queue 1 item
4, the op registry) raises NotImplementedError.
"""

from __future__ import annotations

import torch

from ... import random as _random
from ...enforce import enforce_in
from ...kernels.flash_attention import MAX_HEAD_DIM
from ...kernels.flash_attention import flash_attention as _flash_kernels

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "flashmask_attention", "sdp_kernel"]


def _sdpa_reference(query, key, value, attn_mask=None, dropout_p=0.0,
                    is_causal=False, scale=None, training=True,
                    segment_ids=None, generator=None):
    """Composed attention. q [B, S, H, D]; k / v may carry fewer (GQA) heads
    ([B, S, H_kv, D], H % H_kv == 0), repeated here. ``attn_mask`` (bool
    keep-mask or additive float) is a constant: no gradient flows into it.
    ``segment_ids`` int [B, S]: position i attends to j only within one
    segment. A fully masked query row gives zeros, not a uniform average.
    Dropout draws its keep-mask from ``generator`` (a CPU generator; None:
    the framework's current one)."""
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=query.device)
        seg_mask = (seg[:, :, None] == seg[:, None, :])[:, None]  # [B,1,S,S]
        attn_mask = (seg_mask if attn_mask is None
                     else seg_mask & attn_mask
                     if attn_mask.dtype == torch.bool
                     else torch.where(seg_mask, attn_mask, -1e30))
    if key.shape[2] != query.shape[2]:
        g = query.shape[2] // key.shape[2]
        key = key.repeat_interleave(g, dim=2)
        value = value.repeat_interleave(g, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))  # [B, H, S, D]
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * s
    if is_causal:
        q_len, k_len = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(q_len, k_len, dtype=torch.bool,
                          device=q.device).tril(k_len - q_len)
        logits = logits.masked_fill(~mask, -1e30)
    if attn_mask is not None:
        attn_mask = attn_mask.detach()
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, -1e30)
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if is_causal or attn_mask is not None:
        # a fully masked row softmaxes to a uniform average of V: zeros
        # instead (the flash kernel's dead-row contract)
        probs = probs.masked_fill(
            logits.amax(-1, keepdim=True) <= -1e29, 0.0)
    if dropout_p > 0.0 and training:
        keep = 1.0 - dropout_p
        gen = _random.device_generator(probs.device, generator)
        m = torch.rand(probs.shape, generator=gen, device=probs.device) < keep
        probs = torch.where(m, probs / keep, 0.0).to(probs.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return out.transpose(1, 2)                                  # [B, S, H, D]


def _composed_here(query):
    """The route, by device and shape alone: True for the composed path (a
    CPU tensor, or a head dim above the kernels' 256, counted), False for
    the flash kernels."""
    if query.device.type == "cpu":
        return True
    if query.shape[-1] > MAX_HEAD_DIM:
        scaled_dot_product_attention.COMPOSED += 1
        return True
    return False


def _dropout(dropout_p, training, generator=None):
    """(p, seed) for the kernels: the seed drawn from the framework's
    generator when dropout is on in training, else (0.0, None)."""
    if dropout_p > 0.0 and training:
        return float(dropout_p), _random.next_seed(generator)
    return 0.0, None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, segment_ids=None,
                                 generator=None):
    """The registry op. CUDA tensors with D <= 256: the flash kernels
    (causal or not, GQA), with ``attn_mask`` taken as ``_sdpa_pallas``
    takes it: a bool keep-mask becomes the additive ``where(mask, 0,
    -1e30)`` in q's dtype, a float mask is the bias as it is (read by the
    kernels in its own dtype); either is read with stride 0 over its
    broadcast dims, forward and backward, and is a constant. ``segment_ids``
    (int [B, S], the packed rows) go to the kernels as q and kv ids;
    dropout in training draws its seed from ``generator`` (a CPU generator;
    None: the framework's current one). The mask, segments and dropout
    combine. D > 256 on the card, and CPU tensors: the composed
    ``_sdpa_reference`` (on the card counted in ``.COMPOSED``)."""
    del name
    if _composed_here(query):
        return _sdpa_reference(query, key, value, attn_mask, dropout_p,
                               is_causal, training=training,
                               segment_ids=segment_ids, generator=generator)
    bias = None
    if attn_mask is not None:
        attn_mask = attn_mask.detach()
        bias = (torch.where(attn_mask, 0.0, -1e30).to(query.dtype)
                if attn_mask.dtype == torch.bool else attn_mask)
    p, seed = _dropout(dropout_p, training, generator)
    return _flash_kernels(query, key, value, causal=is_causal, bias=bias,
                          q_segment_ids=segment_ids,
                          kv_segment_ids=segment_ids, dropout_p=p,
                          dropout_seed=seed)


scaled_dot_product_attention.COMPOSED = 0


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """``paddle.nn.functional.flash_attention.flash_attention``: returns
    ``(out, None)`` through ``scaled_dot_product_attention``;
    ``return_softmax`` raises (the tiled kernels never form the softmax)."""
    del fixed_seed_offset, rng_name, name
    if return_softmax:
        raise NotImplementedError(
            "return_softmax is not supported by the fused attention path "
            "(the tiled kernel never materializes the softmax matrix); "
            "compose it manually with softmax(q @ k^T) if needed")
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def _segments_from_cu(cu_seqlens, total):
    """Position -> sequence id for cu_seqlens-packed layouts (shared by the
    composed path and the kernels so both mask identically)."""
    cu = torch.as_tensor(cu_seqlens)
    return torch.searchsorted(
        cu, torch.arange(total, device=cu.device, dtype=cu.dtype),
        right=True).to(torch.int32)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False, training=True):
    """Varlen attention over packed sequences. q [total_q, H, D], k / v
    [total_k, H_kv, D]; ``cu_seqlens_*`` the sequences' cumulative
    lengths. Position i attends to j iff they fall in the same segment (and,
    causal, j is not after i within it). Returns ``(out, None)``.

    On the card (D <= 256), as ``_unpadded_supported`` /
    ``_flash_attn_unpadded_pallas`` dispatch it: non-causal, or causal with
    q and k of one packing (the same ``cu_seqlens`` object and total), the
    segment ids go to the kernels; causal with different packings, the
    composed bool mask goes to the kernels as a bias. There is no composed
    path on the card below D 256; above it and on the CPU, the composed
    attention on the mask (as the JAX ``flash_attn_unpadded``)."""
    del max_seqlen_q, max_seqlen_k
    if return_softmax:
        raise NotImplementedError(
            "return_softmax is not supported by flash_attn_unpadded")
    tq, tk = query.shape[0], key.shape[0]
    dev = query.device
    seg_q = _segments_from_cu(cu_seqlens_q, tq).to(dev)
    seg_k = _segments_from_cu(cu_seqlens_k, tk).to(dev)
    one_packing = cu_seqlens_q is cu_seqlens_k and tq == tk
    kernels = not _composed_here(query)
    if kernels and (not causal or one_packing):
        p, seed = _dropout(dropout, training)
        out = _flash_kernels(query[None], key[None], value[None],
                             causal=causal, sm_scale=scale,
                             q_segment_ids=seg_q[None],
                             kv_segment_ids=seg_k[None], dropout_p=p,
                             dropout_seed=seed)
        return out[0], None
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        cu_q = torch.as_tensor(cu_seqlens_q).to(dev)
        cu_k = torch.as_tensor(cu_seqlens_k).to(dev)
        pos_q = torch.arange(tq, device=dev) - cu_q[(seg_q - 1).long()]
        pos_k = torch.arange(tk, device=dev) - cu_k[(seg_k - 1).long()]
        mask = mask & (pos_k[None, :] <= pos_q[:, None])
    if kernels:
        p, seed = _dropout(dropout, training)
        bias = torch.where(mask, 0.0, -1e30).to(query.dtype)[None, None]
        out = _flash_kernels(query[None], key[None], value[None],
                             sm_scale=scale, bias=bias, dropout_p=p,
                             dropout_seed=seed)
        return out[0], None
    out = _sdpa_reference(query[None], key[None], value[None],
                          attn_mask=mask[None, None], dropout_p=dropout,
                          is_causal=False, scale=scale,
                          training=training)[0]
    return out, None


def _flashmask_keep(idx, causal, window, S, Sk, device):
    """The dense keep-mask [B, Hm, S, Sk] (or [1, 1, S, Sk]) of a flashmask
    call, as the JAX ``flashmask_attention`` composes it: C = 1 causal rows
    >= r1 masked; C = 2 causal rows in [r1, r2); C = 2 bidirectional, lower
    triangle rows >= r1 and upper rows < r2; C = 4, lower rows in [r1, r2)
    and upper rows in [r3, r4) (triangles strict); then the bottom-right
    causal tril and the window's left side (key >= query + Sk - S - w)."""
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(Sk, device=device)[None, :]
    mask = None
    if idx is not None:
        lt, ut = rows > cols, rows < cols

        def col(c):
            return idx[..., c][:, :, None, :]          # [B, Hm, 1, Sk]
        C = idx.shape[-1]
        if C == 1:
            banned = (rows >= col(0)) if causal else lt & (rows >= col(0))
        elif C == 2 and causal:
            banned = (rows >= col(0)) & (rows < col(1))
        elif C == 2:
            banned = (lt & (rows >= col(0))) | (ut & (rows < col(1)))
        else:
            banned = ((lt & (rows >= col(0)) & (rows < col(1)))
                      | (ut & (rows >= col(2)) & (rows < col(3))))
        mask = ~banned
    if causal:
        cm = (cols <= rows + (Sk - S))[None, None]
        mask = cm if mask is None else mask & cm
    if window is not None:
        wm = (cols >= rows + (Sk - S) - window)[None, None]
        mask = wm if mask is None else mask & wm
    return mask


def _flashmask_route(query, idx, causal):
    """The route, by device and shape alone, as ``_flashmask_supported``
    decides it: "kernels" for a card tensor with D <= 256 and no rows or
    causal rows with C 1 or 2; "dense" for the bidirectional rows there
    (the keep-mask into the bias kernels, counted in ``DENSE_MASK``);
    "composed" for a CPU tensor, or D > 256 (counted in
    ``scaled_dot_product_attention.COMPOSED``)."""
    if _composed_here(query):
        return "composed"
    if idx is None or (causal and idx.shape[-1] in (1, 2)):
        return "kernels"
    flashmask_attention.DENSE_MASK += 1
    return "dense"


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None):
    """Sparse-mask attention (``paddle.nn.functional.flashmask_attention``).
    q [B, S, H, D], k / v [B, Sk, H_kv, D]; ``startend_row_indices``
    integer [B, 1|H, Sk, C], per-key-column row indices: C = 1 causal, rows
    >= r1 masked; C = 2 causal, rows in [r1, r2); C = 2 bidirectional,
    lower-triangle rows >= r1 and upper rows < r2; C = 4, lower rows in
    [r1, r2) and upper rows in [r3, r4). ``window_size`` (an int, or a tuple
    whose first entry is taken): keys at least ``query + Sk - S - w``.
    Dropout is always in training mode, its seed drawn from the framework's
    generator. Returns ``(out, None)``.

    On the card (D <= 256) no rows, or causal rows with C 1 or 2, go to the
    flash kernels' flashmask operands (start = r1, end = r2, or S for C =
    1) and window ``(w, None)``: no dense mask is built, and a tile whose
    keys all mask its queries is skipped. The bidirectional forms build the
    dense keep-mask and take ``scaled_dot_product_attention`` into the bias
    kernels (counted in ``.DENSE_MASK``). A CPU tensor, or D > 256, takes the
    composed attention on the same dense mask."""
    B, S, H = query.shape[0], query.shape[1], query.shape[2]
    Sk = key.shape[1]
    idx = startend_row_indices
    if idx is not None:
        idx = torch.as_tensor(idx, device=query.device)
        if idx.dim() != 4:
            raise ValueError(f"flashmask_attention: startend_row_indices must "
                             f"be [B, H_mask, Sk, C], got {tuple(idx.shape)}")
        enforce_in(idx.shape[-1], (1, 2, 4),
                   f"startend_row_indices last dim must be 1, 2 or 4, got "
                   f"{idx.shape[-1]}", op="flashmask_attention")
        if (idx.shape[0] != B or idx.shape[1] not in (1, H)
                or idx.shape[2] != Sk):
            raise ValueError(f"flashmask_attention: startend_row_indices "
                             f"{tuple(idx.shape)} does not fit [{B}, 1|{H}, "
                             f"{Sk}, C]")
    w = None
    if window_size is not None:
        w = int(window_size if isinstance(window_size, int)
                else window_size[0])
    route = _flashmask_route(query, idx, causal)
    if route == "kernels":
        fm = None
        if idx is not None:
            start = idx[..., 0]
            end = (idx[..., 1] if idx.shape[-1] == 2
                   else torch.full_like(start, S))
            fm = (start, end)
        p, seed = _dropout(dropout, True)
        out = _flash_kernels(query, key, value, causal=causal,
                             startend_row_indices=fm,
                             window=None if w is None else (w, None),
                             dropout_p=p, dropout_seed=seed)
        return out, None
    mask = _flashmask_keep(idx, causal, w, S, Sk, query.device)
    if route == "dense":
        return scaled_dot_product_attention(query, key, value, mask, dropout,
                                            False, True), None
    return _sdpa_reference(query, key, value, mask, dropout, False), None


flashmask_attention.DENSE_MASK = 0


class sdp_kernel:
    """Not ported yet: the backend switch needs the op registry (ROADMAP
    Queue 1 item 4)."""

    def __init__(self, enable_math=True, enable_flash=True,
                 enable_mem_efficient=True):
        raise NotImplementedError(
            "sdp_kernel is not ported yet (ROADMAP Queue 1 item 4, the op "
            "registry)")
