"""Attention ops (counterpart: ``paddle_tpu/nn/functional/flash_attention.py``
``_sdpa_reference`` and ``scaled_dot_product_attention``, with the dispatch
of ``paddle_tpu/kernels/pallas/register.py`` ``_sdpa_pallas``).

``scaled_dot_product_attention`` is the registry op the model calls. The JAX
package sends it to the Pallas flash kernel on the TPU and to the composed
``_sdpa_reference`` elsewhere. The port decides by device, never on failure:
CUDA tensors go to the flash kernels (``kernels/flash_attention.py``) or the
call raises; CPU tensors go to ``_sdpa_reference``. The kernels take every
sequence length and any mask that broadcasts to ``[B, H, Sq, Sk]``, so the
JAX gate's ``S % 128`` and mask-shape rules (TPU tiling rules) have no
counterpart. Layouts are ``[B, S, H, D]``.

Dropout in training draws one seed per call as a Python int from the
caller's CPU generator (``paddle_tpu_torch.random``; the JAX
``_dropout_seed`` draws it from the framework key), so the card never
waits for the host.
"""

from __future__ import annotations

import torch

from ... import random as _random
from ...kernels.flash_attention import flash_attention

__all__ = ["scaled_dot_product_attention"]


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


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, segment_ids=None,
                                 generator=None):
    """The registry op. CUDA tensors: the flash kernels (causal or not, GQA),
    with ``attn_mask`` taken as ``_sdpa_pallas`` takes it: a bool keep-mask
    becomes the additive ``where(mask, 0, -1e30)`` in q's dtype, a float
    mask is the bias as it is; either goes to the forward kernel with stride
    0 over its broadcast dims. ``segment_ids`` (int [B, S], the packed rows)
    go to the kernels as q and kv ids; dropout in training draws its seed
    from ``generator`` (a CPU generator; None: the framework's current one).
    A mask with segments or dropout raises NotImplementedError there
    (ROADMAP Queue 2 #2). CPU tensors: the composed ``_sdpa_reference``."""
    del name
    if query.device.type == "cpu":
        return _sdpa_reference(query, key, value, attn_mask, dropout_p,
                               is_causal, training=training,
                               segment_ids=segment_ids, generator=generator)
    bias = None
    if attn_mask is not None:
        attn_mask = attn_mask.detach()
        bias = (torch.where(attn_mask, 0.0, -1e30).to(query.dtype)
                if attn_mask.dtype == torch.bool else attn_mask)
    p, seed = 0.0, None
    if dropout_p > 0.0 and training:
        p, seed = float(dropout_p), _random.next_seed(generator)
    return flash_attention(query, key, value, causal=is_causal, bias=bias,
                           q_segment_ids=segment_ids,
                           kv_segment_ids=segment_ids, dropout_p=p,
                           dropout_seed=seed)
