"""Single-dispatch ragged serving step (counterpart:
``paddle_tpu/inference/ragged_step.py`` ``ragged_pass`` and
``unified_step``).

One engine step advances EVERY slot: decode rows and chunked-prefill rows
ride one PACKED ragged token buffer with per-row ``(slot, q_len, kv_len)``
descriptors. The QKV/projection/FFN GEMMs run over the packed tokens,
attention is the hand-written ragged paged-attention kernel
(``kernels/ragged_paged_attention.py``) over the shared block pool, the
chunk's KV is appended to the pool, each row samples at its last valid
position, and K-1 decode micro-steps continue the sampling rows.

Where the JAX code runs ``lax.scan`` over the stacked layers and over the
decode micro-steps inside one compiled program, the port runs Python loops
of eager kernels; the host reads nothing back inside them. JAX donates the
KV pools to the program and gets new ones back; the port updates the pools
IN PLACE (``index_put_`` on the layer's view) and returns the same tensors.

Quantized pools (int8 or fp8 e4m3, ``quantization/kv_cache.py``) take their
per-(layer, kv head, page) scales ``ks`` / ``vs`` [L, H_kv, NB]: the chunk's
KV is appended as ``append_tokens_quantized`` does (requantizing the touched
pages in place; the targets are planned once per pass), the kernel
dequantizes in its page load, and ``unified_step`` first resets the page
scales of the rows admitted this step. There is no mesh, no speculative
verify and no copy-on-write: the optional arguments those features add are
not taken.
"""

from __future__ import annotations

import torch

from ..kernels.ragged_paged_attention import ragged_paged_attention
from ..models.gpt import _ln
from ..quantization.kv_cache import (append_plan, append_planned,
                                     reset_page_scales)
from .serving import (_block_math, _embed, _head_logits, _layer_params,
                      _qkv, sample_tokens)

__all__ = ["ragged_pass", "unified_step", "sample_tokens"]


def ragged_pass(params, tokens, row_of, off_of, starts, pos0, q_lens,
                tables, temps, gen, kp, vp, *, cfg, bs, c_att, ks=None,
                vs=None):
    """One transformer forward over the packed ragged batch + per-row
    sampling. tokens/row_of/off_of: [T] packed (off_of >= q_len marks
    padding); starts/pos0/q_lens/temps: [R]; tables: [R, nb];
    pools: [L, H_kv, NB, bs, D], updated in place, with their scales
    ks / vs [L, H_kv, NB] (also in place) when they are quantized. Returns
    tok [R]."""
    T = tokens.shape[0]
    dev = tokens.device
    row = row_of.long()
    pos_t = torch.clamp(pos0[row] + off_of, max=cfg.max_seq_len - 1)
    x = _embed(params, tokens[None], pos_t[None], cfg)             # [1, T, H]
    kv_lens = pos0 + q_lens
    valid_t = off_of < q_lens[row]
    # packed-token scatter targets; invalid tokens land in the reserved
    # scratch block 0. Several may share one (block 0, offset 0) slot, and
    # index_put_ leaves which of them wins unspecified: harmless, because
    # block 0 is never allocated to a row and so never read.
    posb = torch.clamp(pos_t // bs, 0, tables.shape[1] - 1)
    zero = torch.zeros_like(pos_t)
    blk_t = torch.where(valid_t, tables[row, posb.long()], zero).long()
    off_t = torch.where(valid_t, pos_t % bs, zero).long()
    # per-row attention tile gather [R, c_att] (clamped duplicates are
    # masked by the kernel's c < q_len predicate)
    ar = torch.arange(c_att, device=dev, dtype=starts.dtype)
    tile_idx = torch.clamp(
        starts[:, None] + torch.minimum(
            ar[None, :], torch.clamp(q_lens - 1, min=0)[:, None]),
        0, T - 1).long()
    attn_off = torch.clamp(off_of, max=c_att - 1).long()
    scale = 1.0 / (cfg.head_dim ** 0.5)
    if ks is not None:   # the quantized appends' targets, shared by layers
        plan = append_plan(pos0, q_lens, tables, bs, c_att)
    for layer in range(cfg.num_layers):
        p = _layer_params(params, layer)
        q, k, v = _qkv(p, x, cfg)                                   # [1, T, h, D]
        kpl, vpl = kp[layer], vp[layer]                             # views
        ksl = vsl = None
        if ks is None:
            # [h, T, D] scatter
            kpl[:, blk_t, off_t] = k[0].transpose(0, 1).to(kpl.dtype)
            vpl[:, blk_t, off_t] = v[0].transpose(0, 1).to(vpl.dtype)
        else:
            ksl, vsl = ks[layer], vs[layer]                         # views
            append_planned(kpl, ksl, k[0][tile_idx], plan)
            append_planned(vpl, vsl, v[0][tile_idx], plan)
        attn_t = ragged_paged_attention(
            q[0][tile_idx], kpl, vpl, tables, q_lens, kv_lens, scale, ksl,
            vsl)
        attn_p = attn_t[row, attn_off]                              # [T, h, D]
        x = _block_math(p, x, attn_p[None], cfg)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    last_idx = torch.clamp(starts + torch.clamp(q_lens, min=1) - 1,
                           0, T - 1).long()
    logits = _head_logits(params, x[0][last_idx], cfg)
    return sample_tokens(logits, temps, gen)


@torch.no_grad()
def unified_step(params, tokens, row_of, off_of, starts, pos0, q_lens,
                 tables, sample0, remaining, eos_ids, temps, gen, kp, vp, *,
                 cfg, bs, c_att, K, ks=None, vs=None, fresh=None):
    """One engine step: the ragged pass (prefill chunks + first decode
    token for every row) followed by K-1 decode micro-steps for every
    sampling row. sample0: [R] bool, rows whose pass-1 token counts
    (decode rows + prefills completing this step); remaining: [R] tokens
    each row may still emit INCLUDING pass-1's (0 for mid-prefill rows);
    eos_ids: [R] (-1 = none); temps: [R] (0 = greedy). Quantized pools
    come with ks / vs and ``fresh`` [R] bool, the slots admitted this step,
    whose tables' page scales are reset before the pass (a recycled block
    never inherits a stale range).

    Every micro-step runs even when no row is left alive, as the scan does
    in JAX: the kernel then sees q_len 0 everywhere and writes zeros.
    Returns (toks [K, R], kp, vp, lens [R]); kp / vp (and ks / vs) are the
    input tensors, updated in place."""
    R = pos0.shape[0]
    dev = pos0.device
    if ks is not None:
        reset_page_scales(ks, tables, fresh)
        reset_page_scales(vs, tables, fresh)
    tok0 = ragged_pass(params, tokens, row_of, off_of, starts, pos0, q_lens,
                       tables, temps, gen, kp, vp, cfg=cfg, bs=bs,
                       c_att=c_att, ks=ks, vs=vs)
    tok0 = torch.where(sample0, tok0, torch.zeros_like(tok0))
    lens = pos0 + q_lens
    rem = remaining - sample0.to(remaining.dtype)
    alive = sample0 & (tok0 != eos_ids)
    ar = torch.arange(R, dtype=torch.int32, device=dev)
    zero = torch.zeros((R,), dtype=torch.int32, device=dev)
    toks = [tok0]
    tok = tok0
    for _ in range(K - 1):
        active = alive & (rem > 0)
        ql = active.to(torch.int32)
        tok2 = ragged_pass(params, tok, ar, zero, ar, lens, ql, tables,
                           temps, gen, kp, vp, cfg=cfg, bs=bs, c_att=1,
                           ks=ks, vs=vs)
        tok2 = torch.where(active, tok2, torch.zeros_like(tok2))
        lens = lens + ql
        rem = rem - ql
        alive = alive & ~(active & (tok2 == eos_ids))
        toks.append(tok2)
        tok = tok2
    return torch.stack(toks), kp, vp, lens
