"""GPT, the single-device dense model (counterpart:
``paddle_tpu/models/gpt.py`` ``GPTConfig``, ``_ln``, the dense branch of
``init_hybrid_params``, and the training half: ``dense_embed``,
``dense_block``, ``lm_logsumexp_ce``, ``dense_head_loss``, ``dense_forward``
and ``dense_loss``).

Parameters are a plain dict with the JAX pytree's keys and its stacked
``[L, ...]`` block leaves, so a tree made by the JAX init loads straight in
(``models/convert.py``). The init draws from a ``torch.Generator`` seeded by
the caller; it is not meant to reproduce ``jax.random``.

Training is ``loss = dense_loss(params, tokens, labels, cfg)``, then
``torch.autograd.grad(loss, leaves)`` (or ``loss.backward()``) with the
parameter tensors marked ``requires_grad``. The JAX ``lax.scan`` over the
stacked block leaves is a Python loop over the layer index here; each
stacked leaf is ``unbind``-ed once per forward, so its gradient comes back
stacked by one ``torch.stack`` rather than one full-size scatter per layer.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device
from ..enforce import enforce
from ..nn.functional.flash_attention import scaled_dot_product_attention

__all__ = ["GPTConfig", "init_hybrid_params", "dense_embed", "dense_block",
           "lm_logsumexp_ce", "dense_head_loss", "dense_forward",
           "dense_loss"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: Optional[int] = None
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16      # compute dtype
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.ffn_hidden is None:
            self.ffn_hidden = 4 * self.hidden_size
        enforce(self.hidden_size % self.num_heads == 0,
                "hidden_size must be divisible by num_heads", op="GPTConfig",
                hidden_size=self.hidden_size, num_heads=self.num_heads)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def init_hybrid_params(cfg: GPTConfig, seed: int,
                       device=None) -> Dict[str, object]:
    """Stacked-parameter dict: std 0.02 normals, ``std/sqrt(2L)`` for the
    residual projections ``proj_w`` / ``fc2_w``, LayerNorm gains 1 and
    biases 0, all in ``cfg.param_dtype`` on ``device`` (``None``: the CUDA
    card, raising without one; ``"meta"``: shapes only)."""
    H, L, FF, V = (cfg.hidden_size, cfg.num_layers, cfg.ffn_hidden,
                   cfg.vocab_size)
    device = resolve_device(device)
    gen = None      # device "meta": shapes and dtypes only, nothing drawn
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    std = 0.02
    pd = cfg.param_dtype

    def nrm(shape, scale=std):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * scale).to(pd)

    def const(shape, value):
        return torch.full(shape, value, dtype=pd, device=device)

    wte = nrm((V, H))
    wpe = nrm((cfg.max_seq_len, H))
    blocks = {
        "ln1_g": const((L, H), 1.0),
        "ln1_b": const((L, H), 0.0),
        "qkv_w": nrm((L, H, 3 * H)),
        "qkv_b": const((L, 3 * H), 0.0),
        "proj_w": nrm((L, H, H), std / math.sqrt(2 * L)),
        "proj_b": const((L, H), 0.0),
        "ln2_g": const((L, H), 1.0),
        "ln2_b": const((L, H), 0.0),
        "fc1_w": nrm((L, H, FF)),
        "fc1_b": const((L, FF), 0.0),
        "fc2_w": nrm((L, FF, H), std / math.sqrt(2 * L)),
        "fc2_b": const((L, H), 0.0),
    }
    return {
        "wte": wte,
        "wpe": wpe,
        "blocks": blocks,
        "lnf_g": const((H,), 1.0),
        "lnf_b": const((H,), 0.0),
        "head_w": nrm((H, V)),
    }


def _ln(x, g, b, eps=1e-5):
    # the COMPOSED LayerNorm, kept composed on purpose as in the reference
    # (gpt.py:_ln): statistics in fp32, normalized value cast back to
    # x.dtype, then the affine in the promoted type of (x.dtype, g.dtype)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def dense_embed(params, tokens, cfg: GPTConfig):
    """Token + position embedding over the embed sub-tree {wte, wpe}."""
    S = tokens.shape[1]
    x = F.embedding(tokens, params["wte"]) + params["wpe"][None, :S]
    return x.to(cfg.dtype)


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


def _qkv_heads(p, h, cfg: GPTConfig):
    """The fused QKV projection of the normalized input, viewed head-major
    ``[B, S, H, 3, D]`` (q, k, v innermost per head, the reference's
    ``qkv.reshape(B, S, nh, 3, hd)``; NOT ``[B, S, 3, H, D]``). The bias
    add is the GEMM's own (one ``addmm``), so the projection is one op
    whose output the default remat mode keeps."""
    B, S, Hd = h.shape
    qkv = torch.addmm(p["qkv_b"].to(cfg.dtype),
                      h.to(cfg.dtype).reshape(-1, Hd), p["qkv_w"].to(cfg.dtype))
    return qkv.reshape(B, S, cfg.num_heads, 3, cfg.head_dim)


def _ln_qkv(p, x, cfg: GPTConfig):
    return _qkv_heads(p, _ln(x, p["ln1_g"], p["ln1_b"]), cfg)


def _keep_qkv(ctx, op, *args, **kwargs):
    # selective-checkpoint policy of _block_selective: the qkv GEMM's output
    # is kept, the LayerNorm before it is recomputed
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.addmm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _attention(qkv):
    """Causal attention through the registry op: the flash kernels on the
    card, the composed path on the CPU. q, k, v are strided views of
    ``qkv``; the kernels read them in place."""
    return scaled_dot_product_attention(qkv[:, :, :, 0], qkv[:, :, :, 1],
                                        qkv[:, :, :, 2], is_causal=True)


def _block_tail(p, x, attn, cfg: GPTConfig):
    """The block after attention: projection and residual, LayerNorm, the
    tanh-GELU MLP and residual."""
    B, S, H = x.shape
    out = attn.reshape(B, S, H) @ p["proj_w"].to(cfg.dtype)
    x = x + out + p["proj_b"].to(cfg.dtype)
    h = _ln(x, p["ln2_g"], p["ln2_b"])
    m = h.to(cfg.dtype) @ p["fc1_w"].to(cfg.dtype) + p["fc1_b"].to(cfg.dtype)
    m = F.gelu(m.float(), approximate="tanh").to(cfg.dtype)
    return x + m @ p["fc2_w"].to(cfg.dtype) + p["fc2_b"].to(cfg.dtype)


def dense_block(p, x, cfg: GPTConfig, fp8=None, flash=None):
    """One transformer block on a per-layer param dict (no remat)."""
    if fp8 is not None:
        raise _not_ported("fp8 GEMMs in the dense block (fp8=)", 7)
    if flash is not None:
        raise _not_ported("the FlashAttentionConfig route (flash=)", 6)
    return _block_tail(p, x, _attention(_ln_qkv(p, x, cfg)), cfg)


def _block_selective(p, x, cfg: GPTConfig):
    """The default remat mode, the reference's
    ``save_only_these_names("attn_out", "qkv")``: the qkv projection and the
    attention output are kept, the rest of the block is recomputed in the
    backward. ln1 and the qkv GEMM run under one selective checkpoint that
    keeps the GEMM's output and recomputes ln1 (its output included) for
    the GEMM's weight gradient; the flash call keeps its inputs (views of
    ``qkv``), its output and its lse; projection, ln2 and the MLP run under
    a checkpoint of (x, attn)."""
    qkv = checkpoint(_ln_qkv, p, x, cfg, use_reentrant=False,
                     context_fn=functools.partial(
                         create_selective_checkpoint_contexts, _keep_qkv))
    return checkpoint(_block_tail, p, x, _attention(qkv), cfg,
                      use_reentrant=False)


def lm_logsumexp_ce(logits, labels):
    """Mean next-token cross entropy in logsumexp + gather form; the
    V-length reduction runs in fp32 over the compute-dtype logits."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = logits.gather(-1, labels[..., None])[..., 0].float()
    return (lse - picked).mean()


def dense_head_loss(params, x, labels, cfg: GPTConfig):
    """Final LN + LM head + logsumexp CE over {lnf_g, lnf_b, head_w}."""
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    logits = x.to(cfg.dtype) @ params["head_w"].to(cfg.dtype)
    return lm_logsumexp_ce(logits, labels)


def dense_forward(params, tokens, cfg: GPTConfig, remat: bool = True,
                  remat_save=("attn_out", "qkv"), fp8=None, flash=None):
    """Single-device forward over the stacked-parameter dict -> logits
    [B, S, V] in the compute dtype. Three remat modes, identical numbers:

    * ``remat=False``: autograd keeps every intermediate;
    * ``remat=True, remat_save=()``: full per-block recompute
      (``torch.utils.checkpoint``, non-reentrant), the minimum-memory form;
    * the default ``remat_save=("attn_out", "qkv")``: the qkv projection and
      the attention output are kept and the rest of the block is recomputed
      (``_block_selective``).

    The reference's default policy keeps ``qkv`` and ``attn_out`` but not the
    flash kernel's lse, so the TPU replays the flash forward in the backward.
    The port's flash call keeps (out, lse) with its inputs (about 0.5 MB of
    lse per layer at the flagship) and never replays it: a CUDA step makes
    L flash-forward launches under ``remat=False`` and the default mode, and
    2 L under full remat; L dQ and L dK/dV launches under every mode."""
    if fp8 is not None:
        raise _not_ported("fp8 GEMMs in the dense block (fp8=)", 7)
    if flash is not None:
        raise _not_ported("the FlashAttentionConfig route (flash=)", 6)
    save = tuple(remat_save or ())
    if remat and save and set(save) != {"attn_out", "qkv"}:
        raise NotImplementedError(
            f"remat_save={save}: the port realises () and ('attn_out', "
            f"'qkv') only")
    x = dense_embed(params, tokens, cfg)
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    for i in range(cfg.num_layers):
        p = {k: v[i] for k, v in layers.items()}
        if not remat:
            x = dense_block(p, x, cfg)
        elif save:
            x = _block_selective(p, x, cfg)
        else:
            x = checkpoint(dense_block, p, x, cfg, use_reentrant=False)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    return x.to(cfg.dtype) @ params["head_w"].to(cfg.dtype)


def dense_loss(params, tokens, labels, cfg: GPTConfig, remat: bool = True,
               remat_save=("attn_out", "qkv"), fp8=None, flash=None):
    """Mean next-token CE of ``dense_forward``'s logits (fp32 scalar)."""
    logits = dense_forward(params, tokens, cfg, remat=remat,
                           remat_save=remat_save, fp8=fp8, flash=flash)
    return lm_logsumexp_ce(logits, labels)
