"""Llama (counterpart: ``paddle_tpu/models/llama.py``): ``LlamaConfig`` and
its presets, the RoPE helpers, the eager layer form and the single-device
dense form.

* ``Llama``, the eager form: RMSNorm pre-norm (``nn.RMSNorm``, the registry
  op ``rms_norm``: the RMSNorm kernels on the card), RoPE, GQA attention
  through the registry ``scaled_dot_product_attention`` (the flash kernels
  on the card, GQA native), a SwiGLU MLP and an untied head that multiplies
  the fp32-cast final hidden state, as the JAX layer does. Parameter names
  are the JAX layer's (``layers.0.self_attn.q_proj.weight``), so a
  ``functional_train_graph`` tree made by the JAX package loads by name
  (``models/convert.py`` ``load_params``). The layer rotates with the
  composed ``_rope``, as the JAX layer does; the RoPE kernel is reached
  through ``incubate.nn.functional.fused_rotary_position_embedding``.
* the dense form ``bench_llama`` trains: ``init_hybrid_params`` (the JAX
  pytree's keys and stacked ``[L, ...]`` block leaves), ``dense_embed``,
  ``dense_block``, ``dense_head_loss``, ``dense_forward`` (a Python loop
  over the layers for the JAX ``lax.scan``, each block under
  ``torch.utils.checkpoint`` with ``remat``, the JAX ``jax.checkpoint``) and
  ``dense_loss``. It normalises with the composed ``_rms`` and rotates with
  the composed ``_rope``, as in JAX; attention is the flash GQA path.

* the parameter-streaming form: ``split_streamed_params``,
  ``init_streamed_params`` and ``streamed_fns`` for
  ``distributed.sharding.build_param_streamed_train_step``.

The JAX module's hybrid engine (``hybrid_loss_fn``,
``build_hybrid_train_step``) is not ported yet (ROADMAP Queue 1 item 6);
``fp8=`` raises naming Queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as TF
from torch.utils.checkpoint import checkpoint

from .. import nn, resolve_device
from ..enforce import enforce
from ..kernels.rope import rotate
from ..nn import functional as F
from .gpt import _not_ported, lm_logsumexp_ce

__all__ = ["LlamaConfig", "Llama", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "llama_tiny", "llama2_7b", "llama2_13b",
           "llama3_8b", "rope_tables", "init_hybrid_params", "dense_embed",
           "dense_block", "dense_head_loss", "dense_forward", "dense_loss",
           "split_streamed_params", "init_streamed_params", "streamed_fns"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None -> MHA
    intermediate_size: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16          # compute dtype
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.intermediate_size is None:
            # Llama sizing: 2/3 * 4H rounded up to a multiple of 256
            self.intermediate_size = 256 * math.ceil(8 * self.hidden_size
                                                     / 3 / 256)
        enforce(self.hidden_size % self.num_heads == 0,
                "hidden_size must be divisible by num_heads", op="LlamaConfig",
                hidden_size=self.hidden_size, num_heads=self.num_heads)
        enforce(self.num_heads % self.num_kv_heads == 0,
                "num_heads must be divisible by num_kv_heads (GQA groups)",
                op="LlamaConfig", num_heads=self.num_heads,
                num_kv_heads=self.num_kv_heads)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def llama_tiny(**kw):
    return LlamaConfig(vocab_size=1024, hidden_size=128, num_layers=4,
                       num_heads=4, num_kv_heads=2, intermediate_size=256,
                       max_seq_len=256, **kw)


def llama2_7b(**kw):
    return LlamaConfig(hidden_size=4096, num_layers=32, num_heads=32,
                       intermediate_size=11008, **kw)


def llama2_13b(**kw):
    return LlamaConfig(hidden_size=5120, num_layers=40, num_heads=40,
                       intermediate_size=13824, **kw)


def llama3_8b(**kw):
    return LlamaConfig(vocab_size=128256, hidden_size=4096, num_layers=32,
                       num_heads=32, num_kv_heads=8, intermediate_size=14336,
                       max_seq_len=8192, rope_theta=500000.0, **kw)


# ---------------------------------------------------------------------------
# RoPE helpers (NeoX half-split convention, matching incubate fused_rope)
# ---------------------------------------------------------------------------
def rope_tables(cfg: LlamaConfig, seq_len: int, device=None):
    """(cos, sin) fp32 [S, D/2] on ``device`` (None: the card)."""
    device = resolve_device(device)
    D = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, D, 2, dtype=torch.float32, device=device) / D))
    ang = (torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
           * inv[None, :])
    return torch.cos(ang), torch.sin(ang)


def _rope(x, cos, sin):
    """x [B, S, h, D]: rotate the half-split pairs by [S, D/2] tables
    (composed: fp32, one rounding to x's dtype)."""
    return rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def _flash_gqa(q, k, v):
    """Causal attention through the registry op with native GQA: the flash
    kernels index a KV head per query-head group on the card (no head
    repeat); the composed path repeats on the CPU."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=True)


def _gqa_attention(q, k, v):
    """Composed causal GQA attention. q [B, S, hq, D], k / v [B, S, hkv, D];
    scores in fp32, probabilities in q's dtype."""
    B, S, hq, D = q.shape
    hkv = k.shape[2]
    qg = q.reshape(B, S, hkv, hq // hkv, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(D)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, S, hq, D)


# ---------------------------------------------------------------------------
# Eager nn.Layer form
# ---------------------------------------------------------------------------
class LlamaAttention(nn.Layer):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        H, D = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(H, cfg.num_heads * D, bias_attr=False)
        self.k_proj = nn.Linear(H, cfg.num_kv_heads * D, bias_attr=False)
        self.v_proj = nn.Linear(H, cfg.num_kv_heads * D, bias_attr=False)
        self.o_proj = nn.Linear(cfg.num_heads * D, H, bias_attr=False)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        B, S, _ = x.shape
        q = self.q_proj(x).reshape(B, S, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        v = self.v_proj(x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        out = _flash_gqa(q, k, v)
        return self.o_proj(out.reshape(B, S, -1))


class LlamaMLP(nn.Layer):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(H, I, bias_attr=False)
        self.up_proj = nn.Linear(H, I, bias_attr=False)
        self.down_proj = nn.Linear(I, H, bias_attr=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Layer):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = nn.RMSNorm(cfg.hidden_size, epsilon=cfg.rms_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = nn.RMSNorm(cfg.hidden_size,
                                                   epsilon=cfg.rms_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class Llama(nn.Layer):
    """tokens [B, S] -> fp32 logits [B, S, V]."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.LayerList(
            [LlamaDecoderLayer(cfg) for _ in range(cfg.num_layers)])
        self.norm = nn.RMSNorm(cfg.hidden_size, epsilon=cfg.rms_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                 bias_attr=False)

    def forward(self, tokens):
        cfg = self.cfg
        cos, sin = rope_tables(cfg, tokens.shape[1], tokens.device)
        x = self.embed_tokens(tokens).to(cfg.dtype)
        for layer in self.layers:
            x = layer(x, cos, sin)
        x = self.norm(x)
        return self.lm_head(x.float())


# ---------------------------------------------------------------------------
# Dense (single-device, stacked-parameter) form
# ---------------------------------------------------------------------------
def init_hybrid_params(cfg: LlamaConfig, seed: int,
                       device=None) -> Dict[str, object]:
    """Stacked-parameter dict with the JAX pytree's keys: std 0.02 normals,
    ``std/sqrt(2L)`` for the residual projections ``o_w`` / ``down_w``,
    RMSNorm gains 1, all in ``cfg.param_dtype``. Drawn on the host from a
    ``torch.Generator`` seeded with ``seed`` (the same values for the card
    and the CPU; not ``jax.random``'s), then placed on ``device`` (None: the
    card, raising without one; ``"meta"``: shapes only)."""
    H, L, I, V = (cfg.hidden_size, cfg.num_layers, cfg.intermediate_size,
                  cfg.vocab_size)
    D, nkv = cfg.head_dim, cfg.num_kv_heads
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    std, pd = 0.02, cfg.param_dtype

    def nrm(shape, scale=std):
        if device.type == "meta":
            return torch.empty(shape, dtype=pd, device=device)
        x = torch.randn(shape, generator=gen, dtype=torch.float32)
        return (x * scale).to(pd).to(device)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    wte = nrm((V, H))
    blocks = {
        "ln1_g": ones((L, H)),
        "q_w": nrm((L, H, H)),
        "k_w": nrm((L, H, nkv * D)),
        "v_w": nrm((L, H, nkv * D)),
        "o_w": nrm((L, H, H), std / math.sqrt(2 * L)),
        "ln2_g": ones((L, H)),
        "gate_w": nrm((L, H, I)),
        "up_w": nrm((L, H, I)),
        "down_w": nrm((L, I, H), std / math.sqrt(2 * L)),
    }
    return {"wte": wte, "blocks": blocks, "lnf_g": ones((H,)),
            "head_w": nrm((H, V))}    # own draw: the head is untied


def _rms(x, g, eps):
    # the COMPOSED RMSNorm of the dense form (llama.py:_rms): fp32
    # statistics, normalized value cast back to x's dtype, then the gain in
    # the promoted type of (x.dtype, g.dtype)
    xf = x.float()
    return ((xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps))
            .to(x.dtype) * g)


def dense_embed(params, tokens, cfg: LlamaConfig):
    return TF.embedding(tokens, params["wte"]).to(cfg.dtype)


def dense_block(p, x, cfg: LlamaConfig, fp8=None):
    """One decoder layer on a per-layer parameter dict (no remat). The RoPE
    tables are made from cfg and S on x's device."""
    if fp8 is not None:
        raise _not_ported("fp8 GEMMs in the dense block (fp8=)", 7)
    cd = cfg.dtype
    B, S, H = x.shape
    cos, sin = rope_tables(cfg, S, x.device)
    h = _rms(x, p["ln1_g"], cfg.rms_eps).to(cd)
    q = (h @ p["q_w"].to(cd)).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (h @ p["k_w"].to(cd)).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (h @ p["v_w"].to(cd)).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    attn = _flash_gqa(q, k, v)
    x = x + attn.reshape(B, S, H) @ p["o_w"].to(cd)
    h = _rms(x, p["ln2_g"], cfg.rms_eps).to(cd)
    m = (TF.silu((h @ p["gate_w"].to(cd)).float()).to(cd)
         * (h @ p["up_w"].to(cd)))
    return x + m @ p["down_w"].to(cd)


def dense_head_loss(params, x, labels, cfg: LlamaConfig):
    """Final RMSNorm + LM head + logsumexp CE over {lnf_g, head_w}: the
    same math as dense_loss's tail."""
    x = _rms(x, params["lnf_g"], cfg.rms_eps)
    logits = x.to(cfg.dtype) @ params["head_w"].to(cfg.dtype)
    return lm_logsumexp_ce(logits, labels)


def dense_forward(params, tokens, cfg: LlamaConfig, remat: bool = True,
                  fp8=None):
    """Single-device forward over the stacked-parameter dict -> logits
    [B, S, V] in the compute dtype. ``remat``: each block under a
    non-reentrant ``torch.utils.checkpoint`` (its forward, the flash
    forward included, runs again in the backward), the JAX
    ``jax.checkpoint`` per block."""
    if fp8 is not None:
        raise _not_ported("fp8 GEMMs in the dense block (fp8=)", 7)
    x = dense_embed(params, tokens, cfg)
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    for i in range(cfg.num_layers):
        p = {k: v[i] for k, v in layers.items()}
        if remat:
            x = checkpoint(dense_block, p, x, cfg, use_reentrant=False)
        else:
            x = dense_block(p, x, cfg)
    x = _rms(x, params["lnf_g"], cfg.rms_eps)
    return x.to(cfg.dtype) @ params["head_w"].to(cfg.dtype)


def dense_loss(params, tokens, labels, cfg: LlamaConfig, remat: bool = True,
               fp8=None):
    """Mean next-token CE of ``dense_forward``'s logits (fp32 scalar)."""
    logits = dense_forward(params, tokens, cfg, remat=remat, fp8=fp8)
    return lm_logsumexp_ce(logits, labels)


# ---------------------------------------------------------------------------
# the parameter-streaming (bigger-than-device) form
# ---------------------------------------------------------------------------
def split_streamed_params(params, cfg: LlamaConfig):
    """Stacked tree -> the segmented ``{"embed", "blocks", "head"}`` layout
    of ``build_param_streamed_train_step`` (tests / small models)."""
    blocks = [{k: v[i] for k, v in params["blocks"].items()}
              for i in range(cfg.num_layers)]
    return {"embed": {"wte": params["wte"]},
            "blocks": blocks,
            "head": {"lnf_g": params["lnf_g"], "head_w": params["head_w"]}}


def init_streamed_params(cfg: LlamaConfig, seed: int, park=lambda t: t,
                         device=None):
    """The segmented init, ONE segment on ``device`` at a time (None: the
    card), each handed to ``park`` before the next is drawn; the
    distributions of ``init_hybrid_params`` from one ``torch.Generator``
    seeded with ``seed`` (embedding, blocks, head)."""
    H, L, I, V = (cfg.hidden_size, cfg.num_layers, cfg.intermediate_size,
                  cfg.vocab_size)
    D, nkv = cfg.head_dim, cfg.num_kv_heads
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    std, pd = 0.02, cfg.param_dtype

    def nrm(shape, scale=std):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * scale).to(pd)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    def one_block():
        return {
            "ln1_g": ones((H,)),
            "q_w": nrm((H, H)),
            "k_w": nrm((H, nkv * D)),
            "v_w": nrm((H, nkv * D)),
            "o_w": nrm((H, H), std / math.sqrt(2 * L)),
            "ln2_g": ones((H,)),
            "gate_w": nrm((H, I)),
            "up_w": nrm((H, I)),
            "down_w": nrm((I, H), std / math.sqrt(2 * L)),
        }

    embed = park({"wte": nrm((V, H))})
    blocks = [park(one_block()) for _ in range(L)]
    head = park({"lnf_g": ones((H,)), "head_w": nrm((H, V))})
    return {"embed": embed, "blocks": blocks, "head": head}


def streamed_fns(cfg: LlamaConfig):
    """(embed_fn, block_fn, head_loss_fn) for
    ``build_param_streamed_train_step``: the math of ``dense_loss``."""
    return (lambda p, tokens: dense_embed(p, tokens, cfg),
            lambda p, x: dense_block(p, x, cfg),
            lambda p, x, labels: dense_head_loss(p, x, labels, cfg))
