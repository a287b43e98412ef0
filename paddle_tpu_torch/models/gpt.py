"""GPT, the single-device dense model and the hybrid step at tensor and
pipeline degree 1 (counterpart: ``paddle_tpu/models/gpt.py`` ``GPTConfig``,
``_ln``, ``init_hybrid_params``, and the training half: ``dense_embed``,
``dense_block``, ``lm_logsumexp_ce``, ``dense_head_loss``, ``dense_forward``
and ``dense_loss``; ``hybrid_param_specs``, ``hybrid_loss_fn`` and
``build_hybrid_train_step`` at tensor and pipeline degree 1: data
parallelism and the ZeRO stages over ``models/hybrid_engine.py``, and
GPT-MoE at ep degree 1 (``_moe_block_fn``, the pair loop of
``_moe_pipeline``, ``moe_telemetry_series``); the presets ``gpt_tiny``,
``gpt_moe_tiny``, ``gpt_1p3b`` and ``gpt_6p7b``, and the
parameter-streaming form ``split_streamed_params``, ``init_streamed_params``
and ``streamed_fns``).

Parameters are a plain dict with the JAX pytree's keys and its stacked
``[L, ...]`` block leaves (GPT-MoE: ``{"dense": ..., "moe": ...}`` layer
pairs stacked ``[L/2, ...]``), so a tree made by the JAX init loads
straight in (``models/convert.py``). The init draws from a
``torch.Generator`` seeded by the caller; it is not meant to reproduce
``jax.random``.

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

__all__ = ["GPTConfig", "gpt_tiny", "gpt_moe_tiny", "gpt_1p3b", "gpt_6p7b",
           "init_hybrid_params", "dense_embed", "dense_block",
           "lm_logsumexp_ce", "dense_head_loss", "dense_forward",
           "dense_loss", "hybrid_param_specs", "hybrid_loss_fn",
           "build_hybrid_train_step", "split_streamed_params",
           "init_streamed_params", "streamed_fns", "moe_telemetry_series",
           "MOE_RECORD"]


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
    # GPT-MoE: > 0 replaces every second layer's FFN with a switch-routed
    # (top-1, capacity-bounded) bank of this many experts; 0 is dense GPT
    moe_num_experts: int = 0
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 1e-2

    def __post_init__(self):
        if self.ffn_hidden is None:
            self.ffn_hidden = 4 * self.hidden_size
        enforce(self.hidden_size % self.num_heads == 0,
                "hidden_size must be divisible by num_heads", op="GPTConfig",
                hidden_size=self.hidden_size, num_heads=self.num_heads)
        enforce(self.moe_num_experts == 0 or self.num_layers % 2 == 0,
                "GPT-MoE stacks (dense, MoE) layer PAIRS — num_layers must "
                "be even", op="GPTConfig", num_layers=self.num_layers)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def moe_on(self) -> bool:
        return self.moe_num_experts > 0


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=4,
                     num_heads=4, max_seq_len=256, **kw)


def gpt_moe_tiny(**kw):
    kw.setdefault("moe_num_experts", 8)
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=4,
                     num_heads=4, max_seq_len=256, **kw)


def gpt_1p3b(**kw):
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                     max_seq_len=2048, **kw)


def gpt_6p7b(**kw):
    return GPTConfig(hidden_size=4096, num_layers=32, num_heads=32,
                     max_seq_len=2048, **kw)


def init_hybrid_params(cfg: GPTConfig, seed: int,
                       device=None) -> Dict[str, object]:
    """Stacked-parameter dict: std 0.02 normals, ``std/sqrt(2L)`` for the
    residual projections ``proj_w`` / ``fc2_w`` (and the experts' ``w2``),
    LayerNorm gains 1 and biases 0, all in ``cfg.param_dtype`` on
    ``device`` (``None``: the CUDA card, raising without one; ``"meta"``:
    shapes only). GPT-MoE: ``blocks = {"dense": ..., "moe": ...}``, each
    stacked ``[L/2]``; the MoE half holds its own attention, ``gate_w
    [L/2, H, E]`` and the expert bank ``w1 [L/2, E, H, FF]``, ``b1``,
    ``w2 [L/2, E, FF, H]``, ``b2``."""
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

    def dense_blocks(nl):
        return {
            "ln1_g": const((nl, H), 1.0),
            "ln1_b": const((nl, H), 0.0),
            "qkv_w": nrm((nl, H, 3 * H)),
            "qkv_b": const((nl, 3 * H), 0.0),
            "proj_w": nrm((nl, H, H), std / math.sqrt(2 * L)),
            "proj_b": const((nl, H), 0.0),
            "ln2_g": const((nl, H), 1.0),
            "ln2_b": const((nl, H), 0.0),
            "fc1_w": nrm((nl, H, FF)),
            "fc1_b": const((nl, FF), 0.0),
            "fc2_w": nrm((nl, FF, H), std / math.sqrt(2 * L)),
            "fc2_b": const((nl, H), 0.0),
        }

    wte = nrm((V, H))
    wpe = nrm((cfg.max_seq_len, H))
    if cfg.moe_on:
        L2, E = L // 2, cfg.moe_num_experts
        blocks = {
            "dense": dense_blocks(L2),
            "moe": {
                "ln1_g": const((L2, H), 1.0),
                "ln1_b": const((L2, H), 0.0),
                "qkv_w": nrm((L2, H, 3 * H)),
                "qkv_b": const((L2, 3 * H), 0.0),
                "proj_w": nrm((L2, H, H), std / math.sqrt(2 * L)),
                "proj_b": const((L2, H), 0.0),
                "ln2_g": const((L2, H), 1.0),
                "ln2_b": const((L2, H), 0.0),
                "gate_w": nrm((L2, H, E)),
                "w1": nrm((L2, E, H, FF)),
                "b1": const((L2, E, FF), 0.0),
                "w2": nrm((L2, E, FF, H), std / math.sqrt(2 * L)),
                "b2": const((L2, E, H), 0.0),
            },
        }
    else:
        blocks = dense_blocks(L)
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


_QKV_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b")


def _ln_qkv_on_use(p, x, cfg: GPTConfig, gather):
    return _ln_qkv(p if gather is None else gather(p), x, cfg)


def _block_tail_on_use(p, x, attn, cfg: GPTConfig, gather):
    return _block_tail(p if gather is None else gather(p), x, attn, cfg)


def _block_selective(p, x, cfg: GPTConfig, gather=None):
    """The default remat mode, the reference's
    ``save_only_these_names("attn_out", "qkv")``: the qkv projection and the
    attention output are kept, the rest of the block is recomputed in the
    backward. ln1 and the qkv GEMM run under one selective checkpoint that
    keeps the GEMM's output and recomputes ln1 (its output included) for
    the GEMM's weight gradient; the flash call keeps its inputs (views of
    ``qkv``), its output and its lse; projection, ln2 and the MLP run under
    a checkpoint of (x, attn).

    ``gather`` (ZeRO-3, a ``comm_overlap.LayerGather``): ``p`` holds the
    layer's dp shards, and each checkpointed part gathers the parameters
    it uses inside itself, so the backward's replay gathers them again and
    no full parameter outlives its part."""
    pa, pb = p, p
    if gather is not None:
        pa = {k: p[k] for k in _QKV_KEYS}
        pb = {k: v for k, v in p.items() if k not in _QKV_KEYS}
    qkv = checkpoint(_ln_qkv_on_use, pa, x, cfg, gather, use_reentrant=False,
                     context_fn=functools.partial(
                         create_selective_checkpoint_contexts, _keep_qkv))
    return checkpoint(_block_tail_on_use, pb, x, _attention(qkv), cfg, gather,
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


# ---------------------------------------------------------------------------
# the hybrid step at mp = pp = 1: data parallelism and ZeRO stages 0-3
# ---------------------------------------------------------------------------
def hybrid_param_specs(cfg: GPTConfig) -> Dict[str, object]:
    """The JAX package's PartitionSpecs as tuples: blocks stacked over
    "pp", Megatron shardings over "mp", the vocab over "mp"; GPT-MoE's
    expert bank over "ep" (and its hidden dim over "mp"), the gate
    replicated. At mp = pp = ep = 1 they only steer ``zero_dims`` (a dim an
    axis names is never the dp dim)."""
    dense = {
        "ln1_g": ("pp",), "ln1_b": ("pp",),
        "qkv_w": ("pp", None, "mp"), "qkv_b": ("pp", "mp"),
        "proj_w": ("pp", "mp", None), "proj_b": ("pp",),
        "ln2_g": ("pp",), "ln2_b": ("pp",),
        "fc1_w": ("pp", None, "mp"), "fc1_b": ("pp", "mp"),
        "fc2_w": ("pp", "mp", None), "fc2_b": ("pp",),
    }
    if cfg.moe_on:
        blocks = {
            "dense": dense,
            "moe": {
                "ln1_g": ("pp",), "ln1_b": ("pp",),
                "qkv_w": ("pp", None, "mp"), "qkv_b": ("pp", "mp"),
                "proj_w": ("pp", "mp", None), "proj_b": ("pp",),
                "ln2_g": ("pp",), "ln2_b": ("pp",),
                "gate_w": ("pp",),
                "w1": ("pp", "ep", None, "mp"),
                "b1": ("pp", "ep", "mp"),
                "w2": ("pp", "ep", "mp", None),
                "b2": ("pp", "ep"),
            },
        }
    else:
        blocks = dense
    return {
        "wte": ("mp", None),
        "wpe": (),
        "blocks": blocks,
        "lnf_g": (), "lnf_b": (),
        "head_w": (None, "mp"),
    }


class _DpMean(torch.autograd.Function):
    """The loss's mean over dp: an all-reduce forward, identity backward
    (each rank's gradient is its own batch's; the engine's reduction
    averages them), as ``lax.pmean`` of the loss transposes under the JAX
    engine's ``shard_map``."""

    @staticmethod
    def forward(ctx, x, group, n):
        from ..distributed import collective as C
        return C.all_reduce(x.detach().clone().reshape(1), C.ReduceOp.SUM,
                            group)[0] / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _vocab_ce(logits, labels, ignore_index: int = -100):
    """Mean CE over the valid tokens (``_vocab_parallel_ce`` at mp 1): the
    logsumexp in fp32, ``ignore_index`` labels left out of both sums."""
    lf = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    loss = torch.logsumexp(lf, -1) - lf.gather(-1, safe[..., None])[..., 0]
    total = torch.where(valid, loss, 0.0).sum()
    return total / valid.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# GPT-MoE at ep degree 1: (dense, MoE) layer pairs
# ---------------------------------------------------------------------------
# The last hybrid_loss_fn call's MoE routing record (detached tensors on the
# loss's device): "drop_frac", the share of the routed tokens that lost
# their capacity slot, and "tokens", the tokens routed to each expert [E],
# summed over every (MoE layer, microbatch). In-program telemetry (ROADMAP
# Queue 1 item 9) will take its place as the series moe_telemetry_series
# names.
MOE_RECORD: Dict[str, torch.Tensor] = {}


def moe_telemetry_series(cfg: GPTConfig):
    """The telemetry series the GPT-MoE loss observes: the capacity-drop
    fraction and, for at most 32 experts, the routed tokens per expert."""
    if not cfg.moe_on:
        return ()
    series = ("moe_drop_frac",)
    if cfg.moe_num_experts <= 32:
        series += tuple(f"moe_tokens_e{i}"
                        for i in range(cfg.moe_num_experts))
    return series


def _moe_tail(p, x, attn, cfg: GPTConfig, mcfg):
    """The MoE block after the flash call: the projection and residual of
    the attention sublayer (``x + (out + proj_b)``, as ``_attn_sublayer``),
    ln2, the fp32 router (top-1), the Switch load-balance aux
    E * sum(me * ce) (``me`` carries the gradient, the one-hot ``ce``
    none), capacity dispatch over this microbatch's tokens, dense ([T, E, C]
    one-hot einsums) or index (``mcfg.index``: slot ids), the expert bank
    through ``expert_exchange`` (tanh GELU in fp32, cast back), the combine
    with the gate weights rounded to the compute dtype, and the residual.
    Returns (x_out, aux, tokens per expert [E], kept tokens)."""
    from ..distributed.comm_overlap import a2a as _a2a
    from ..incubate.distributed.models.moe.gate import (
        _capacity_dispatch, _capacity_dispatch_idx, _one_hot,
        compute_capacity)
    from ..incubate.distributed.models.moe.moe_layer import (_index_combine,
                                                             _index_scatter)
    B, S, H = x.shape
    out = attn.reshape(B, S, H) @ p["proj_w"].to(cfg.dtype)
    x = x + (out + p["proj_b"].to(cfg.dtype))
    h = _ln(x, p["ln2_g"], p["ln2_b"])
    T = B * S
    E = cfg.moe_num_experts
    xt = h.reshape(T, H).to(cfg.dtype)
    probs = torch.softmax(xt.float() @ p["gate_w"].float(), dim=-1)
    gate_val = probs.amax(dim=-1)
    expert = probs.argmax(dim=-1)
    me = probs.mean(dim=0)
    ce = _one_hot(expert, E).mean(dim=0)
    aux = torch.sum(me * ce) * E
    C = compute_capacity(T, E, 1, cfg.moe_capacity_factor)
    index = mcfg is not None and mcfg.index
    if index:
        slot, gates, counts = _capacity_dispatch_idx(expert, gate_val, C, E)
        kept = (slot >= 0).float().sum()
        dispatched, slot_safe = _index_scatter(xt, slot[:, None], E, C)
    else:
        combine, keep_tok, counts = _capacity_dispatch(expert, gate_val, C,
                                                       E)
        kept = keep_tok.float().sum()
        dispatched = torch.einsum("tec,td->ecd",
                                  (combine > 0).to(xt.dtype), xt)

    def act(m):
        return F.gelu(m.float(), approximate="tanh").to(cfg.dtype)

    returned, _ = _a2a.expert_exchange(
        dispatched, p["w1"].to(cfg.dtype), p["b1"].to(cfg.dtype),
        p["w2"].to(cfg.dtype), p["b2"].to(cfg.dtype), ep_axis="ep",
        activation=act, cfg=mcfg)
    if index:
        y = _index_combine(returned, gates[:, None], slot_safe)
    else:
        y = torch.einsum("tec,ecd->td", combine.to(returned.dtype), returned)
    return x + y.reshape(B, S, H).to(x.dtype), aux, counts, kept


def _moe_block_fn(p, x, cfg: GPTConfig, mcfg=None):
    """One MoE block in the default selective remat, as
    ``_block_selective``: ln1 and the qkv GEMM under a checkpoint that
    keeps the GEMM's output, the flash call keeping its inputs, output and
    lse, and the rest under a checkpoint of (x, attn). The dense-dispatch
    one-hots ([T, E, C] fp32 and its bf16 copies) are rebuilt in the
    backward's replay from the integer routing, so no layer's outlives its
    forward. Returns (x_out, stats) with stats {"aux", "tokens", "kept"}."""
    qkv = checkpoint(_ln_qkv_on_use, p, x, cfg, None, use_reentrant=False,
                     context_fn=functools.partial(
                         create_selective_checkpoint_contexts, _keep_qkv))
    x, aux, counts, kept = checkpoint(_moe_tail, p, x, _attention(qkv), cfg,
                                      mcfg, use_reentrant=False)
    return x, {"aux": aux, "tokens": counts, "kept": kept}


def _moe_pairs(params, x, cfg: GPTConfig, M: int, mcfg):
    """The pair loop of ``_moe_pipeline`` at pp degree 1: for each of the M
    microbatches of ``x``, every (dense, MoE) pair in order. Returns (out,
    stats summed over every (layer, microbatch))."""
    dense = {k: v.unbind(0) for k, v in params["blocks"]["dense"].items()}
    moe = {k: v.unbind(0) for k, v in params["blocks"]["moe"].items()}
    outs, total = [], None
    for xm in x.chunk(M, dim=0):
        tick = None
        for i in range(cfg.num_layers // 2):
            xm = _block_selective({k: v[i] for k, v in dense.items()}, xm,
                                  cfg)
            xm, st = _moe_block_fn({k: v[i] for k, v in moe.items()}, xm,
                                   cfg, mcfg)
            tick = st if tick is None else {k: tick[k] + st[k] for k in st}
        total = tick if total is None else {k: total[k] + tick[k]
                                            for k in tick}
        outs.append(xm)
    return (outs[0] if M == 1 else torch.cat(outs, dim=0)), total


def _refuse_later_items(virtual_pp, schedule, fp8, sp, moe_ef, flash, num,
                        mesh=None, pp_axis="pp", mp_axis="mp",
                        ep_axis="ep", sep_axis="sep"):
    if virtual_pp != 1 or schedule != "1F1B":
        raise _not_ported("pipeline schedules (virtual_pp / ZBH1)", 6)
    if fp8 is not None:
        raise _not_ported("fp8 delayed scaling (fp8=)", 7)
    if sp is not None:
        raise _not_ported("mp sequence parallelism (mp_overlap=)", 6)
    if moe_ef is not None:
        raise _not_ported("the int8 error-feedback expert all-to-all "
                          "(moe_ef= / moe_ef_tokens=)", 6)
    if flash is not None:
        raise _not_ported("the FlashAttentionConfig route and sep context "
                          "parallelism (flash=)", 6)
    if num is not None:
        raise _not_ported("numerics telemetry (numerics=)", 9)
    if mesh is not None:
        for a in (pp_axis, mp_axis, ep_axis, sep_axis):
            if mesh.shape.get(a, 1) > 1:
                raise _not_ported(f"the mesh axis {a!r} of degree "
                                  f"{mesh.shape[a]}", 6)


def _moe_zero3_refused():
    return _not_ported("ZeRO-3 of GPT-MoE (the gather-on-use over (dense, "
                       "MoE) layer pairs)", 11)


def hybrid_loss_fn(params, tokens, labels, cfg: GPTConfig,
                   num_microbatches: int, dp_axis="dp", pp_axis="pp",
                   mp_axis="mp", virtual_pp: int = 1, schedule: str = "1F1B",
                   fp8=None, sp=None, ep_axis="ep", moe=None, moe_ef=None,
                   flash=None, sep_axis="sep", z3=None, z3_ef=None, num=None,
                   *, mesh=None):
    """This rank's loss of the hybrid GPT at mp = pp = 1: the embedding,
    the blocks over ``num_microbatches`` slices of this rank's batch (each
    block in the default selective remat), the final LN, the head and the
    CE over the whole local batch, averaged over dp (``_DpMean``; with
    ``mesh=None``, one device: no mean).

    GPT-MoE (``cfg.moe_num_experts > 0``): every (dense, MoE) pair per
    microbatch; the loss adds ``moe_aux_weight`` times the aux loss's mean
    over every (MoE layer, microbatch), and the mean spans dp x ep. ``moe``
    is a ``MoeDispatchConfig`` (None: dense dispatch). ``MOE_RECORD`` gets
    the drop fraction and the tokens per expert.

    ``z3`` (the ZeRO-3 plan of ``build_hybrid_train_step``: ``zdims``,
    ``axis``, ``cfg``, ``other_leaves``): the dp-shardable leaves arrive
    as this rank's shards; the embedding, final LN and head leaves are
    gathered once at the top (one group), the block leaves per layer
    inside each block's checkpointed parts (``comm_overlap.scan_gather``:
    the ln1 / qkv group where it is used, the rest of block i+1 as one
    group issued before block i runs). ``z3_ef``: this rank's stacked
    int8-EF residuals; the return is then ``(loss, new_z3_ef)``."""
    _refuse_later_items(virtual_pp, schedule, fp8, sp, moe_ef, flash, num,
                        mesh, pp_axis, mp_axis, ep_axis, sep_axis)
    if cfg.moe_on and z3 is not None:
        raise _moe_zero3_refused()
    b_local, S = tokens.shape
    M = int(num_microbatches)
    enforce(b_local % M == 0,
            "per-dp-rank batch must be divisible by num_microbatches",
            op="gpt.hybrid_loss_fn", batch_local=b_local, microbatches=M)
    group = mesh.group(dp_axis) if mesh is not None else None
    if z3 is not None:
        from ..distributed.comm_overlap import zero3 as Z3
        params = dict(params)
        names = [n for n in z3["other_leaves"] if z3["zdims"][n] >= 0]
        params.update(zip(names, Z3.gather_group(
            [params[n] for n in names], [z3["zdims"][n] for n in names],
            group)))
    x = dense_embed(params, tokens, cfg)
    stats = None
    if cfg.moe_on:
        out, stats = _moe_pairs(params, x, cfg, M, moe)
    else:
        outs, new_res = [], None
        for xm in x.chunk(M, dim=0):
            if z3 is not None:
                xm, new_res = Z3.scan_gather(
                    lambda lg, h: _block_selective(lg.shards, h, cfg,
                                                   gather=lg),
                    xm, params["blocks"], z3["zdims"]["blocks"], group,
                    cfg=z3["cfg"], residuals=z3_ef,
                    # ln1 / qkv are gathered inside their selective
                    # checkpoint, which must see the same operations in
                    # its replay
                    sync_keys=_QKV_KEYS)
            else:
                layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
                for i in range(cfg.num_layers):
                    xm = _block_selective({k: v[i] for k, v in layers.items()},
                                          xm, cfg)
            outs.append(xm)
        out = outs[0] if M == 1 else torch.cat(outs, dim=0)
    out = _ln(out, params["lnf_g"], params["lnf_b"])
    logits = out.to(cfg.dtype) @ params["head_w"].to(cfg.dtype)
    total = _vocab_ce(logits, labels)
    n_mean = 1
    if mesh is not None:
        n_mean = mesh.shape[dp_axis]
    if stats is not None:
        L2 = cfg.num_layers // 2
        # aux summed over every (layer, microbatch) execution -> its mean
        total = total + (stats["aux"] / float(L2 * M)) * cfg.moe_aux_weight
        routed = float(L2 * M) * float((b_local // M) * S)
        MOE_RECORD["drop_frac"] = (1.0 - stats["kept"] / routed).detach()
        MOE_RECORD["tokens"] = stats["tokens"].detach()
        if mesh is not None:
            # the batch is split over dp and ep: the mean spans both (at
            # ep 1 the dp x ep group is the dp group)
            n_mean *= mesh.shape.get(ep_axis, 1)
    if mesh is not None:
        total = _DpMean.apply(total, group, n_mean)
    if z3_ef is not None:
        return total, new_res
    return total


def build_hybrid_train_step(cfg: GPTConfig, mesh, optimizer,
                            num_microbatches: int = 1, dp_axis="dp",
                            pp_axis="pp", mp_axis="mp", extra_grad_axes=(),
                            virtual_pp: int = 1, schedule: str = "1F1B",
                            grad_reduce_dtype="auto", zero1_dp: bool = False,
                            zero_stage="auto", zero3="auto",
                            comm_overlap="auto", fp8="auto",
                            telemetry="auto", mp_overlap="auto",
                            ep_axis="ep", moe_dispatch="auto",
                            moe_ef_tokens=None, flash_attention="auto",
                            sep_axis="sep", numerics="auto",
                            donate: bool = False):
    """The hybrid train step at mp = pp = 1 over
    ``hybrid_engine.build_train_step``: returns ``(step, shard_params,
    init_state)`` (see there). ``zero_stage`` "auto" reads
    FLAGS_zero_stage; stage 3 builds the gather-on-use plan (``zero3``:
    "auto" reads FLAGS_zero3_overlap_ag / FLAGS_zero3_quantize_ag, or a
    ``Zero3Config``; the quantized gathers thread their residuals through
    ``state["zero3_ef"]``, pp degree 1 and one microbatch only).

    GPT-MoE (``cfg.moe_num_experts > 0``): the mesh must carry ``ep_axis``
    (degree 1 here) dividing the expert count, the expert hidden dim
    divides by mp, the batch splits over dp x ep. ``moe_dispatch``: "auto"
    reads FLAGS_moe_index_dispatch (and the exchange's flags), None the
    dense dispatch, a ``MoeDispatchConfig`` forces. ZeRO stages 0-2.

    The later items' arguments keep their "auto" (off here) and raise
    NotImplementedError naming the item otherwise: ``virtual_pp`` /
    ``schedule`` / ``mp_overlap`` / ``flash_attention``, mesh axes other
    than dp, the MoE exchange's ``quantize`` / ``overlap`` /
    ``moe_ef_tokens`` (6), ``fp8`` (7), ``telemetry`` / ``numerics`` (9),
    ZeRO-3 of GPT-MoE (11). The flash kernels run in every block anyway,
    through the attention registry op."""
    from ..distributed.comm_overlap.zero3 import (resolve_zero3,
                                                  resolve_zero_stage)
    from .hybrid_engine import build_train_step, zero_dims

    def on(arg):
        return arg not in ("auto", None, False)
    _refuse_later_items(
        virtual_pp, schedule, True if on(fp8) else None,
        True if on(mp_overlap) else None,
        True if (cfg.moe_on and moe_ef_tokens is not None) else None,
        True if on(flash_attention) else None,
        True if on(numerics) else None, mesh, pp_axis, mp_axis, ep_axis,
        sep_axis)
    if telemetry not in ("auto", None):
        raise _not_ported("in-program telemetry (telemetry=)", 9)
    mcfg = moe_plan = None
    if cfg.moe_on:
        from ..distributed.comm_overlap import a2a as _a2a
        enforce(ep_axis in mesh.axis_names,
                "GPT-MoE shards the expert bank over an expert-parallel "
                f"mesh axis: add '{ep_axis}' (degree >= 1) to the mesh",
                op="gpt.build_hybrid_train_step",
                axes=tuple(mesh.axis_names))
        ep = int(mesh.shape[ep_axis])
        E = cfg.moe_num_experts
        enforce(E % ep == 0, "the ep degree must divide the expert count",
                op="gpt.build_hybrid_train_step", experts=E, ep=ep)
        mp = int(mesh.shape.get(mp_axis, 1))
        enforce(cfg.ffn_hidden % mp == 0,
                "the expert hidden dim shards over mp",
                op="gpt.build_hybrid_train_step",
                ffn_hidden=cfg.ffn_hidden, mp=mp)
        mcfg = _a2a.resolve_moe_dispatch(moe_dispatch)
        _a2a.check_ep1(mcfg)
        moe_plan = {
            "ep_axis": ep_axis, "ef": None,
            "meta": {"ep": ep, "experts": E,
                     "dispatch": ("index" if (mcfg is not None
                                              and mcfg.index)
                                  else "dense"),
                     "quantize": False, "overlap": False},
        }
    specs = hybrid_param_specs(cfg)
    example = init_hybrid_params(cfg, 0, device="meta")
    stage = resolve_zero_stage(zero_stage, zero1_dp,
                               op="gpt.build_hybrid_train_step")
    z3plan = z3_engine = None
    if stage >= 3 and cfg.moe_on:
        raise _moe_zero3_refused()
    if stage >= 3:
        z3cfg = resolve_zero3(zero3)
        zdims = zero_dims(specs, example, mesh, dp_axis)
        z3plan = {"zdims": zdims, "axis": dp_axis, "cfg": z3cfg,
                  "other_leaves": ("wte", "wpe", "lnf_g", "lnf_b",
                                   "head_w")}
        z3_engine = {"ef": None, "meta": z3cfg.meta()}
        if z3cfg.quantize:
            enforce(mesh.shape.get(pp_axis, 1) == 1
                    and num_microbatches == 1 and virtual_pp == 1,
                    "zero3_quantize_ag threads ONE error-feedback "
                    "residual slot per layer per step; pipeline "
                    "microbatching would sum residuals across ticks — "
                    "use pp degree 1, num_microbatches 1",
                    op="gpt.build_hybrid_train_step",
                    pp=mesh.shape.get(pp_axis, 1),
                    num_microbatches=num_microbatches)
            dp = mesh.shape[dp_axis]
            shapes = {}
            for k, ex in example["blocks"].items():
                zd = zdims["blocks"][k]
                shp = list(ex.shape)
                if zd >= 0:
                    shp[zd] //= dp
                shapes[k] = tuple(shp) if zd >= 0 else (shp[0], 0)

            # the residuals mirror this rank's block shards (fp32); a leaf
            # with no dp dim holds a 0-column placeholder
            def ef_init(_shapes=shapes):
                return {k: torch.zeros(s, dtype=torch.float32)
                        for k, s in _shapes.items()}
            z3_engine = {"ef": {"init": ef_init}, "meta": z3cfg.meta()}

    if z3_engine is not None and z3_engine["ef"] is not None:
        def loss_fn(p, tokens, labels, z3_ef):
            return hybrid_loss_fn(p, tokens, labels, cfg, num_microbatches,
                                  dp_axis, pp_axis, mp_axis, z3=z3plan,
                                  z3_ef=z3_ef, mesh=mesh)
    else:
        def loss_fn(p, tokens, labels):
            return hybrid_loss_fn(p, tokens, labels, cfg, num_microbatches,
                                  dp_axis, pp_axis, mp_axis, ep_axis=ep_axis,
                                  moe=mcfg, z3=z3plan, mesh=mesh)
    step, shard_params, init_state = build_train_step(
        loss_fn, specs, mesh, optimizer, dp_axis=dp_axis,
        data_spec=((dp_axis, ep_axis),) if cfg.moe_on else None,
        extra_grad_axes=extra_grad_axes, example_params=example,
        grad_reduce_dtype=grad_reduce_dtype, zero_stage=stage,
        zero3=z3_engine, comm_overlap=comm_overlap, telemetry=None,
        moe=moe_plan, donate=donate)
    return step, shard_params, init_state


# ---------------------------------------------------------------------------
# the parameter-streaming (bigger-than-device) form: segmented parameters
# ---------------------------------------------------------------------------
def split_streamed_params(params, cfg: GPTConfig):
    """Stacked tree -> the segmented ``{"embed", "blocks": [per layer],
    "head"}`` layout of ``build_param_streamed_train_step`` (the blocks are
    views of the stacked leaves; a bigger-than-device model is made by
    ``init_streamed_params`` instead)."""
    blocks = [{k: v[i] for k, v in params["blocks"].items()}
              for i in range(cfg.num_layers)]
    return {"embed": {"wte": params["wte"], "wpe": params["wpe"]},
            "blocks": blocks,
            "head": {"lnf_g": params["lnf_g"], "lnf_b": params["lnf_b"],
                     "head_w": params["head_w"]}}


def init_streamed_params(cfg: GPTConfig, seed: int, park=lambda t: t,
                         device=None):
    """The segmented init, ONE segment on ``device`` at a time (None: the
    card), each handed to ``park`` (e.g. ``distributed.sharding.park``)
    before the next is drawn: a whole-tree init of a 6.7B model would not
    fit beside its first step. The distributions of ``init_hybrid_params``,
    drawn from one ``torch.Generator`` seeded with ``seed`` in the order
    embedding, blocks, head (not the stacked init's values)."""
    H, L, FF, V = (cfg.hidden_size, cfg.num_layers, cfg.ffn_hidden,
                   cfg.vocab_size)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    std, pd = 0.02, cfg.param_dtype

    def nrm(shape, scale=std):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * scale).to(pd)

    def const(shape, value):
        return torch.full(shape, value, dtype=pd, device=device)

    def one_block():
        return {
            "ln1_g": const((H,), 1.0), "ln1_b": const((H,), 0.0),
            "qkv_w": nrm((H, 3 * H)), "qkv_b": const((3 * H,), 0.0),
            "proj_w": nrm((H, H), std / math.sqrt(2 * L)),
            "proj_b": const((H,), 0.0),
            "ln2_g": const((H,), 1.0), "ln2_b": const((H,), 0.0),
            "fc1_w": nrm((H, FF)), "fc1_b": const((FF,), 0.0),
            "fc2_w": nrm((FF, H), std / math.sqrt(2 * L)),
            "fc2_b": const((H,), 0.0),
        }

    embed = park({"wte": nrm((V, H)), "wpe": nrm((cfg.max_seq_len, H))})
    blocks = [park(one_block()) for _ in range(L)]
    head = park({"lnf_g": const((H,), 1.0), "lnf_b": const((H,), 0.0),
                 "head_w": nrm((H, V))})
    return {"embed": embed, "blocks": blocks, "head": head}


def streamed_fns(cfg: GPTConfig):
    """(embed_fn, block_fn, head_loss_fn) for
    ``build_param_streamed_train_step``: the math of ``dense_loss``."""
    return (lambda p, tokens: dense_embed(p, tokens, cfg),
            lambda p, x: dense_block(p, x, cfg),
            lambda p, x, labels: dense_head_loss(p, x, labels, cfg))
