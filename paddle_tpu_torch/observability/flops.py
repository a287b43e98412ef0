"""Analytic FLOPs models for step accounting (counterpart:
``paddle_tpu/observability/flops.py`` ``param_count``,
``transformer_flops_per_token``, ``gpt_flops_per_token``,
``llama_flops_per_token``, ``peak_flops`` and ``mfu``).

The accounting is the JAX package's, unchanged (the PaLM/Chinchilla rule):

* matmul params N (embeddings excluded) cost ``2N`` FLOPs/token forward and
  ``4N`` backward, ``6N`` per trained token;
* attention adds ``12 * L * H * S`` per token for seq len S, without the
  causal halving, as the reference's series does;
* ``model`` counts the useful work (the MFU numerator); ``hardware`` adds the
  recomputation a remat mode executes.

``peak_flops`` is keyed on ``torch.cuda.get_device_name``: the H100's dense
bf16 tensor-core peak is NVIDIA's published 989 TFLOP/s (SXM, 700 W).
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["param_count", "transformer_flops_per_token",
           "gpt_flops_per_token", "llama_flops_per_token", "peak_flops",
           "mfu"]

_REMAT_MODES = ("none", "full", "selective")

# dense bf16 tensor-core peaks, FLOP/s, by a substring of the device name
_PEAKS = {"h100": 989e12, "h200": 989e12}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params, exclude=("wte", "wpe", "emb", "embedding")) -> int:
    """Matmul-relevant parameter count of a param dict: all leaves minus the
    top-level embedding tables (6N-rule accounting)."""
    total = sum(t.numel() for t in _leaves(params))
    emb = 0
    if isinstance(params, dict):
        for k in exclude:
            if k in params:
                emb += sum(t.numel() for t in _leaves(params[k]))
    return total - emb


def transformer_flops_per_token(*, n_params: int, num_layers: int,
                                hidden_size: int, seq_len: int,
                                remat: str = "none") -> Dict[str, float]:
    """{"model": model FLOPs/token, "hardware": executed FLOPs/token}."""
    if remat not in _REMAT_MODES:
        raise ValueError(f"remat must be one of {_REMAT_MODES}, got {remat}")
    attn = 12.0 * num_layers * hidden_size * seq_len
    model = 6.0 * n_params + attn
    fwd = 2.0 * n_params + attn / 3.0
    hardware = model
    if remat == "full":
        hardware = model + fwd          # backward re-runs the forward
    elif remat == "selective":
        hardware = model + 0.5 * fwd    # half the forward recomputed
    return {"model": model, "hardware": hardware}


def _gpt_matmul_params(cfg) -> int:
    h, L = cfg.hidden_size, cfg.num_layers
    per_layer = 3 * h * h + h * h + h * cfg.ffn_hidden + cfg.ffn_hidden * h
    return L * per_layer + h * cfg.vocab_size  # blocks + untied LM head


def _llama_matmul_params(cfg) -> int:
    h, L, d = cfg.hidden_size, cfg.num_layers, cfg.head_dim
    kv = cfg.num_kv_heads * d
    attn = h * h + 2 * h * kv + h * h              # q, k, v, o
    ffn = 3 * h * cfg.intermediate_size            # gate, up, down
    return L * (attn + ffn) + h * cfg.vocab_size


def gpt_flops_per_token(cfg, seq_len: int, *, params=None,
                        remat: str = "none") -> Dict[str, float]:
    """FLOPs/token for a GPTConfig. Pass the param dict to count N exactly
    (as the reference's bench does); otherwise N comes from the config."""
    n = (param_count(params) if params is not None
         else _gpt_matmul_params(cfg))
    return transformer_flops_per_token(
        n_params=n, num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
        seq_len=seq_len, remat=remat)


def llama_flops_per_token(cfg, seq_len: int, *, params=None,
                          remat: str = "none") -> Dict[str, float]:
    """FLOPs/token for a LlamaConfig: N from the param dict when given,
    else from the config (blocks + the untied head, no embedding)."""
    n = (param_count(params) if params is not None
         else _llama_matmul_params(cfg))
    return transformer_flops_per_token(
        n_params=n, num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
        seq_len=seq_len, remat=remat)


def peak_flops(device_name: Optional[str] = None) -> float:
    """Dense bf16 peak FLOP/s of a CUDA card, from its name (default: card
    0). Raises for a card the table does not know: an MFU against a guessed
    peak would be a wrong number, not an approximate one."""
    if device_name is None:
        import torch
        device_name = torch.cuda.get_device_name(0)
    kind = device_name.lower()
    for key, val in _PEAKS.items():
        if key in kind:
            return val
    raise ValueError(f"no published peak for device {device_name!r}; known: "
                     f"{sorted(_PEAKS)}")


def mfu(tokens_per_sec: float, flops_per_token: float,
        peak: Optional[float] = None) -> float:
    peak = peak_flops() if peak is None else peak
    return tokens_per_sec * flops_per_token / peak
