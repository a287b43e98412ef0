"""Fused functional ops (counterpart:
``paddle_tpu/incubate/nn/functional/__init__.py``): ``fused_rms_norm``,
``fused_layer_norm``, ``fused_rotary_position_embedding`` (registry op
``fused_rope``), ``swiglu``, ``fused_linear``, ``fused_bias_act`` and the
dropless ``fused_moe`` (``fused_moe.py``).

``fused_rms_norm`` and ``fused_layer_norm`` are the registry ops
``rms_norm`` and ``layer_norm`` (``nn/functional/norm.py``): the RMSNorm and
LayerNorm kernels where their gates admit the call. The NeoX half-split
rotation of ``fused_rotary_position_embedding`` is the registry op
``fused_rope``: where ``kernels/rope.py`` ``supported`` admits every tensor
(4-D, an even D) it goes to ``apply_rope`` (the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor), else to the composed
``_rope_one_ref``. The interleaved style and a ``position_ids`` gather are
composed, as in the JAX package.

Decode-time and block-level fused ops are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from ....kernels import rope as _rope_kernel
from ....models.llama import _rope as _rope_one_ref  # the composed rotation
from ....nn import functional as F
from .fused_moe import fused_moe  # noqa: F401

__all__ = [
    "fused_rms_norm", "fused_layer_norm", "fused_rotary_position_embedding",
    "swiglu", "fused_linear", "fused_bias_act", "fused_moe",
    "masked_multihead_attention", "block_multihead_attention",
    "fused_attention", "fused_feedforward",
]


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


def masked_multihead_attention(x, cache_k, cache_v, seq_len, **kw):
    """Decode-step attention over a KV cache (``models/generation.py``)."""
    raise _not_ported("incubate masked_multihead_attention "
                      "(models/generation.py)", 1)


def block_multihead_attention(q, cache, **kw):
    """Paged-KV decode attention (``models/generation.py``)."""
    raise _not_ported("incubate block_multihead_attention "
                      "(models/generation.py)", 1)


def fused_attention(x, qkv_weight, linear_weight, *args, **kwargs):
    """The fused MHA block (LN, QKV, attention, projection, residual)."""
    raise _not_ported("incubate fused_attention", 10)


def fused_feedforward(x, linear1_weight, linear2_weight, *args, **kwargs):
    """The fused FFN block (LN, linear, activation, dropout, linear)."""
    raise _not_ported("incubate fused_feedforward", 10)


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1):
    """The registry op ``rms_norm``: the RMSNorm kernels for a weight, no
    bias and the last axis."""
    return F.rms_norm(x, norm_weight, norm_bias, epsilon, begin_norm_axis)


def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1):
    """The registry op ``layer_norm`` over the axes from
    ``begin_norm_axis`` on."""
    axis = begin_norm_axis % x.dim()
    return F.layer_norm(x, tuple(x.shape[axis:]), norm_weight, norm_bias,
                        epsilon)


def _normalize_cos_sin(cos, sin, seq_len, head_dim):
    """Accept [S, D/2], [S, D] (NeoX-duplicated halves: the first half is
    kept) or [1, S, 1, D]. ``seq_len=None`` keeps the full table (a
    ``position_ids`` gather may select rows beyond the query length)."""
    def norm(t):
        t = torch.as_tensor(t)
        t = t.reshape(-1, t.shape[-1])
        if t.shape[-1] == head_dim:
            t = t[:, :head_dim // 2]
        return t if seq_len is None else t[:seq_len]
    return norm(cos), norm(sin)


def _fused_rope(q, k, v, cos, sin):
    """The registry op ``fused_rope``: rotate q, k (and v) [B, S, H, D] by
    cos, sin [S, D/2]; None passes through."""
    ts = [t for t in (q, k, v) if t is not None]
    if all(_rope_kernel.supported(t, cos, sin) for t in ts):
        fn = _rope_kernel.apply_rope
    else:
        fn = _rope_one_ref
    return tuple(None if t is None else fn(t, cos, sin) for t in (q, k, v))


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False, rotate_half=False):
    """Returns (q, k, v) rotated; None stays None. Note the argument order:
    sin before cos. Without tables, the theta 10000 tables for q's length
    and head dim are made on q's device. Only the NeoX half-split style
    goes through ``fused_rope``; the interleaved style
    (``use_neox_rotary_style=False`` or ``rotate_half=True``) and a
    ``position_ids`` [B, S] gather are composed."""
    if time_major:
        raise NotImplementedError("time_major=False only (S-major layout)")
    seq_len, head_dim = q.shape[1], q.shape[-1]
    if cos is None or sin is None:
        inv = 1.0 / (10000.0 ** (torch.arange(
            0, head_dim, 2, dtype=torch.float32, device=q.device) / head_dim))
        ang = (torch.arange(seq_len, dtype=torch.float32,
                            device=q.device)[:, None] * inv[None, :])
        cos, sin = torch.cos(ang), torch.sin(ang)
    else:
        cos, sin = _normalize_cos_sin(
            cos, sin, None if position_ids is not None else seq_len,
            head_dim)
    if position_ids is not None:
        pos = torch.as_tensor(position_ids, device=cos.device).long()
        c, s = cos[pos][:, :, None, :], sin[pos][:, :, None, :]
        return tuple(None if t is None else _rope_kernel.rotate(t, c, s)
                     for t in (q, k, v))
    if not use_neox_rotary_style or rotate_half:
        # interleaved (GPT-J) style: de-interleave, rotate, re-interleave
        def rot(x):
            if x is None:
                return None
            xe, xo = x[..., 0::2].float(), x[..., 1::2].float()
            c, s = cos[None, :, None, :], sin[None, :, None, :]
            return torch.stack([xe * c - xo * s, xo * c + xe * s],
                               dim=-1).reshape(x.shape).to(x.dtype)
        return rot(q), rot(k), rot(v)
    return _fused_rope(q, k, v, cos, sin)


def swiglu(x, y=None):
    """silu(x) * y; with y None, x is split in half on the last axis."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


def fused_linear(x, weight, bias=None, transpose_weight=False):
    """x @ W (+ bias), with W transposed first when ``transpose_weight``;
    mixed dtypes promote as ``jnp.matmul`` does."""
    w = weight.T if transpose_weight else weight
    out = F.linear(x, w)
    if bias is not None:
        out = out + bias
    return out


def _gelu_tanh(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate=True)


_ACTS = {
    "gelu": _gelu_tanh, "relu": F.relu, "silu": F.silu,
    "swiglu": lambda x: swiglu(x), "identity": lambda x: x,
}


def fused_bias_act(x, bias=None, act_method="gelu", dequant_scales=None,
                   shift=None, smooth=None, quant_scale=-1, **kwargs):
    """act(x + bias (+ shift) (* smooth)); ``geglu`` is gelu(a) * b of x's
    halves. The int8 quant arguments raise, as in the JAX package."""
    if dequant_scales is not None or quant_scale != -1:
        raise NotImplementedError("int8 quant paths are not supported")
    if bias is not None:
        x = x + bias
    if shift is not None:
        x = x + shift
    if smooth is not None:
        x = x * smooth
    if act_method == "geglu":
        a, b = torch.chunk(x, 2, dim=-1)
        return _gelu_tanh(a) * b
    return _ACTS[act_method](x)
