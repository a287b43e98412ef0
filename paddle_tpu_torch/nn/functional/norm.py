"""Normalization ops (counterpart: ``paddle_tpu/nn/functional/norm.py``
``layer_norm``, with the dispatch of
``paddle_tpu/kernels/pallas/register.py`` ``_ln_supported`` /
``_layer_norm_pallas``).

``layer_norm`` is the registry op. Where the JAX gate admits the call (a
weight, one normalized axis equal to x's last), it goes to
``kernels/layer_norm.py``: the CUDA kernels for a CUDA tensor, their plain
version for a CPU tensor; the decision is by shape and device, never on a
failure. Any other call takes the composed op. Either way the output dtype
is x's: fp32 affine parameters beside bf16 rows do not promote it.
"""

from __future__ import annotations

import torch

from ...kernels.layer_norm import layer_norm as _layer_norm_kernel

__all__ = ["layer_norm"]


def _supported(x, normalized_shape, weight):
    return (weight is not None and len(normalized_shape) == 1
            and normalized_shape[0] == x.shape[-1]
            and weight.numel() == x.shape[-1])


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    del name
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    normalized_shape = tuple(normalized_shape)
    if _supported(x, normalized_shape, weight):
        return _layer_norm_kernel(x, weight, bias, epsilon)
    # the composed op: fp32 statistics, rounded to x's dtype before the
    # affine in x's dtype
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float()
    mean = xf.mean(axes, keepdim=True)
    var = (xf - mean).square().mean(axes, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out
