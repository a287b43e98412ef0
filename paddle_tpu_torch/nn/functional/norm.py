"""Normalization ops (counterpart: ``paddle_tpu/nn/functional/norm.py``
``layer_norm`` and ``rms_norm``, with the dispatch of
``paddle_tpu/kernels/pallas/register.py`` ``_ln_supported`` /
``_layer_norm_pallas`` and ``_rms_supported`` / ``_rms_norm_pallas``).

``layer_norm`` and ``rms_norm`` are registry ops. Where the JAX gate admits
the call, it goes to the kernels (``kernels/layer_norm.py``,
``kernels/rms_norm.py``): the CUDA kernels for a CUDA tensor, their plain
version for a CPU tensor; the decision is by shape and device, never on a
failure. Any other call takes the composed op. Either way the output dtype
is x's: fp32 affine parameters beside bf16 rows do not promote it.

The two paths round at different places. The kernels compute the
normalized value and its product with the weight (and bias) in fp32 and
round once to x's dtype. The composed op rounds the normalized value to x's
dtype first, then multiplies by the weight cast to x's dtype (and adds the
bias), rounding again. At fp32 the two agree; in bf16 they can differ by
one unit in the last place.
"""

from __future__ import annotations

import torch

from ...kernels.layer_norm import layer_norm as _layer_norm_kernel
from ...kernels.rms_norm import rms_norm as _rms_norm_kernel
from ...kernels.rms_norm import supported as _rms_kernel_supported

__all__ = ["layer_norm", "rms_norm"]


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


def _rms_supported(x, weight, bias, begin_norm_axis):
    # register.py _rms_supported: a weight and no bias over the last axis
    return (weight is not None and bias is None
            and begin_norm_axis in (-1, x.dim() - 1)
            and _rms_kernel_supported(x, weight))


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1):
    """x / sqrt(mean(x^2) + eps) over the axes from ``begin_norm_axis`` on,
    times ``weight`` (plus ``bias``)."""
    if _rms_supported(x, weight, bias, begin_norm_axis):
        return _rms_norm_kernel(x, weight, epsilon)
    # the composed op: fp32 statistics, rounded to x's dtype before the
    # weight in x's dtype
    axes = tuple(range(begin_norm_axis % x.dim(), x.dim()))
    xf = x.float()
    ms = (xf * xf).mean(axes, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out
