"""Common functional ops (counterpart: ``paddle_tpu/nn/functional/common.py``
``linear``, ``dropout``, ``embedding``): the surface the BERT and Llama
paths need.

``linear`` contracts over the weight's leading axis (Paddle's ``[in, out]``
layout, never ``torch.nn.functional.linear``'s ``[out, in]``). Operands of
two dtypes are both cast to ``torch.promote_types`` of the pair first, as
``jnp.matmul`` promotes (bf16 x with an fp32 W multiplies in fp32); the bias
is added in the product's dtype, so an fp32 bias beside bf16 activations
does not promote the output. ``dropout`` draws its mask from an explicit
generator (``paddle_tpu_torch.random``); its bits are torch's, not
``jax.random``'s.
"""

from __future__ import annotations

import torch

from ... import random as _random
from ...enforce import enforce

__all__ = ["linear", "dropout", "embedding"]


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with W ``[in, out]``."""
    del name
    enforce(weight.dim() == 2 and x.dim() >= 1
            and x.shape[-1] == weight.shape[0],
            f"linear: x{tuple(x.shape)} @ W{tuple(weight.shape)} — last dim "
            f"of x must equal W's in dim", op="linear")
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Zero elements with probability ``p`` (``upscale_in_train`` scales
    the kept ones by 1 / (1 - p); ``downscale_in_infer`` scales by 1 - p
    at inference). ``axis``: the axes the mask varies along (the others
    broadcast). ``generator``: a CPU ``torch.Generator`` (None: the
    framework's current one); a card's mask is drawn on the card from a
    generator seeded by it."""
    del name
    if not training or p == 0.0:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = 1.0 - p
    gen = _random.device_generator(x.device, generator)
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    if mode == "upscale_in_train":
        return torch.where(mask, x / keep, 0.0).to(x.dtype)
    return torch.where(mask, x, 0.0).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` gathered by integer ids (the backward sums into
    the rows); ``padding_idx`` rows read as zeros."""
    del sparse, name
    out = torch.nn.functional.embedding(x.long(), weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out).to(
            weight.dtype)
    return out
