"""Weight initializers (counterpart: ``paddle_tpu/nn/initializer.py``
``Constant``, ``Normal``, ``XavierNormal``, ``XavierUniform``): the same
distributions, drawn on the host from the framework's generator
(``paddle_tpu_torch.random``), so they do not reproduce ``jax.random``'s
values; a test that compares the two packages loads the JAX weights
(``models/convert.py`` ``load_params``)."""

from __future__ import annotations

import math

import torch

from .. import random as _random

__all__ = ["Initializer", "Constant", "Normal", "XavierNormal",
           "XavierUniform"]


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype=torch.float32):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32):
        return torch.full(tuple(shape), self.value, dtype=dtype)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32):
        z = torch.randn(tuple(shape), generator=_random.get_generator())
        return (self.mean + self.std * z).to(dtype)


class XavierNormal(Initializer):
    """std = gain * sqrt(2 / (fan_in + fan_out)), fans of an ``[in, out]``
    weight."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32):
        fi, fo = _fans(tuple(shape))
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        z = torch.randn(tuple(shape), generator=_random.get_generator())
        return (std * z).to(dtype)


class XavierUniform(Initializer):
    """U(-limit, limit), limit = gain * sqrt(6 / (fan_in + fan_out))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32):
        fi, fo = _fans(tuple(shape))
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        u = torch.rand(tuple(shape), generator=_random.get_generator())
        return ((2.0 * u - 1.0) * limit).to(dtype)
