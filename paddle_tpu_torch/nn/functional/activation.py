"""Activations (counterpart: ``paddle_tpu/nn/functional/activation.py``
``gelu``, ``tanh``, ``relu``, ``swish`` and its alias ``silu``): the
surface the BERT and Llama paths need."""

from __future__ import annotations

import torch

__all__ = ["gelu", "tanh", "relu", "swish", "silu"]


def gelu(x, approximate=False):
    """GELU: exact (erf) by default, the tanh form with
    ``approximate=True`` (``jax.nn.gelu``'s flag)."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate
                                    else "none")


def tanh(x):
    return torch.tanh(x)


def relu(x):
    return torch.relu(x)


def swish(x):
    """x * sigmoid(x) (``jax.nn.silu``)."""
    return torch.nn.functional.silu(x)


silu = swish
