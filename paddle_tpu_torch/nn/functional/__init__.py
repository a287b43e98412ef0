"""Functional ops (counterpart: ``paddle_tpu/nn/functional``), as far as the
port has them."""

from .activation import gelu, relu, silu, swish, tanh
from .common import dropout, embedding, linear
from .flash_attention import scaled_dot_product_attention
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["gelu", "relu", "silu", "swish", "tanh", "dropout", "embedding",
           "linear", "scaled_dot_product_attention", "cross_entropy",
           "layer_norm", "rms_norm"]
