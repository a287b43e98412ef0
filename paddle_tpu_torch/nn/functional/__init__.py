"""Functional ops (counterpart: ``paddle_tpu/nn/functional``), as far as the
port has them. As in the JAX package, the function ``flash_attention``
shadows the submodule of the same name here: reach the module with
``importlib.import_module`` or ``from ...flash_attention import ...``."""

from .activation import gelu, relu, silu, swish, tanh
from .common import dropout, embedding, linear
from .flash_attention import (flash_attention, flash_attn_unpadded,
                              flashmask_attention,
                              scaled_dot_product_attention)
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["gelu", "relu", "silu", "swish", "tanh", "dropout", "embedding",
           "linear", "scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "flashmask_attention", "cross_entropy",
           "layer_norm", "rms_norm"]
