"""Layers (counterpart: ``paddle_tpu/nn``), as far as the port has them."""

from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, global_norm)
from .layer.common import Dropout, Embedding, Linear
from .layer.container import LayerList
from .layer.layers import Layer, functional_call, functional_train_graph
from .layer.norm import LayerNorm, RMSNorm
from .layer.transformer import (MultiHeadAttention, TransformerEncoder,
                                TransformerEncoderLayer)

__all__ = ["functional", "Layer", "Linear", "Dropout", "Embedding",
           "LayerNorm", "RMSNorm", "LayerList", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder", "functional_call",
           "functional_train_graph", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "global_norm"]
