"""Normalization layers (counterpart: ``paddle_tpu/nn/layer/norm.py``
``LayerNorm``, ``RMSNorm``)."""

from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes: weight ones,
    bias zeros, fp32 whatever the rows' dtype; ``weight_attr`` /
    ``bias_attr`` False drop them."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = (self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter(self.normalized_shape,
                                           attr=bias_attr, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)


class RMSNorm(Layer):
    """RMSNorm over the last axis: weight ones, fp32 whatever the rows'
    dtype, no bias; the registry op ``rms_norm``."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), attr=weight_attr,
            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)
