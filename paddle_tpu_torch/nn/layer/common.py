"""Common layers (counterpart: ``paddle_tpu/nn/layer/common.py`` ``Linear``,
``Dropout``, ``Embedding``)."""

from __future__ import annotations

from .. import functional as F
from ..initializer import Normal, XavierNormal
from .layers import Layer

__all__ = ["Linear", "Dropout", "Embedding"]


class Linear(Layer):
    """y = x W + b with W ``[in_features, out_features]`` (Paddle's layout)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=XavierNormal())
        self.bias = (self.create_parameter((out_features,), attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Dropout(Layer):
    """Masks drawn from the framework's current generator
    (``paddle_tpu_torch.random``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=Normal(0.0, 1.0))
        if padding_idx is not None:
            self.weight.data[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)
