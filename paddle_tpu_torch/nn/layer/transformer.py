"""Transformer encoder layers (counterpart:
``paddle_tpu/nn/layer/transformer.py`` ``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``; the caches and the
decoder are not ported yet, ROADMAP Queue 1 item 10).

Attention runs through the registry op ``scaled_dot_product_attention``
(``[B, S, H, D]`` heads): the flash kernels on the card, forward and
backward, at any head dim up to 256 (above it the composed path, as the JAX
gate rules), with the attention mask as their bias, the packed rows'
``segment_ids`` and the attention dropout inside them, in any combination;
the composed path on the CPU.
"""

from __future__ import annotations

import copy

import torch

from ...enforce import enforce
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


def _convert_attn_mask(attn_mask):
    if attn_mask is None:
        return None
    m = torch.as_tensor(attn_mask)
    return m if m.dtype == torch.bool else m.float()


class MultiHeadAttention(Layer):
    """Separate q / k / v / out projections (``[in, out]`` weights), heads
    ``[B, S, H, D]``. ``attn_mask``: a bool keep-mask, or an additive float
    mask, which is made fp32 as the JAX package's ``_convert_attn_mask``
    makes it, broadcasting to ``[B, H, S, S]``; a constant. On the card it
    trains through the flash kernels with the mask as their bias, alone or
    with dropout and segment ids. The attention dropout seeds come from the
    framework's current generator (``paddle_tpu_torch.random``)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        enforce(self.head_dim * num_heads == embed_dim,
                f"embed_dim {embed_dim} not divisible by num_heads "
                f"{num_heads}", op="MultiHeadAttention")
        self.dropout = dropout
        self.need_weights = need_weights
        kdim, vdim = kdim or embed_dim, vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, segment_ids=None):
        if cache is not None:
            raise NotImplementedError(
                "MultiHeadAttention: caches are not ported yet (ROADMAP "
                "Queue 1 item 10)")
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attn_mask(attn_mask),
            dropout_p=self.dropout, is_causal=False, training=self.training,
            segment_ids=segment_ids)
        B, S = out.shape[0], out.shape[1]
        return self.out_proj(out.reshape(B, S, self.embed_dim))


class TransformerEncoderLayer(Layer):
    """Post-LN (``normalize_before=False``) or pre-LN encoder layer. norm1
    and norm2 take LayerNorm's default epsilon 1e-5, as in the JAX
    package."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None, segment_ids=None):
        if cache is not None:
            raise NotImplementedError(
                "TransformerEncoderLayer: caches are not ported yet (ROADMAP "
                "Queue 1 item 10)")
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask,
                             segment_ids=segment_ids)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (deep copies, so they
    start from the same weights, as the JAX package's ``_clone_layer``
    does), then an optional final norm."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None, segment_ids=None):
        if cache is not None:
            raise NotImplementedError(
                "TransformerEncoder: caches are not ported yet (ROADMAP "
                "Queue 1 item 10)")
        output = src
        for mod in self.layers:
            output = mod(output, src_mask, segment_ids=segment_ids)
        if self.norm is not None:
            output = self.norm(output)
        return output
