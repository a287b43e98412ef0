"""The layer base (counterpart: ``paddle_tpu/nn/layer/layers.py`` ``Layer``,
``functional_call``, ``functional_train_graph``).

``Layer`` is a ``torch.nn.Module``: parameters are ``torch.nn.Parameter``
attributes, sublayers are modules, ``train()`` / ``eval()`` set the
``training`` flag down the tree, and ``named_parameters`` gives the JAX
package's names (``bert.encoder.layers.0.self_attn.q_proj.weight``), since
the attribute names are the same. A parameter is drawn on the host from the
framework's generator (so a layer built for the card and one built for the
CPU hold the same values) and placed on the card, or on the device of the
enclosing ``paddle_tpu_torch.device_guard``: an eager call runs where the
parameters are.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ... import resolve_device
from ..initializer import Constant, XavierNormal

__all__ = ["Layer", "functional_call", "functional_train_graph"]


class Layer(torch.nn.Module):
    """Base layer. ``create_parameter`` makes a parameter as the JAX package
    does (default ``XavierNormal``, ``Constant(0)`` for a bias, an ``attr``
    with ``initializer`` / ``trainable`` overriding); a parameter that is not
    trainable has ``requires_grad`` False and lands in the frozen dict. It
    lives on ``resolve_device(None)``: the card, or the guard's device."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self._dtype = dtype

    def create_parameter(self, shape, dtype=None, default_initializer=None,
                         is_bias=False, attr=None) -> torch.nn.Parameter:
        init = default_initializer
        if attr is not None and getattr(attr, "initializer", None) is not None:
            init = attr.initializer
        if init is None:
            init = Constant(0.0) if is_bias else XavierNormal()
        trainable = True
        if attr is not None and getattr(attr, "trainable", None) is not None:
            trainable = bool(attr.trainable)
        value = init(tuple(shape), dtype or self._dtype).to(resolve_device())
        return torch.nn.Parameter(value, requires_grad=trainable)

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self.add_module(name, sublayer)
        return sublayer


def functional_train_graph(layer: Layer, device=None):
    """(trainable, frozen, buffers): dicts of the layer's parameters and
    buffers by their dotted names, detached copies on ``device`` (None: the
    CUDA card, raising without one; ``"cpu"`` on request)."""
    device = resolve_device(device)
    trainable, frozen = {}, {}
    for name, p in layer.named_parameters():
        (trainable if p.requires_grad else frozen)[name] = \
            p.detach().to(device, copy=True)
    buffers = {name: b.detach().to(device, copy=True)
               for name, b in layer.named_buffers()}
    return trainable, frozen, buffers


def functional_call(layer: Layer, params: Dict[str, Any],
                    buffers: Dict[str, Any], *args, **kwargs):
    """``layer(*args, **kwargs)`` as a function of (params, buffers), by
    ``torch.func.functional_call``: returns ``(output, buffers)`` (the
    ported layers mutate no buffer)."""
    state = {**params, **buffers}
    out = torch.func.functional_call(layer, state, args, kwargs)
    return out, dict(buffers)
