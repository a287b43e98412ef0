"""The MoE layer on one device (counterpart: ``paddle_tpu/incubate/
distributed/models/moe/moe_layer.py``: ``ExpertFFN``, ``_index_scatter``,
``_index_combine``, ``_ep_info`` and ``MoELayer``).

The experts are one stacked bank (``w1 [E, D, F]``, ``w2 [E, F, D]``) run as
two batched GEMMs over the ``[E, C, D]`` dispatched buffer. Tokens reach the
buffer one of two ways, with the same numbers:

* index: each kept token is added into its slot row (``index_add``; the
  slots are unique, a dropped token lands on a dummy row that is cut off)
  and read back by ``index_select``. Their backwards are a gather and a
  scatter-add into the same unique slots.
* einsum: the dense ``[T, E, C]`` one-hots of the gate, two einsums of
  2 * T * E * C * D FLOPs each way.

The world is one rank: a ``moe_group`` or a hybrid mesh with an ep (or,
the reference's default, dp) axis of more than one rank, and the
expert-parallel forms (``forward_shard_map``, the internal exchange),
raise NotImplementedError naming ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

from typing import Optional

import torch

from .....enforce import enforce, enforce_in
from .....nn.functional.activation import gelu
from .....nn.initializer import Constant, XavierNormal
from .....nn.layer.layers import Layer
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate

__all__ = ["MoELayer", "ExpertFFN"]

_GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


def _promoted(*ts):
    """The tensors in their promoted dtype (``jnp.einsum`` promotes mixed
    operands; ``torch.bmm`` / ``einsum`` want one dtype)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


class ExpertFFN(Layer):
    """E experts stacked on the leading dim: ``[E, C, D] -> [E, C, D]``,
    two batched GEMMs with the activation between."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 activation=gelu):
        super().__init__()
        self.num_experts = num_experts
        self.activation = activation
        init = XavierNormal()
        self.w1 = self.create_parameter(
            [num_experts, d_model, d_hidden], default_initializer=init)
        self.b1 = self.create_parameter(
            [num_experts, d_hidden], default_initializer=Constant(0.0))
        self.w2 = self.create_parameter(
            [num_experts, d_hidden, d_model], default_initializer=init)
        self.b2 = self.create_parameter(
            [num_experts, d_model], default_initializer=Constant(0.0))

    def forward(self, dispatched):
        return self.apply(dispatched, self.w1, self.b1, self.w2, self.b2)

    def apply(self, dispatched, w1, b1, w2, b2):
        x, w1 = _promoted(dispatched, w1)
        h = torch.bmm(x, w1) + b1[:, None, :]
        h = self.activation(h)
        h, w2 = _promoted(h, w2)
        return torch.bmm(h, w2) + b2[:, None, :]


def _index_scatter(xt, slots, num_experts: int, capacity: int):
    """Scatter the tokens into the ``[E, C, D]`` expert batch by slot id
    (a dropped token, slot -1, goes to a dummy row that is cut off).
    Returns (dispatched, slot_safe [T, K])."""
    d_model = xt.shape[-1]
    flat = num_experts * capacity
    slot_safe = torch.where(slots >= 0, slots, torch.full_like(slots, flat))
    contrib = xt[:, None, :].expand(*slots.shape, d_model)
    dispatched = xt.new_zeros((flat + 1, d_model)).index_add(
        0, slot_safe.reshape(-1), contrib.reshape(-1, d_model))
    return (dispatched[:flat].reshape(num_experts, capacity, d_model),
            slot_safe)


def _index_combine(out_e, gates, slot_safe):
    """Gather each token's expert outputs back by slot id and mix them with
    the gate weights (zero for a dropped token), the weights cast to the
    outputs' dtype first."""
    flat = out_e.shape[0] * out_e.shape[1]
    d_model = out_e.shape[-1]
    out_flat = torch.cat([out_e.reshape(flat, d_model),
                          out_e.new_zeros((1, d_model))])
    picked = out_flat.index_select(0, slot_safe.reshape(-1)).reshape(
        *slot_safe.shape, d_model)
    return (gates.to(out_e.dtype)[..., None] * picked).sum(dim=1)


def _ep_info(moe_group=None, ep_axis: Optional[str] = None):
    """(mesh, axis name, world) of the expert group: world 1 only. A
    ``moe_group`` of more than one rank, or a hybrid mesh whose ``ep_axis``,
    ep or dp axis has more than one rank (the reference's default moe group
    is the data group), raises naming item 6."""
    if moe_group is not None:
        n = int(getattr(moe_group, "nranks", 1))
        if n > 1:
            raise _not_ported(f"expert parallelism over a moe_group of {n} "
                              f"ranks", 6)
        return None, getattr(moe_group, "axis_name", None) or "ep", 1
    from .....distributed.topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        shape = hcg.mesh.shape
        for cand in (ep_axis, "ep", "dp"):
            if cand and shape.get(cand, 1) > 1:
                raise _not_ported(f"expert parallelism over the mesh axis "
                                  f"{cand!r} of degree {shape[cand]}", 6)
    return None, ep_axis or "ep", 1


class MoELayer(Layer):
    """``MoELayer(d_model, d_hidden, num_experts, gate=...)``: ``x`` [B, S,
    D] or [T, D] -> the same shape. ``gate`` is "naive" (top ``top_k``),
    "gshard" (top-2), "switch" (top-1) or a ``BaseGate``.

    ``dispatch_mode``: "index" (slot ids), "einsum" (the dense one-hots) or
    "auto" (index when the gate implements ``_route`` or ``forward_index``;
    a legacy gate that overrides only ``forward`` takes einsum).
    ``forward(x, return_aux=True)`` returns ``(y, aux)``; in eager use the
    ``aux_loss`` attribute holds the last aux (with its autograd graph, to
    add into the loss)."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 gate="gshard", top_k: int = 2,
                 capacity_factor: float = 2.0, activation=gelu,
                 moe_group=None, ep_axis: Optional[str] = None,
                 dispatch_mode: str = "auto"):
        super().__init__()
        enforce_in(dispatch_mode, ("auto", "index", "einsum"),
                   op="MoELayer", name="dispatch_mode")
        self.dispatch_mode = dispatch_mode
        self.d_model = d_model
        self.num_experts = num_experts
        if isinstance(gate, str):
            cls = _GATES[gate]
            if cls is NaiveGate:
                self.gate = cls(d_model, num_experts, top_k=top_k,
                                capacity_factor=capacity_factor)
            else:  # GShard is top-2, Switch top-1 by construction
                self.gate = cls(d_model, num_experts,
                                capacity_factor=capacity_factor)
        else:
            self.gate = gate
        self.experts = ExpertFFN(num_experts, d_model, d_hidden, activation)
        self.mesh, self.ep_axis, self.ep_world = _ep_info(moe_group, ep_axis)
        self.aux_loss = torch.zeros((), dtype=torch.float32)

    @property
    def _gate_has_index(self) -> bool:
        """A gate that overrides only ``forward`` cannot give slot ids."""
        return (type(self.gate)._route is not BaseGate._route
                or type(self.gate).forward_index
                is not BaseGate.forward_index)

    def forward(self, x, return_aux: bool = False):
        orig_shape = x.shape
        xt = x.reshape(-1, self.d_model)
        gate_has_index = self._gate_has_index
        if self.dispatch_mode == "index":
            enforce(gate_has_index,
                    f"{type(self.gate).__name__} implements neither "
                    "_route() nor forward_index(); index dispatch needs "
                    "one of them (see BaseGate._route).", op="MoELayer")
        use_index = (self.dispatch_mode == "index"
                     or (self.dispatch_mode == "auto" and gate_has_index))
        if use_index:
            slots, gates, aux = self.gate.forward_index(xt)
            dispatched, slot_safe = _index_scatter(
                xt, slots, self.num_experts,
                self.gate.capacity(xt.shape[0]))
            y = _index_combine(self.experts(dispatched), gates, slot_safe)
        else:
            combine, dispatch, aux = self.gate(xt)
            d, x_ = _promoted(dispatch.to(xt.dtype), xt)
            out_e = self.experts(torch.einsum("tec,td->ecd", d, x_))
            c, out_e = _promoted(combine.to(xt.dtype), out_e)
            y = torch.einsum("tec,ecd->td", c, out_e)
        self.aux_loss = aux
        y = y.reshape(orig_shape)
        return (y, aux) if return_aux else y

    def forward_shard_map(self, x, w1, b1, w2, b2, return_aux: bool = False):
        """The per-rank body of the ep exchange (global_scatter /
        global_gather)."""
        raise _not_ported("MoELayer.forward_shard_map (the expert-parallel "
                          "all-to-all exchange)", 6)

    def _forward_index_ep(self, xt):
        raise _not_ported("MoELayer's internal expert-parallel routing", 6)
