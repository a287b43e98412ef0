"""MoE gates (counterpart: ``paddle_tpu/incubate/distributed/models/moe/
gate.py``: ``compute_capacity``, the slot assignment and its two
encodings, ``BaseGate``, ``NaiveGate``, ``SwitchGate``, ``GShardGate``,
``TopKGate``).

Each gate maps token activations ``[T, D]`` to a capacity-bounded routing
plan, in one of two encodings of the same slots:

  dense (``forward``):       combine [T, E, C] fp32, the weight each token
                             gives each (expert, slot), zero where dropped;
                             dispatch = combine > 0; aux
  index (``forward_index``): slots [T, K] (e * C + pos, -1 where dropped),
                             gates [T, K] fp32 zeroed where dropped; aux

A slot is a token's place in its expert's queue in token order (a cumsum);
the second choice of a top-2 gate queues behind every first choice. The
routing runs in fp32. Slot ids are int64 (PyTorch's index dtype; the JAX
package's are int32, the same values).

The one-hot of a capacity position builds from a comparison, not
``F.one_hot``: a dropped token's position is >= C, where ``jax.nn.one_hot``
gives a zero row and ``F.one_hot`` raises. ``argmax`` takes the first
maximum in both packages; ``torch.topk`` and ``lax.top_k`` need not order
tied values alike.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..... import random as _random
from .....nn.initializer import XavierUniform
from .....nn.layer.layers import Layer

__all__ = ["BaseGate", "NaiveGate", "SwitchGate", "GShardGate", "TopKGate",
           "compute_capacity"]


def compute_capacity(num_tokens: int, num_experts: int, top_k: int,
                     capacity_factor: float) -> int:
    """Slots per expert: ceil(T * k / E * factor), at least k."""
    cap = int(math.ceil(num_tokens * top_k / num_experts * capacity_factor))
    return max(cap, top_k)


def _one_hot(idx, num):
    """fp32 one-hot of ``idx`` over ``num`` classes; an index outside
    ``[0, num)`` gives a zero row (``jax.nn.one_hot``'s rule)."""
    return (idx[..., None] == torch.arange(num, device=idx.device)).float()


def _positions_in_expert(mask):
    """mask [T, E] 0/1 -> the slot each token takes in its expert's queue
    (token order). The scan runs along the contiguous token dim of the
    [E, T] transpose: over the leading dim of the narrow [T, E] it took
    2.55 ms a call on an H100 at T 16384 (PERF.md §6). The sums are
    whole numbers below 2^24, the same in any order."""
    return (torch.cumsum(mask.t().contiguous(), dim=1).t() - 1.0) * mask


def _slot_assign(expert_idx, capacity, num_experts, prev_counts=None):
    """The capacity-slot assignment of one routing choice (both encodings
    derive from it). expert_idx [T]; prev_counts [E], the slots earlier
    choices took. Returns (mask [T, E], pos_idx [T] int64, keep_tok [T]
    bool, counts [E])."""
    mask = _one_hot(expert_idx, num_experts)
    pos = _positions_in_expert(mask)
    if prev_counts is not None:
        pos = pos + prev_counts[None, :] * mask
    keep = (pos < capacity) & (mask > 0)
    pos_idx = pos.sum(dim=1).long()
    keep_tok = keep.any(dim=1)
    counts = mask.sum(dim=0)
    return mask, pos_idx, keep_tok, counts


def _capacity_dispatch(expert_idx, gate_w, capacity, num_experts,
                       prev_counts=None):
    """The dense [T, E, C] encoding of ``_slot_assign``: (combine,
    keep_tok, counts)."""
    mask, pos_idx, keep_tok, counts = _slot_assign(
        expert_idx, capacity, num_experts, prev_counts)
    combine = (gate_w * keep_tok)[:, None, None] * (
        mask[:, :, None] * _one_hot(pos_idx, capacity)[:, None, :])
    return combine, keep_tok, counts


def _capacity_dispatch_idx(expert_idx, gate_w, capacity, num_experts,
                           prev_counts=None):
    """The index encoding of ``_slot_assign``: (slot [T] = e * C + pos or
    -1 when dropped, gate [T] fp32 zeroed when dropped, counts [E])."""
    mask, pos_idx, keep_tok, counts = _slot_assign(
        expert_idx, capacity, num_experts, prev_counts)
    slot = torch.where(keep_tok, expert_idx.long() * capacity + pos_idx,
                       torch.full_like(pos_idx, -1))
    return slot, gate_w * keep_tok, counts


class BaseGate(Layer):
    """The learned routing projection ``weight`` [D, E] (Xavier uniform)
    and the expert counts. A subclass implements ``_route`` once; both
    encodings derive from it."""

    def __init__(self, d_model: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25, name: Optional[str] = None):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.weight = self.create_parameter(
            [d_model, num_experts], default_initializer=XavierUniform())

    def logits(self, x):
        return x.float() @ self.weight.float()

    def capacity(self, num_tokens: int) -> int:
        return compute_capacity(num_tokens, self.num_experts, self.top_k,
                                self.capacity_factor)

    def _route(self, x):
        """(choices, aux): choices = [(expert_idx [T], gate_w [T]), ...] in
        priority order (a later choice queues behind the earlier ones)."""
        raise NotImplementedError

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        choices, aux = self._route(x)
        cap = self.capacity(x.shape[0])
        combine = counts = None
        for ei, wi in choices:
            c, _, n = _capacity_dispatch(ei, wi, cap, self.num_experts,
                                         counts)
            combine = c if combine is None else combine + c
            counts = n if counts is None else counts + n
        return combine, combine > 0, aux

    def forward_index(self, x):
        """(slots [T, K] int64, -1 = dropped; gates [T, K] fp32; aux)."""
        choices, aux = self._route(x)
        cap = self.capacity(x.shape[0])
        slots, gates = [], []
        counts = None
        for ei, wi in choices:
            s, g, n = _capacity_dispatch_idx(ei, wi, cap, self.num_experts,
                                             counts)
            slots.append(s)
            gates.append(g)
            counts = n if counts is None else counts + n
        return torch.stack(slots, dim=1), torch.stack(gates, dim=1), aux


class NaiveGate(BaseGate):
    """Plain top-k, the top-k weights renormalized, no aux loss."""

    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=2.0):
        super().__init__(d_model, num_experts, top_k, capacity_factor)

    def _route(self, x):
        probs = torch.softmax(self.logits(x), dim=-1)
        topw, topi = torch.topk(probs, self.top_k, dim=-1)
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
        choices = [(topi[:, k], topw[:, k]) for k in range(self.top_k)]
        return choices, torch.zeros((), dtype=torch.float32, device=x.device)


class SwitchGate(BaseGate):
    """Top-1 with the Switch Transformer load-balance loss
    E * sum_e f_e * P_e. ``jitter_eps > 0`` multiplies the logits by
    U(1 - eps, 1 + eps) noise drawn from the framework's generator
    (``random.device_generator`` over ``get_generator``): one seed
    reproduces it; its bits are not ``jax.random``'s."""

    def __init__(self, d_model, num_experts, capacity_factor=1.25,
                 jitter_eps: float = 0.0):
        super().__init__(d_model, num_experts, top_k=1,
                         capacity_factor=capacity_factor)
        self.jitter_eps = jitter_eps

    def _jitter(self, shape, device):
        """The multiplicative noise, U(1 - eps, 1 + eps) in fp32."""
        gen = _random.device_generator(device)
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        eps = self.jitter_eps
        return (1.0 - eps) + (2.0 * eps) * u

    def _route(self, x):
        logits = self.logits(x)
        if self.jitter_eps > 0.0:
            logits = logits * self._jitter(logits.shape, logits.device)
        probs = torch.softmax(logits, dim=-1)
        gate_w = probs.amax(dim=-1)
        expert = probs.argmax(dim=-1)
        me = probs.mean(dim=0)
        ce = _one_hot(expert, self.num_experts).mean(dim=0)
        aux = torch.sum(me * ce) * self.num_experts
        return [(expert, gate_w)], aux


class GShardGate(BaseGate):
    """Top-2: the aux loss on the first choice, the second expert queued
    behind every first choice's slots."""

    def __init__(self, d_model, num_experts, capacity_factor=2.0):
        super().__init__(d_model, num_experts, top_k=2,
                         capacity_factor=capacity_factor)

    def _route(self, x):
        probs = torch.softmax(self.logits(x), dim=-1)
        e1 = probs.argmax(dim=-1)
        w1 = probs.amax(dim=-1)
        masked = probs - _one_hot(e1, self.num_experts) * probs
        e2 = masked.argmax(dim=-1)
        w2 = masked.amax(dim=-1)
        denom = torch.clamp(w1 + w2, min=1e-9)
        me = probs.mean(dim=0)
        ce = _one_hot(e1, self.num_experts).mean(dim=0)
        aux = torch.sum(me * ce) * self.num_experts
        return [(e1, w1 / denom), (e2, w2 / denom)], aux


class TopKGate(NaiveGate):
    """The general top-k name (the reference's NaiveGate(topk=k))."""
