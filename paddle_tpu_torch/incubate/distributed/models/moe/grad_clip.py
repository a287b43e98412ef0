"""MoE-aware global-norm clipping (counterpart: ``paddle_tpu/incubate/
distributed/models/moe/grad_clip.py``: ``clip_by_global_norm_with_moe``,
``ClipGradForMOEByGlobalNorm``).

On one rank every expert's gradient is here, so the plain global norm is
the MoE norm: with ``ep_axis=None`` the clip is exact. Summing the expert
leaves' squares over an ep group (``ep_axis``) raises NotImplementedError
naming ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .....nn.clip import _leaves, _tree_map

__all__ = ["ClipGradForMOEByGlobalNorm", "clip_by_global_norm_with_moe"]


def _sq_norm(tree):
    """fp32 sum of squares over the tree's leaves, in the JAX pytree's
    leaf order."""
    total = None
    for g in _leaves(tree):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.zeros((), dtype=torch.float32) if total is None else total


def clip_by_global_norm_with_moe(grads, clip_norm: float,
                                 is_expert_param: Optional[Callable] = None,
                                 ep_axis: Optional[str] = None):
    """``(clipped, global_norm)``: every leaf scaled by
    ``min(1, clip_norm / max(norm, 1e-6))`` in fp32, then cast back."""
    if ep_axis is not None:
        raise NotImplementedError(
            f"the MoE clip's norm summed over the ep axis {ep_axis!r} is not "
            f"ported yet (ROADMAP Queue 1 item 6)")
    gnorm = torch.sqrt(_sq_norm(grads))
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-6), max=1.0)
    clipped = _tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)
    return clipped, gnorm


class ClipGradForMOEByGlobalNorm:
    """The grad-clip object for an optimizer's ``grad_clip=``."""

    def __init__(self, clip_norm: float,
                 is_expert_param: Optional[Callable] = None,
                 ep_axis: Optional[str] = None):
        if ep_axis is not None:
            raise NotImplementedError(
                f"the MoE clip over the ep axis {ep_axis!r} is not ported "
                f"yet (ROADMAP Queue 1 item 6)")
        self.clip_norm = float(clip_norm)
        self.is_expert_param = is_expert_param
        self.ep_axis = ep_axis

    def __call__(self, grads):
        clipped, _ = clip_by_global_norm_with_moe(
            grads, self.clip_norm, self.is_expert_param, self.ep_axis)
        return clipped
