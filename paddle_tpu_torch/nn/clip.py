"""Gradient clipping (counterpart: ``paddle_tpu/nn/clip.py``:
``sum_squares``, ``global_norm``, ``ClipGradByValue``, ``ClipGradByNorm``,
``ClipGradByGlobalNorm``, ``clip_grad_norm_``).

A clip is a callable over a gradient tree (nested dicts of tensors, None
for a frozen leaf) that returns a new tree, as the optimizer's
``apply`` calls it. The sums of squares run in fp32. ``clip_grad_norm_``
acts on the ``.grad`` of a sequence of tensors, in place. The sparse
``SelectedRows`` gradients of the JAX package are not ported.
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "global_norm", "sum_squares"]


def _tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict (None leaves stay None)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _leaves(tree):
    """The non-None leaves of a nested dict / list, keys sorted (the JAX
    pytree's leaf order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def sum_squares(grads) -> torch.Tensor:
    """fp32 sum of squares over a gradient tree (``global_norm``'s square),
    leaf by leaf in the tree's order."""
    vals = _leaves(grads)
    if not vals:
        return torch.zeros((), dtype=torch.float32)
    total = None
    for g in vals:
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return total


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum_squares(grads))


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads):
        return _tree_map(lambda g: torch.clamp(g, self.min, self.max), grads)


class ClipGradByNorm:
    """Per-tensor norm clip."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        def clip_one(g):
            n = torch.linalg.vector_norm(g.float())
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            return (g * scale).to(g.dtype)
        return _tree_map(clip_one, grads)


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def scale_from_norm(self, norm):
        """The clip coefficient for a precomputed global norm (the one
        definition; the hybrid engine's sharded clip uses it too)."""
        return torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                           max=1.0)

    def __call__(self, grads):
        scale = self.scale_from_norm(global_norm(grads))
        return _tree_map(lambda g: (g * scale).to(g.dtype), grads)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place so their global 2-norm
    is at most ``max_norm``; returns the norm before the clip."""
    if norm_type != 2.0:
        raise NotImplementedError("clip_grad_norm_: only the 2-norm, as "
                                  "the JAX package")
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    total = global_norm([p.grad for p in params])
    if error_if_nonfinite and not torch.isfinite(total):
        raise RuntimeError(f"clip_grad_norm_: the total norm is {total}")
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for p in params:
        p.grad.mul_(scale.to(p.grad.dtype))
    return total
