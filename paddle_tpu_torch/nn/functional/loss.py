"""Loss functions (counterpart: ``paddle_tpu/nn/functional/loss.py``
``cross_entropy``): hard integer labels only, the surface the BERT
pretraining loss needs."""

from __future__ import annotations

import torch

from ...enforce import enforce

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy over the last axis with hard labels: the fp32
    log-sum-exp minus the picked logit, read from ``input`` in its own
    dtype. Positions labelled ``ignore_index`` weigh 0; "mean" divides by
    the kept count (at least 1e-12). The loss value is clamped at 0 with
    the gradient passed through, as the JAX package does."""
    del name
    if (weight is not None or soft_label or not use_softmax or label_smoothing
            or axis not in (-1, input.dim() - 1)):
        raise NotImplementedError(
            "cross_entropy: only hard labels over the last axis are ported "
            "(ROADMAP Queue 1 item 10, the nn surface)")
    enforce(reduction in ("mean", "sum", "none"),
            f"reduction must be mean, sum or none, got {reduction!r}",
            op="cross_entropy")
    label = torch.as_tensor(label, device=input.device)
    if label.dim() == input.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    enforce(tuple(label.shape) == tuple(input.shape[:-1]),
            f"hard labels must have the logits shape minus the class axis: "
            f"logits {tuple(input.shape)}, labels {tuple(label.shape)}",
            op="cross_entropy")
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    lse = torch.logsumexp(input.float(), dim=-1)
    picked = input.gather(-1, safe[..., None])[..., 0].float()
    loss = lse - picked
    loss = loss + (loss.clamp_min(0.0) - loss).detach()
    w = valid.float()
    loss = loss * w
    if reduction == "mean":
        return loss.sum() / w.sum().clamp_min(1e-12)
    if reduction == "sum":
        return loss.sum()
    return loss
