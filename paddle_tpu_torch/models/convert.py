"""Weight and optimizer-state carry-over from the JAX package (counterparts:
the pytree that ``paddle_tpu/models/gpt.py`` ``init_hybrid_params`` returns,
and the state that ``paddle_tpu/optimizer/optimizer.py``
``Optimizer.init_state`` / ``apply`` return).

``params_from_jax`` takes the parameter tree as numpy arrays (what
``jax.device_get`` hands back) and returns the port's dict of tensors with
identical keys and shapes; ``opt_state_from_jax`` does the same for
``{"step", "slots"}``. Neither imports JAX: the caller fetches the trees.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["params_from_jax", "opt_state_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(a, device, dtype: Optional[torch.dtype] = None):
    """One numpy array (including ml_dtypes' bfloat16, which torch cannot
    wrap directly) -> a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Dict[str, Any], device,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (floating leaves cast to ``dtype`` when given)."""
    device = torch.device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    return tensor_from_numpy(tree, device, dtype)


def opt_state_from_jax(state: Dict[str, Any], device) -> Dict[str, Any]:
    """``{"step": int scalar, "slots": {...}}`` as numpy (slot dicts of
    ``moment1``, ``moment2`` and an optional fp32 ``master`` at the
    parameter tree's leaves) -> the port's optimizer state: the step as a
    Python int, every slot tensor on ``device`` in its own dtype."""
    return {"step": int(np.asarray(state["step"])),
            "slots": params_from_jax(state["slots"], device)}
