"""Weight and optimizer-state carry-over from the JAX package (counterparts:
the pytrees that ``paddle_tpu/models/gpt.py`` and ``llama.py``
``init_hybrid_params`` return, the eager layers' ``functional_train_graph``
trees, and the state that ``paddle_tpu/optimizer/optimizer.py``
``Optimizer.init_state`` / ``apply`` return).

``params_from_jax`` takes the parameter tree as numpy arrays (what
``jax.device_get`` hands back) and returns the port's dict of tensors with
identical keys and shapes (GPT-MoE's nested ``{"dense", "moe"}`` pair blocks
included); ``opt_state_from_jax`` does the same for ``{"step", "slots"}``;
``load_params`` puts a layer model's flat ``functional_train_graph`` tree
into the port's ``nn.Layer`` by name (a ``MoELayer``'s ``gate.weight``,
``experts.w1``, ``experts.b1``, ``experts.w2``, ``experts.b2``). None
imports JAX: the caller fetches the trees.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["params_from_jax", "opt_state_from_jax", "tensor_from_numpy",
           "load_params"]


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
    """Nested dicts and lists of numpy arrays (the stacked tree, or the
    segmented ``{"embed", "blocks": [...], "head"}`` one) -> the same
    nesting of tensors on ``device`` (floating leaves cast to ``dtype``
    when given)."""
    device = torch.device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    return tensor_from_numpy(tree, device, dtype)


def opt_state_from_jax(state: Dict[str, Any], device) -> Dict[str, Any]:
    """``{"step": int scalar, "slots": {...}}`` as numpy (slot dicts of
    ``moment1``, ``moment2`` and an optional fp32 ``master`` at the
    parameter tree's leaves) -> the port's optimizer state: the step as a
    Python int, every slot tensor on ``device`` in its own dtype."""
    return {"step": int(np.asarray(state["step"])),
            "slots": params_from_jax(state["slots"], device)}


def load_params(module: torch.nn.Module, flat: Dict[str, Any]) -> None:
    """Copy a flat ``{dotted name: numpy array}`` tree (the JAX package's
    ``functional_train_graph`` trainable and frozen dicts, merged) into
    ``module``'s parameters of the same names, each cast to the parameter's
    dtype on its device. Raises ValueError naming every missing or extra
    name, or the first shape that differs; nothing is copied then."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(f"load_params: missing {missing}, extra {extra}")
    for name, p in params.items():
        shape = tuple(np.shape(flat[name]))
        if shape != tuple(p.shape):
            raise ValueError(f"load_params: {name} is {shape} in the tree, "
                             f"{tuple(p.shape)} in the module")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(tensor_from_numpy(flat[name], p.device, p.dtype))
