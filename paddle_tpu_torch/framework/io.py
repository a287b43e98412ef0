"""Single-process save / load (counterpart: ``paddle_tpu/framework/io.py``
``save`` and ``load``; the reference's ``paddle.save`` / ``paddle.load``).

The format is the JAX package's: one pickle file in which every tensor is
stored as a numpy array (bf16 as ml_dtypes' ``bfloat16``, as ``np.asarray``
of a JAX bf16 array gives it), and nested dicts, lists, tuples and scalars
pass through. A file written by either package loads in the other to the
same arrays. ``load`` returns numpy arrays, as the JAX package's does.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load"]


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError as e:
            raise TypeError("saving a bfloat16 tensor needs ml_dtypes (the "
                            "numpy dtype the file format stores bf16 "
                            "as)") from e
        return t.contiguous().view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)
    return t.numpy()


def _to_host(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return _numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs) -> None:
    del configs
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_host(obj), f, protocol=protocol)


def load(path: str, **configs) -> Any:
    del configs
    with open(path, "rb") as f:
        return pickle.load(f)
