"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package (``paddle_tpu``) stays the reference; this package keeps its
module layout and names so each module's counterpart is easy to find. It
imports ``torch`` and never ``jax`` or ``paddle_tpu``.

Entry points run on the CUDA card unless the caller asks for the CPU:
:func:`resolve_device` turns ``device=None`` into ``cuda`` and raises when no
card is present, so a run never carries on silently on the CPU. A caller
asks with a ``device=`` argument, or for a whole scope with
:func:`device_guard` (the layers' parameters have no argument of their own).
"""

from __future__ import annotations

import contextlib
from typing import List

import torch

__all__ = ["resolve_device", "device_guard"]

_guards: List[torch.device] = []


@contextlib.contextmanager
def device_guard(device):
    """Inside the scope, ``device=None`` resolves to ``device``."""
    _guards.append(resolve_device(device))
    try:
        yield _guards[-1]
    finally:
        _guards.pop()


def resolve_device(device=None) -> torch.device:
    """``None`` -> the innermost ``device_guard``'s device, else ``cuda``
    (raises without a card); anything else is taken as the caller's explicit
    choice (``"cpu"`` runs the plain versions of the kernels)."""
    if device is None and _guards:
        return _guards[-1]
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
