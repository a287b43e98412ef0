"""The framework's random stream (counterpart: ``paddle_tpu/random.py``
``default_generator``, ``seed``, ``rng_guard``, ``next_key``).

JAX threads keys; the port threads ``torch.Generator`` objects. Everything
random in the port's layers (initializers, dropout masks, the attention
dropout seed) draws from the CPU generator that ``get_generator`` returns:
the one ``rng_guard`` installed, else ``default_generator``. Drawing on the
host never waits for the card. A mask drawn on the card comes from a
per-device CUDA generator that is re-seeded from the host stream for each
draw (``device_generator``), so one CPU seed fixes the whole run. The bits
are torch's, not ``jax.random``'s: tests hand both packages the same numpy
inputs and compare masks by their statistics.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

__all__ = ["default_generator", "rng_guard", "get_generator", "next_seed",
           "device_generator"]

default_generator = torch.Generator()
default_generator.manual_seed(0)
_stack: List[torch.Generator] = []
_device_gens: Dict[torch.device, torch.Generator] = {}


@contextlib.contextmanager
def rng_guard(generator: torch.Generator):
    """Draw from ``generator`` (a CPU ``torch.Generator``) inside the
    scope."""
    if generator.device.type != "cpu":
        raise ValueError("rng_guard takes a CPU generator: draws on the host "
                         "never wait for the card")
    _stack.append(generator)
    try:
        yield generator
    finally:
        _stack.pop()


def get_generator(generator: Optional[torch.Generator] = None
                  ) -> torch.Generator:
    """``generator`` if given, else the innermost ``rng_guard``'s, else the
    global one."""
    if generator is not None:
        return generator
    return _stack[-1] if _stack else default_generator


def next_seed(generator: Optional[torch.Generator] = None) -> int:
    """A 63-bit seed as a Python int, drawn on the host."""
    return int(torch.randint(0, 2 ** 63 - 1, (), dtype=torch.int64,
                             generator=get_generator(generator)))


def device_generator(device, generator: Optional[torch.Generator] = None
                     ) -> torch.Generator:
    """A generator for ``device`` seeded from the host stream: the CPU
    stream itself on the CPU, a per-device CUDA generator re-seeded with
    ``next_seed`` on a card (seeding is host-side, no sync)."""
    device = torch.device(device)
    if device.type == "cpu":
        return get_generator(generator)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    gen = _device_gens.get(device)
    if gen is None:
        gen = _device_gens[device] = torch.Generator(device=device)
    gen.manual_seed(next_seed(generator))
    return gen
