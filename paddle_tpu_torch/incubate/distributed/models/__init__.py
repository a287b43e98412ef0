"""Counterpart: ``paddle_tpu/incubate/distributed/models``."""

from . import moe  # noqa: F401

__all__ = ["moe"]
