"""``paddle.save`` / ``paddle.load`` (counterpart:
``paddle_tpu/framework``)."""

from .io import load, save

__all__ = ["save", "load"]
