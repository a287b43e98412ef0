"""``paddle.incubate`` (counterpart: ``paddle_tpu/incubate``), as far as the
port has it: the fused functional ops of ``incubate.nn.functional``."""

from . import nn  # noqa: F401

__all__ = ["nn"]
