"""``paddle.incubate`` (counterpart: ``paddle_tpu/incubate``), as far as the
port has it: the fused functional ops of ``incubate.nn.functional`` and the
MoE layers of ``incubate.distributed.models.moe``."""

from . import distributed, nn  # noqa: F401

__all__ = ["nn", "distributed"]
