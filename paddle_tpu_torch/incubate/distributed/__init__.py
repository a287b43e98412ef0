"""``paddle.incubate.distributed`` (counterpart:
``paddle_tpu/incubate/distributed``): the MoE layers of ``models.moe``."""

from . import models  # noqa: F401

__all__ = ["models"]
