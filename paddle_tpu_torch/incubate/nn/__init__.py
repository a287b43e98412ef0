"""``paddle.incubate.nn`` (counterpart: ``paddle_tpu/incubate/nn``), as far as
the port has it. ``FusedMultiTransformer`` is not ported yet (ROADMAP Queue
1 item 10)."""

from . import functional  # noqa: F401

__all__ = ["functional"]
