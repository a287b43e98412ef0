"""The MoE dispatch configuration and the expert exchange at ep degree 1
(counterpart: ``paddle_tpu/distributed/comm_overlap/a2a.py``:
``MoeDispatchConfig``, ``moe_dispatch_from_flags``,
``resolve_moe_dispatch``, ``expert_exchange``).

At ep degree 1 the exchange is the local expert FFN bank with the caller's
activation: there is nothing to send. The wire formats of the ep exchange,
``quantize`` (int8 with error feedback) and ``overlap`` (capacity chunks
interleaved with the GEMMs), and any ep or mp degree above 1 raise
NotImplementedError naming ROADMAP Queue 1 item 6, as do the quantized
all-to-alls themselves (``qa2a_scatter`` / ``qa2a_gather`` /
``moe_ef_local_shapes``, not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...enforce import enforce

__all__ = ["MoeDispatchConfig", "moe_dispatch_from_flags",
           "resolve_moe_dispatch", "expert_exchange"]


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item 6)")


@dataclasses.dataclass(frozen=True)
class MoeDispatchConfig:
    """index: slot-id gather / scatter dispatch instead of the dense
    [T, E, C] one-hot einsums. quantize, overlap, chunks: the ep exchange's
    wire formats (item 6)."""
    index: bool = False
    quantize: bool = False
    overlap: bool = False
    chunks: int = 2

    def __post_init__(self):
        enforce(self.chunks >= 1, "moe overlap chunks must be >= 1",
                op="MoeDispatchConfig", chunks=self.chunks)

    @property
    def any_on(self) -> bool:
        return self.index or self.quantize or self.overlap


def moe_dispatch_from_flags() -> Optional[MoeDispatchConfig]:
    """None (dense dispatch, plain exchange) unless a moe_* flag asks for
    more."""
    from ...flags import flag
    idx = bool(flag("moe_index_dispatch"))
    quant = bool(flag("moe_quantize_a2a"))
    ovl = bool(flag("moe_overlap"))
    if not (idx or quant or ovl):
        return None
    return MoeDispatchConfig(index=idx, quantize=quant, overlap=ovl,
                             chunks=max(int(flag("moe_overlap_chunks")), 1))


def resolve_moe_dispatch(arg) -> Optional[MoeDispatchConfig]:
    """A model builder's ``moe_dispatch=``: "auto" reads the flags, None /
    False is the dense baseline, True is index dispatch, a
    MoeDispatchConfig forces."""
    if arg == "auto":
        return moe_dispatch_from_flags()
    if arg is None or arg is False:
        return None
    if arg is True:
        return MoeDispatchConfig(index=True)
    return arg


def check_ep1(cfg: Optional[MoeDispatchConfig]):
    """Raise naming item 6 for the ep exchange's wire formats,
    ``quantize`` and ``overlap``."""
    if cfg is not None and cfg.quantize:
        raise _not_ported("the int8 error-feedback expert all-to-all "
                          "(moe quantize)")
    if cfg is not None and cfg.overlap:
        raise _not_ported("the chunked expert all-to-all overlap "
                          "(moe overlap)")


def expert_exchange(dispatched, w1, b1, w2, b2, *, ep_axis: str,
                    mp_axis: Optional[str] = None, activation,
                    cfg: Optional[MoeDispatchConfig] = None,
                    residuals=None):
    """The routed ``[E, C, D]`` buffer through the expert FFN bank at ep
    degree 1 (w1 [E, D, F], b1 [E, F], w2 [E, F, D], b2 [E, D]); returns
    ``(returned [E, C, D], None)``. The caller's mesh has ep and mp degree 1
    (the model builder refuses more); ``residuals`` (the quantized wire's
    error feedback) must be None."""
    check_ep1(cfg)
    if residuals is not None:
        raise _not_ported("the expert all-to-all's error-feedback residuals")
    h = torch.bmm(dispatched, w1) + b1[:, None, :]
    h = activation(h)
    return torch.bmm(h, w2) + b2[:, None, :], None
