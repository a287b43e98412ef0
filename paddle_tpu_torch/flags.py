"""Runtime flags the port reads (counterpart: ``paddle_tpu/flags.py``
``define_flag`` / ``flag`` / ``set_flags``).

Only the flags this package consumes are defined, with the JAX package's
defaults. ``FLAGS_<name>`` environment variables override a default when
the flag is defined, as in the reference.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

__all__ = ["define_flag", "flag", "set_flags"]

_REGISTRY: Dict[str, "_Flag"] = {}
_LOCK = threading.RLock()


def _canon(name: str) -> str:
    return name if name.startswith("FLAGS_") else f"FLAGS_{name}"


class _Flag:
    __slots__ = ("name", "type", "default", "value", "help")

    def __init__(self, name: str, type_: type, default: Any, help_: str):
        self.name = name
        self.type = type_
        self.default = default
        self.help = help_
        env = os.environ.get(name)
        self.value = self._coerce(env) if env is not None else default

    def _coerce(self, raw: Any) -> Any:
        if raw is None or isinstance(raw, self.type):
            return raw
        if self.type is bool:
            if isinstance(raw, str):
                return raw.strip().lower() in ("1", "true", "yes", "on")
            return bool(raw)
        return self.type(raw)


def define_flag(name: str, default: Any, help_: str = "",
                type_: Optional[type] = None) -> None:
    """Register a flag; env var FLAGS_<name> overrides the default."""
    with _LOCK:
        name = _canon(name)
        if name not in _REGISTRY:
            _REGISTRY[name] = _Flag(name, type_ or type(default), default,
                                    help_)


def flag(name: str) -> Any:
    """Read a flag's current value."""
    f = _REGISTRY.get(_canon(name))
    if f is None:
        raise KeyError(f"Unknown flag: {name}")
    return f.value


def set_flags(flags_map: Dict[str, Any]) -> None:
    with _LOCK:
        for k, v in flags_map.items():
            f = _REGISTRY.get(_canon(k))
            if f is None:
                raise KeyError(f"Unknown flag: {k}")
            f.value = f._coerce(v)


define_flag("paged_block_size", 16,
            "Default KV block size for the serving engine's paged pool.")
define_flag("serving_decode_burst", 8,
            "Decode micro-steps per engine step in the serving engine.")
define_flag("serving_prefill_chunk", 32,
            "Chunked-prefill slice length in the serving engine.")
define_flag("serving_ragged", False,
            "Single-dispatch ragged serving; off runs the two-program path "
            "(a batched prefill chunk and a decode burst per step).")
define_flag("serving_kv_cache_dtype", "auto",
            "KV-pool storage dtype: auto (the model compute dtype), bf16, "
            "f32, or int8 / fp8_e4m3 with per-page scales (ragged path "
            "only).")
define_flag("serving_adaptive_mix", True,
            "Adapt the per-step prefill/decode mix from the queue-depth and "
            "TTFT series of the engine's Prometheus registry.")
define_flag("bf16_stochastic_rounding_moments", True,
            "Stochastically round bf16 Adam moment2 stores (consumed by "
            "optimizer._store_moment and the fused Adam kernel; nearest "
            "rounding freezes the beta2 EMA below bf16 ulp).")
define_flag("tcp_store_timeout_s", 300,
            "Default timeout (s) of the rendezvous TCPStore's calls.")
define_flag("store_retry_max", 4,
            "Attempts of an idempotent TCPStore call (connect / set / get / "
            "wait) under a transient fault.")
define_flag("store_retry_base_s", 0.05,
            "First backoff (s) between TCPStore retries; doubles each retry "
            "with +/-50% jitter.")
define_flag("store_retry_max_s", 2.0,
            "Cap (s) on one TCPStore retry backoff.")
define_flag("comm_bucket_mb", 0.0,
            "Bucketed dp gradient sync: target bucket size in MB (0: the "
            "monolithic per-leaf reduction unless comm_quantize / "
            "comm_overlap_microbatches engage the bucketed path).")
define_flag("comm_quantize", "",
            "int8: error-feedback int8 all-reduce of the dp gradient "
            "buckets (replicated path only); empty: full precision.")
define_flag("comm_overlap_microbatches", 1,
            "Gradient-accumulation slices whose bucket collectives run "
            "under the next slice's backward.")
define_flag("zero_stage", 0,
            "ZeRO stage over the dp axis for build_hybrid_train_step "
            "(0 off, 1 optimizer state, 2 + gradients, 3 + parameters).")
define_flag("zero3_overlap_ag", True,
            "ZeRO-3: issue block i+1's parameter all-gather while block i "
            "computes.")
define_flag("zero3_quantize_ag", False,
            "ZeRO-3: int8 error-feedback wire format for the block "
            "parameter all-gathers.")
define_flag("moe_index_dispatch", False,
            "Index (gather / scatter) dispatch for GPT-MoE's expert layers: "
            "tokens go to their (expert, capacity slot) by slot id instead "
            "of the dense [T, E, C] one-hot einsums (consumed by "
            "comm_overlap.a2a.moe_dispatch_from_flags).")
define_flag("moe_quantize_a2a", False,
            "int8 error-feedback wire format of the expert-parallel "
            "all-to-alls (ROADMAP Queue 1 item 6: raises at ep degree 1).")
define_flag("moe_overlap", False,
            "Chunk the expert-parallel all-to-alls along the capacity dim "
            "and overlap them with the expert GEMMs (item 6: raises at ep "
            "degree 1).")
define_flag("moe_overlap_chunks", 2,
            "Capacity chunks of the overlapped expert all-to-all.")
