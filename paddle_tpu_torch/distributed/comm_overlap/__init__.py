"""Bucketed, overlapped and compressed dp collectives, the ZeRO-3
parameter gathers and the MoE dispatch configuration (counterpart:
``paddle_tpu/distributed/comm_overlap``). See ``overlap.py`` for the
bucketed / microbatched gradient sync, ``bucketing.py`` for the bucket
plans, ``quantize.py`` for the int8 wire format, ``zero3.py`` for
gather-on-use and ``a2a.py`` for the MoE dispatch modes and the expert
exchange at ep degree 1.

Not ported: the mp-axis half (``collective_matmul.py``, sequence-parallel
and ring collective matmuls) and the ep exchange's all-to-alls with their
int8 and overlapped forms wait for ROADMAP Queue 1 item 6; ``xla_flags.py``
tunes XLA's scheduler and has no counterpart; ``make_merge_comm_fn`` serves
GradientMerge, which the port does not have.
"""

from .a2a import (MoeDispatchConfig, expert_exchange,  # noqa: F401
                  moe_dispatch_from_flags, resolve_moe_dispatch)
from .bucketing import (Bucket, BucketPlan, LeafSlot, ShapeDtype,  # noqa: F401
                        build_bucket_plan, local_shape, pack_bucket,
                        unpack_bucket)
from .overlap import (CommOverlapConfig, config_from_flags,  # noqa: F401
                      ef_plan_for, ef_residual_specs, init_ef_residuals,
                      microbatched_reduced_grads, reduce_bucketed,
                      reduce_scatter_tree)
from .quantize import (dequantize_int8, ef_quantized_psum,  # noqa: F401
                       quantize_int8, replication_factor, residual_sq_norm,
                       spec_axes)
from .zero3 import (LayerGather, Zero3Config, all_gather_param,  # noqa: F401
                    ef_quantized_all_gather, gather_group, gather_tree,
                    resolve_zero3,
                    resolve_zero_stage, scan_gather, zero3_from_flags)

__all__ = [
    "Bucket", "BucketPlan", "LeafSlot", "ShapeDtype", "build_bucket_plan",
    "local_shape", "pack_bucket", "unpack_bucket",
    "CommOverlapConfig", "config_from_flags", "ef_plan_for",
    "ef_residual_specs", "init_ef_residuals", "microbatched_reduced_grads",
    "reduce_bucketed", "reduce_scatter_tree",
    "dequantize_int8", "ef_quantized_psum", "quantize_int8",
    "replication_factor", "residual_sq_norm", "spec_axes",
    "Zero3Config", "zero3_from_flags", "resolve_zero3",
    "resolve_zero_stage", "all_gather_param", "gather_group",
    "ef_quantized_all_gather",
    "gather_tree", "scan_gather", "LayerGather",
    "MoeDispatchConfig", "moe_dispatch_from_flags", "resolve_moe_dispatch",
    "expert_exchange",
]
