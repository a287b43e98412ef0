"""Mixture of experts on one device (counterpart:
``paddle_tpu/incubate/distributed/models/moe``): the gates, ``MoELayer``
with index and einsum dispatch over a stacked ``ExpertFFN`` bank, and the
MoE global-norm clip.

Expert parallelism (experts split over an ep group, the all-to-all
exchange, ``forward_shard_map``, the clip's norm summed over ep) raises
``NotImplementedError`` naming ROADMAP Queue 1 item 6."""

from .gate import (BaseGate, GShardGate, NaiveGate, SwitchGate,  # noqa: F401
                   TopKGate, compute_capacity)
from .grad_clip import (ClipGradForMOEByGlobalNorm,  # noqa: F401
                        clip_by_global_norm_with_moe)
from .moe_layer import ExpertFFN, MoELayer  # noqa: F401

__all__ = ["MoELayer", "ExpertFFN", "BaseGate", "NaiveGate", "GShardGate",
           "SwitchGate", "TopKGate", "compute_capacity",
           "ClipGradForMOEByGlobalNorm", "clip_by_global_norm_with_moe"]
