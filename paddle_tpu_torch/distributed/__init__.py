"""Distributed training over ``torch.distributed`` (counterpart:
``paddle_tpu/distributed``: ``env``, ``topology``, ``collective``,
``store``, ``parallel``, ``comm_overlap`` and ``sharding``, with the
sharding-stage parts of ``auto_parallel`` and ``fleet.meta_parallel``; the
hybrid ZeRO engine itself is ``models/hybrid_engine.py``).

One process is one rank on one device: NCCL on the card, gloo on the CPU
(``init_parallel_env``). Not ported: the rest of ``fleet`` and its
meta-parallel layers, the DistTensor half of ``auto_parallel``,
``checkpoint``, ``resilience``, ``rpc``, ``ps`` and the launcher (ROADMAP
Queue 1 items 6, 8 and 10).
"""

from . import comm_overlap  # noqa: F401
from . import sharding  # noqa: F401
from .collective import (P2POp, ReduceOp, all_gather, all_reduce, all_to_all,
                         barrier, batch_isend_irecv, broadcast, get_group,
                         new_group, ppermute, recv, reduce, reduce_scatter,
                         scatter, send)
from .env import (ParallelEnv, get_local_rank, get_rank, get_world_size,
                  init_parallel_env, is_initialized)
from .parallel import DataParallel, shard_batch
from .store import MasterStore, TCPStore
from .topology import (CommunicateTopology, Group, HybridCommunicateGroup,
                       Mesh, build_mesh, get_hybrid_communicate_group,
                       set_hybrid_communicate_group)
from .auto_parallel import (ShardingStage1, ShardingStage2, ShardingStage3,
                            shard_optimizer)
from .sharding import group_sharded_parallel, save_group_sharded_model

__all__ = [
    "get_rank", "get_world_size", "get_local_rank", "ParallelEnv",
    "init_parallel_env", "is_initialized",
    "CommunicateTopology", "HybridCommunicateGroup", "Group", "Mesh",
    "build_mesh", "get_hybrid_communicate_group",
    "set_hybrid_communicate_group",
    "ReduceOp", "all_reduce", "all_gather", "reduce_scatter", "broadcast",
    "reduce", "scatter", "all_to_all", "ppermute", "barrier", "P2POp",
    "batch_isend_irecv", "new_group", "get_group", "send", "recv",
    "DataParallel", "shard_batch", "TCPStore", "MasterStore",
    "comm_overlap", "sharding", "group_sharded_parallel",
    "save_group_sharded_model", "shard_optimizer", "ShardingStage1",
    "ShardingStage2", "ShardingStage3",
]
