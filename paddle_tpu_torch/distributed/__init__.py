"""Distributed training over ``torch.distributed`` (counterpart:
``paddle_tpu/distributed``: ``env``, ``topology``, ``collective``,
``store``, ``parallel`` and ``comm_overlap``; the ZeRO engine itself is
``models/hybrid_engine.py``).

One process is one rank on one device: NCCL on the card, gloo on the CPU
(``init_parallel_env``). Not ported: ``sharding`` (``group_sharded_parallel``),
``fleet`` and its meta-parallel layers, ``auto_parallel``, ``checkpoint``,
``resilience``, ``rpc``, ``ps`` and the launcher (ROADMAP Queue 1 items 5,
6 and 8).
"""

from . import comm_overlap  # noqa: F401
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
    "comm_overlap",
]
