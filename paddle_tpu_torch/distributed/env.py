"""The process environment of a distributed run (counterpart:
``paddle_tpu/distributed/env.py``: ``get_rank``, ``get_world_size``,
``get_local_rank``, ``ParallelEnv``, ``init_parallel_env``,
``is_initialized``).

One process is one rank and drives one device. Rank and world size come
from the launcher's environment under the JAX package's names (Paddle's
first, then torchrun's), or from ``torch.distributed`` once the process
group is up. ``init_parallel_env`` starts that group over an explicit store:
a ``TCPStore`` on ``127.0.0.1`` (world size 1 picks a free port itself, so a
single process needs no launcher), another host:port, or a ``FileStore``.
On a machine with a CUDA card it takes NCCL and the card of the local rank;
gloo only when the caller passes ``device="cpu"`` or ``backend="gloo"``. If
NCCL fails to start, the call raises; it never drops to gloo.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = ["get_rank", "get_world_size", "get_local_rank", "ParallelEnv",
           "init_parallel_env", "is_initialized"]

_RANK_ENV = ("PADDLE_TRAINER_ID", "PADDLE_RANK_IN_NODE", "RANK")
_WORLD_ENV = ("PADDLE_TRAINERS_NUM", "WORLD_SIZE")
_LOCAL_ENV = ("PADDLE_LOCAL_RANK", "LOCAL_RANK")

# the device this process's collectives and tensors live on, set by
# init_parallel_env (build_mesh gives it to the mesh)
_device = [None]


def _env_int(names, default):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return default


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    if is_initialized():
        return dist.get_rank()
    return _env_int(_RANK_ENV, 0)


def get_world_size() -> int:
    if is_initialized():
        return dist.get_world_size()
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS")
    if eps:
        return len(eps.split(","))
    return _env_int(_WORLD_ENV, 1)


def get_local_rank() -> int:
    return _env_int(_LOCAL_ENV, 0)


class ParallelEnv:
    """Paddle's ``ParallelEnv`` query surface."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return get_local_rank()

    @property
    def dev_id(self):
        return get_local_rank()

    @property
    def nranks(self):
        return get_world_size()


def _store(init_method: Optional[str], rank: int, world: int,
           timeout: timedelta):
    """The rendezvous store: ``file://<path>`` a FileStore, ``tcp://host:port``
    a TCPStore that rank 0 hosts, nothing a TCPStore on 127.0.0.1 (a free
    port at world size 1; ``MASTER_ADDR`` / ``MASTER_PORT`` or
    ``PADDLE_MASTER`` otherwise)."""
    if init_method is None:
        ep = os.environ.get("PADDLE_MASTER")
        if ep:
            init_method = f"tcp://{ep}"
        elif "MASTER_PORT" in os.environ:
            init_method = (f"tcp://{os.environ.get('MASTER_ADDR', '127.0.0.1')}"
                           f":{os.environ['MASTER_PORT']}")
    if init_method is None:
        if world != 1:
            raise ValueError(
                "init_parallel_env: a world of more than one rank needs a "
                "rendezvous: init_method='tcp://host:port' or "
                "'file://path', or MASTER_ADDR / MASTER_PORT")
        return dist.TCPStore("127.0.0.1", 0, 1, True, timeout=timeout)
    if init_method.startswith("file://"):
        return dist.FileStore(init_method[len("file://"):], world)
    if init_method.startswith("tcp://"):
        host, port = init_method[len("tcp://"):].rsplit(":", 1)
        return dist.TCPStore(host, int(port), world, rank == 0,
                             timeout=timeout)
    raise ValueError(f"init_parallel_env: unknown init_method "
                     f"{init_method!r} (file:// or tcp://)")


def init_parallel_env(rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      init_method: Optional[str] = None,
                      backend: Optional[str] = None, device=None,
                      timeout_s: float = 300.0) -> ParallelEnv:
    """Start the default process group (a no-op when it is up already).

    ``backend``: None picks NCCL on the card (``device=None`` or a CUDA
    device) and gloo for ``device="cpu"``; ``"gloo"`` forces the CPU.
    ``rank`` / ``world_size`` default to the launcher's environment."""
    if is_initialized():
        return ParallelEnv()
    world = get_world_size() if world_size is None else int(world_size)
    rank = get_rank() if rank is None else int(rank)
    if backend == "gloo":
        dev = torch.device("cpu")
    else:
        dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("init_parallel_env: NCCL needs a CUDA device")
        dev = torch.device("cuda", get_local_rank() if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
    timeout = timedelta(seconds=timeout_s)
    store = _store(init_method, rank, world, timeout)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    _device[0] = dev
    return ParallelEnv()
