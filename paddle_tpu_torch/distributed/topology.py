"""Parallel topology (counterpart: ``paddle_tpu/distributed/topology.py``:
``Group``, ``CommunicateTopology``, ``build_mesh``,
``HybridCommunicateGroup``).

The JAX package's topology is a ``jax.sharding.Mesh`` over devices; a
collective names a mesh axis. Here a rank is a process, and a :class:`Mesh`
holds the axis names and degrees, this rank's coordinate on each axis, and
one ``torch.distributed`` process group per axis (the group of the ranks
that differ from this one only on that axis). ``mesh.shape[axis]`` reads as
in JAX. Ranks map to coordinates in row-major order over the axes as given
(the first axis changes slowest), as the JAX package reshapes its device
list.

Not ported: ``_split_ici_dcn`` and ``_hybrid_device_array`` lay TPU devices
out over ICI and DCN links; that tiling is not semantics (ROADMAP's parity
rule 4), and a process group has no device order to choose.
``HybridCommunicateGroup`` takes degree 1 on every axis but dp: tensor,
pipeline, sequence and expert parallelism are ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..enforce import enforce

__all__ = ["Group", "Mesh", "CommunicateTopology", "HybridCommunicateGroup",
           "build_mesh", "get_hybrid_communicate_group",
           "set_hybrid_communicate_group"]


class Group:
    """A set of ranks forming one collective scope (Paddle's
    ``communication/group.py`` ``Group``); ``process_group`` is the
    ``torch.distributed`` group the collectives run on."""

    _group_counter = itertools.count()

    def __init__(self, rank_in_group: int, group_id: int, ranks: List[int],
                 axis_name: Optional[str] = None, mesh=None,
                 process_group=None):
        self.rank = rank_in_group
        self.id = group_id
        self.ranks = list(ranks)
        self.nranks = len(ranks)
        self.axis_name = axis_name
        self.mesh = mesh
        self.process_group = process_group

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self) -> bool:
        return self.rank >= 0

    def __repr__(self):
        return (f"Group(id={self.id}, nranks={self.nranks}, "
                f"axis={self.axis_name}, ranks={self.ranks})")


class CommunicateTopology:
    """Cartesian rank <-> coordinate mapping (Paddle's ``topology.py``)."""

    def __init__(self, hybrid_group_names: Sequence[str] = (
            "data", "pipe", "sharding", "sep", "model"),
                 dims: Sequence[int] = (1, 1, 1, 1, 1)):
        enforce(len(hybrid_group_names) == len(dims),
                "group names and degrees must align",
                op="CommunicateTopology")
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self.coordinate = list(itertools.product(*[range(d) for d in dims]))
        self._coord2rank = {c: i for i, c in enumerate(self.coordinate)}
        self._rank2coord = {i: c for i, c in enumerate(self.coordinate)}
        self._world_size = int(math.prod(self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **kwargs) -> int:
        enforce(len(kwargs) == len(self._parallel_names),
                "get_rank needs one coordinate per axis",
                op="CommunicateTopology.get_rank")
        return self._coord2rank[tuple(kwargs[n]
                                      for n in self._parallel_names)]

    def get_coord(self, rank: int):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Every group along ``axis_name``: one rank list per combination of
        the other axes."""
        axis = self._parallel_names.index(axis_name)
        other = [d for i, d in enumerate(self._dims) if i != axis]
        out = []
        for rest in itertools.product(*[range(d) for d in other]):
            ranks = []
            for i in range(self._dims[axis]):
                coord = list(rest)
                coord.insert(axis, i)
                ranks.append(self._coord2rank[tuple(coord)])
            out.append(ranks)
        return out

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = list(self.get_coord(global_rank))
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return self._coord2rank[tuple(coord)]


class Mesh:
    """Named axes over the ranks of the default process group."""

    def __init__(self, dims: Dict[str, int], rank: int):
        self.axis_names = tuple(dims)
        self.shape = {a: int(d) for a, d in dims.items()}
        self.size = int(math.prod(self.shape.values()))
        self.rank = rank
        self.topology = CommunicateTopology(self.axis_names,
                                            [self.shape[a]
                                             for a in self.axis_names])
        coord = self.topology.get_coord(rank)
        self.coords = dict(zip(self.axis_names, coord))
        self.device = None            # this rank's device (build_mesh)
        self.groups: Dict[str, Group] = {}
        world = list(range(self.size))
        for axis in self.axis_names:
            mine = None
            # every rank creates every group, in the same order
            for ranks in self.topology.get_comm_list(axis):
                pg = (dist.group.WORLD if ranks == world
                      else dist.new_group(ranks))
                if rank in ranks:
                    mine = (ranks, pg)
            self.groups[axis] = Group(mine[0].index(rank),
                                      next(Group._group_counter), mine[0],
                                      axis_name=axis, mesh=self,
                                      process_group=mine[1])

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]

    def group(self, axis: str) -> Group:
        return self.groups[axis]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def build_mesh(dims: Dict[str, int], device=None) -> Mesh:
    """A :class:`Mesh` from ``{axis: degree}``; degrees multiply to the
    world size (axes of degree 1 are kept so specs can name them). Starts
    a one-rank process group (``init_parallel_env``, on ``device``) when
    none is up and the degrees multiply to 1."""
    from .env import init_parallel_env, is_initialized
    total = int(math.prod(dims.values()))
    if not is_initialized() and total == 1:
        init_parallel_env(rank=0, world_size=1, device=device)
    enforce(is_initialized(), "build_mesh needs the process group: call "
            "init_parallel_env() first", op="build_mesh")
    enforce(total == dist.get_world_size(),
            f"product of parallel degrees {dims} = {total} != world size "
            f"{dist.get_world_size()}", op="build_mesh")
    mesh = Mesh(dict(dims), dist.get_rank())
    from . import env
    mesh.device = env._device[0] or (
        torch.device("cuda", torch.cuda.current_device())
        if dist.get_backend() == "nccl" else torch.device("cpu"))
    return mesh


class HybridCommunicateGroup:
    """Paddle's ``HybridCommunicateGroup`` query surface over a
    :class:`Mesh`: axes dp / pp / sharding / sep / mp (the reference's
    data / pipe / sharding / sep / model). Every degree but dp's must be 1
    here (ROADMAP Queue 1 item 6)."""

    AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding",
                "sep": "sep", "model": "mp"}

    def __init__(self, topology: CommunicateTopology, device=None):
        names = topology.get_hybrid_group_names()
        for n in names:
            if n != "data" and topology.get_dim(n) > 1:
                raise NotImplementedError(
                    f"{n} parallelism (degree {topology.get_dim(n)}) is not "
                    f"ported yet (ROADMAP Queue 1 item 6)")
        self._topo = topology
        self.nranks = topology.world_size()
        self.mesh = build_mesh({self.AXIS_MAP[n]: topology.get_dim(n)
                                for n in names}, device=device)
        self.global_rank = self.mesh.rank
        self._groups = {a: self.mesh.group(a) for a in self.mesh.axis_names}
        self._dp_degree = self.mesh.shape.get("dp", 1)

    def get_parallel_mode(self):
        return "data_parallel" if self._dp_degree > 1 else "single"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    def _g(self, axis):
        return self._groups.get(axis, Group(0, -1, [self.global_rank]))

    def get_data_parallel_rank(self):
        return self._g("dp").rank

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._g("dp")

    def get_model_parallel_rank(self):
        return self._g("mp").rank

    def get_model_parallel_world_size(self):
        return 1

    def get_model_parallel_group(self):
        return self._g("mp")

    def get_stage_id(self):
        return self._g("pp").rank

    get_pipe_parallel_rank = get_stage_id

    def get_pipe_parallel_world_size(self):
        return 1

    def get_pipe_parallel_group(self):
        return self._g("pp")

    def get_sharding_parallel_rank(self):
        return self._g("sharding").rank

    def get_sharding_parallel_world_size(self):
        return 1

    def get_sharding_parallel_group(self):
        return self._g("sharding")

    def get_sep_parallel_rank(self):
        return self._g("sep").rank

    def get_sep_parallel_world_size(self):
        return 1

    def get_sep_parallel_group(self):
        return self._groups.get("sep")

    def is_first_stage(self):
        return True

    def is_last_stage(self):
        return True


_HCG: List[Optional[HybridCommunicateGroup]] = [None]


def set_hybrid_communicate_group(hcg: HybridCommunicateGroup):
    _HCG[0] = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _HCG[0]
