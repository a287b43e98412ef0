"""Collective communication over ``torch.distributed`` (counterpart:
``paddle_tpu/distributed/collective.py``: ``ReduceOp``, ``new_group``,
``get_group``, ``all_reduce``, ``all_gather``, ``reduce_scatter``,
``broadcast``, ``reduce``, ``scatter``, ``all_to_all``, ``send`` / ``recv``,
``P2POp`` / ``batch_isend_irecv``, ``ppermute``, ``barrier``).

The JAX package runs its collectives inside one compiled program over a
mesh axis, or eagerly over a rank-major array whose dim 0 is the group.
Here every rank is a process that calls the collective on its own tensor,
as in Paddle: row r of the JAX package's rank-major input is rank r's
tensor, and row r of its result is what rank r gets back. ``group`` is a
:class:`~.topology.Group` (a mesh axis's, or ``new_group``'s) or None for
every rank. NCCL runs them on the card, gloo on the CPU.

``sync_op=False`` returns the work handle; its ``wait()`` returns the
result once the collective is done (and finishes an ``AVG`` by its
division). AVG is a SUM divided by the group size on every backend, as
``lax.pmean`` computes it; PROD is ``torch.distributed``'s product (the
JAX package sums logarithms).
"""

from __future__ import annotations

import collections
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .topology import Group

__all__ = ["ReduceOp", "all_reduce", "all_gather", "reduce_scatter",
           "broadcast", "reduce", "scatter", "all_to_all", "send", "recv",
           "ppermute", "barrier", "P2POp", "batch_isend_irecv", "new_group",
           "get_group", "process_group", "group_size", "group_rank",
           "all_gather_into", "reduce_scatter_into", "Work", "CALLS"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
             ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT}

# torch 2.13 renamed the tensor forms; older releases have only these names
_all_gather_t = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_t = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

_groups = {}

# collectives issued, by name (what a step sends through NCCL or gloo)
CALLS = collections.Counter()


def process_group(group):
    """The ``torch.distributed`` group of a Group (None: every rank)."""
    if group is None:
        return None
    if isinstance(group, Group):
        return group.process_group
    return group


def group_size(group) -> int:
    return dist.get_world_size(process_group(group))


def group_rank(group) -> int:
    return dist.get_rank(process_group(group))


class Work:
    """A pending collective: ``wait()`` waits, runs the finishing step and
    returns the result."""

    def __init__(self, work, finish: Callable):
        self._work = work
        self._finish = finish
        self._done = False
        self._result = None

    def wait(self):
        if not self._done:
            if self._work is not None:
                self._work.wait()
            self._result = self._finish()
            self._done = True
        return self._result


def _run(work, sync_op: bool, finish: Callable):
    w = Work(work, finish)
    return w.wait() if sync_op else w


def _avg(tensor, n):
    if tensor.is_floating_point() or tensor.is_complex():
        return tensor.div_(n)
    return tensor.floor_divide_(n)


def new_group(ranks: Optional[List[int]] = None, backend=None,
              timeout=None) -> Group:
    """A group over ``ranks`` (every rank of the default group must call
    it, with the same ranks)."""
    del timeout
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    pg = (dist.group.WORLD if ranks == list(range(world)) and backend is None
          else dist.new_group(ranks, backend=backend))
    me = dist.get_rank()
    g = Group(ranks.index(me) if me in ranks else -1,
              next(Group._group_counter), ranks, axis_name="world",
              process_group=pg)
    _groups[g.id] = g
    return g


def get_group(gid: int) -> Optional[Group]:
    return _groups.get(gid)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def all_reduce(tensor, op: str = ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group IN PLACE; returns it (or the work
    handle)."""
    pg = process_group(group)
    CALLS["all_reduce"] += 1
    work = dist.all_reduce(tensor, _TORCH_OP[op], pg, async_op=not sync_op)
    n = group_size(group)
    return _run(work, sync_op,
                lambda: _avg(tensor, n) if op == ReduceOp.AVG else tensor)


def all_gather_into(x, dim: int, group=None, sync_op=True):
    """The tiled gather of ``lax.all_gather(x, axis, axis=dim, tiled=True)``:
    every rank's ``x`` concatenated along ``dim`` in group-rank order. Any
    ``dim``: the tensors travel with ``dim`` moved to the front, so each
    rank's piece is one contiguous run."""
    n = group_size(group)
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * front.shape[0],) + tuple(front.shape[1:]),
                      dtype=x.dtype, device=x.device)
    CALLS["all_gather"] += 1
    work = _all_gather_t(out, front, group=process_group(group),
                         async_op=not sync_op)
    return _run(work, sync_op, lambda: out.movedim(0, dim))


def reduce_scatter_into(x, dim: int, group=None, sync_op=True,
                        op: str = ReduceOp.SUM):
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    the group's sum of ``x``, and this rank's block of it along ``dim``
    (contiguous)."""
    n = group_size(group)
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // n,) + tuple(front.shape[1:]),
                      dtype=x.dtype, device=x.device)
    CALLS["reduce_scatter"] += 1
    work = _reduce_scatter_t(out, front, op=_TORCH_OP[op],
                             group=process_group(group),
                             async_op=not sync_op)

    def finish():
        if op == ReduceOp.AVG:
            _avg(out, n)
        return out.movedim(0, dim).contiguous() if dim else out
    return _run(work, sync_op, finish)


def all_gather(tensor_or_list, tensor=None, group=None, sync_op=True,
               gather_axis: int = 0, tiled: bool = False):
    """``all_gather(x)``: the group's tensors stacked ``[n, ...]`` (or
    concatenated along ``gather_axis`` with ``tiled=True``).
    ``all_gather(out_list, x)``: Paddle's list form, ``out_list`` extended
    by the n tensors."""
    if tensor is None:
        x = tensor_or_list
        if tiled:
            return all_gather_into(x, gather_axis, group, sync_op)
        w = all_gather_into(x.unsqueeze(0), 0, group, sync_op=False)
        return w.wait() if sync_op else w
    n = group_size(group)
    outs = [torch.empty_like(tensor) for _ in range(n)]
    CALLS["all_gather"] += 1
    work = dist.all_gather(outs, tensor.contiguous(), process_group(group),
                           async_op=not sync_op)
    tensor_or_list.extend(outs)
    return _run(work, sync_op, lambda: tensor_or_list)


def reduce_scatter(tensor, op: str = ReduceOp.SUM, group=None, sync_op=True,
                   scatter_dim: int = 0):
    """The group's reduction of ``tensor``, this rank's block of it along
    ``scatter_dim`` (``psum_scatter`` tiled)."""
    return reduce_scatter_into(tensor, scatter_dim, group, sync_op, op)


def broadcast(tensor, src: int = 0, group=None, sync_op=True):
    """Rank ``src``'s (a global rank) ``tensor`` on every rank, in place."""
    CALLS["broadcast"] += 1
    work = dist.broadcast(tensor, src, process_group(group),
                          async_op=not sync_op)
    return _run(work, sync_op, lambda: tensor)


def reduce(tensor, dst: int = 0, op: str = ReduceOp.SUM, group=None,
           sync_op=True):
    """The group's reduction in ``tensor`` on rank ``dst`` (a global rank);
    the other ranks' tensors are undefined after it."""
    CALLS["reduce"] += 1
    work = dist.reduce(tensor, dst, _TORCH_OP[op], process_group(group),
                       async_op=not sync_op)
    n = group_size(group)

    def finish():
        if op == ReduceOp.AVG and dist.get_rank() == dst:
            _avg(tensor, n)
        return tensor
    return _run(work, sync_op, finish)


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op=True):
    """With ``tensor_list`` (Paddle's form): rank i of the group receives
    ``tensor_list[i]`` of rank ``src`` into ``tensor``. Without it (the JAX
    package's form): ``tensor`` is ``[n, ...]`` on ``src`` and rank i gets
    a new tensor, row i of it."""
    pg = process_group(group)
    me_src = dist.get_rank() == src
    if tensor_list is None:
        out = torch.empty(tuple(tensor.shape[1:]), dtype=tensor.dtype,
                          device=tensor.device)
        parts = ([t.contiguous() for t in tensor.unbind(0)] if me_src
                 else None)
        work = dist.scatter(out, parts, src, pg, async_op=not sync_op)
        return _run(work, sync_op, lambda: out)
    parts = [t.contiguous() for t in tensor_list] if me_src else None
    work = dist.scatter(tensor, parts, src, pg, async_op=not sync_op)
    return _run(work, sync_op, lambda: tensor)


def all_to_all(out_tensor_list, in_tensor_list=None, group=None,
               sync_op=True, split_axis: int = 0, concat_axis: int = 0):
    """``all_to_all(x)``: ``x`` split into n blocks along ``split_axis``,
    block j to rank j, the received blocks concatenated along
    ``concat_axis`` (``lax.all_to_all`` tiled). ``all_to_all(out_list,
    in_list)``: Paddle's list form, in place."""
    pg = process_group(group)
    if in_tensor_list is None:
        n = group_size(group)
        ins = [c.contiguous() for c in
               out_tensor_list.chunk(n, dim=split_axis)]
        outs = [torch.empty_like(c) for c in ins]
        work = dist.all_to_all(outs, ins, pg, async_op=not sync_op)
        return _run(work, sync_op, lambda: torch.cat(outs, dim=concat_axis))
    work = dist.all_to_all(out_tensor_list,
                           [t.contiguous() for t in in_tensor_list], pg,
                           async_op=not sync_op)
    return _run(work, sync_op, lambda: out_tensor_list)


def send(tensor, dst: int, group=None, sync_op=True):
    """Point-to-point send to global rank ``dst`` (pair with ``recv``)."""
    pg = process_group(group)
    if sync_op:
        dist.send(tensor.contiguous(), dst, pg)
        return None
    return dist.isend(tensor.contiguous(), dst, pg)


def recv(tensor, src: int, group=None, sync_op=True):
    """Point-to-point receive from global rank ``src`` into ``tensor``."""
    pg = process_group(group)
    if sync_op:
        dist.recv(tensor, src, pg)
        return tensor
    return dist.irecv(tensor, src, pg)


class P2POp:
    """One send or receive of a batch (Paddle's ``P2POp``): ``op`` is
    ``"isend"`` / ``"irecv"`` (or ``dist.isend`` / ``dist.irecv``), ``peer``
    a global rank."""

    def __init__(self, op, tensor, peer: int, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group

    def _torch(self):
        name = self.op if isinstance(self.op, str) else getattr(
            self.op, "__name__", "")
        fn = {"isend": dist.isend, "send": dist.isend, "irecv": dist.irecv,
              "recv": dist.irecv}[name]
        return dist.P2POp(fn, self.tensor, self.peer,
                          process_group(self.group))


def batch_isend_irecv(p2p_op_list: List[P2POp]):
    """Issue the batch together; returns the work handles (a receive's
    tensor is filled once its handle is waited on)."""
    if not p2p_op_list:
        return []
    return dist.batch_isend_irecv([op._torch() for op in p2p_op_list])


def ppermute(x, perm: Sequence, group=None):
    """``lax.ppermute``: ``perm`` holds (source, destination) pairs of group
    ranks; this rank sends ``x`` to its destination and returns what its
    source sent, or zeros when no pair names it as a destination. Runs as
    paired isend / irecv."""
    me = group_rank(group)
    ranks = (group.ranks if isinstance(group, Group)
             else list(range(dist.get_world_size())))
    out = torch.zeros_like(x)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(P2POp("isend", x.contiguous(), ranks[d], group))
        elif d == me:
            ops.append(P2POp("irecv", out, ranks[s], group))
    for w in batch_isend_irecv(ops):
        w.wait()
    return out


def barrier(group=None):
    dist.barrier(process_group(group))

