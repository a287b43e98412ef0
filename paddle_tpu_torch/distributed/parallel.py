"""Data parallelism (counterpart: ``paddle_tpu/distributed/parallel.py``:
``shard_batch``, ``DataParallel``).

``shard_batch`` gives this rank its contiguous slice of the global batch,
the rows the JAX package's ``P("dp")`` placement puts on this rank's
device. ``DataParallel`` wraps a module the same way: its ``forward``
takes the GLOBAL batch and runs the module on this rank's slice, and the
gradients the backward accumulates are averaged over dp before it returns
(one async all-reduce per parameter as its gradient is ready, waited on
by a callback at the end of the backward), so an optimizer that reads
``.grad`` after ``backward()`` sees the synchronized gradient. Inside
``no_sync()`` nothing is reduced.
"""

from __future__ import annotations

import contextlib

import torch

from . import collective as C
from .topology import get_hybrid_communicate_group

__all__ = ["DataParallel", "shard_batch"]


def _dp(mesh, axis, group):
    if group is not None:
        return group
    if mesh is None:
        hcg = get_hybrid_communicate_group()
        mesh = hcg.mesh if hcg is not None else None
    if mesh is None or axis not in mesh.axis_names:
        return None
    return mesh.group(axis)


def shard_batch(batch, mesh=None, axis="dp", group=None):
    """This rank's contiguous slice of dim 0 of the global ``batch`` (the
    whole batch without a dp axis). ``axis`` may be a tuple of mesh axes
    (a batch spec's entry, ``P(("dp", "sharding"))``): the slices then run
    over those axes in row-major order, the first axis slowest."""
    if isinstance(axis, (tuple, list)):
        if mesh is None:
            hcg = get_hybrid_communicate_group()
            mesh = hcg.mesh if hcg is not None else None
        axes = [a for a in axis if mesh is not None and a in mesh.axis_names]
        n, pos = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            pos = pos * mesh.shape[a] + mesh.axis_index(a)
        if n == 1:
            return batch
        b = batch.shape[0]
        if b % n:
            raise ValueError(f"shard_batch: batch {b} does not divide over "
                             f"{tuple(axes)} ({n} ranks)")
        per = b // n
        return batch[pos * per:(pos + 1) * per]
    g = _dp(mesh, axis, group)
    if g is None or g.nranks == 1:
        return batch
    b = batch.shape[0]
    if b % g.nranks:
        raise ValueError(f"shard_batch: batch {b} does not divide over "
                         f"dp {g.nranks}")
    per = b // g.nranks
    return batch[g.rank * per:(g.rank + 1) * per]


class DataParallel(torch.nn.Module):
    """``layers`` replicated over dp; gradients averaged over dp."""

    def __init__(self, layers: torch.nn.Module, strategy=None,
                 comm_buffer_size=25, last_comm_buffer_size=1,
                 find_unused_parameters=False, group=None, mesh=None):
        super().__init__()
        del strategy, comm_buffer_size, last_comm_buffer_size
        del find_unused_parameters
        self._layers = layers
        self.group = _dp(mesh, "dp", group)
        self._sync = True
        self._pending = []
        self._queued = False
        if self.group is not None:
            for p in self._layers.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._hook)

    def _hook(self, p):
        if not self._sync:
            return
        self._pending.append(C.all_reduce(p.grad, C.ReduceOp.AVG,
                                          self.group, sync_op=False))
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)

    def _finish(self):
        for w in self._pending:
            w.wait()
        self._pending = []
        self._queued = False

    def forward(self, *inputs, **kwargs):
        inputs = tuple(shard_batch(x, group=self.group)
                       if isinstance(x, torch.Tensor) and x.dim() > 0 else x
                       for x in inputs)
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Gradients accumulate locally, unreduced, inside the scope."""
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)
