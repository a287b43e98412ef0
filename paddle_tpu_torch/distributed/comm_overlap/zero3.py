"""ZeRO-3 parameter gathers: dp-sharded parameters gathered on use
(counterpart: ``paddle_tpu/distributed/comm_overlap/zero3.py``:
``Zero3Config``, ``zero3_from_flags``, ``resolve_zero3``,
``resolve_zero_stage``, ``all_gather_param``, ``ef_quantized_all_gather``,
``gather_tree``, ``scan_gather``).

* :func:`all_gather_param` / :func:`gather_group` are a
  ``torch.autograd.Function``: an all-gather forward whose backward
  reduce-scatters, so each rank's gradient arrives as its SHARD, already
  summed over the group: the transpose the JAX engine gets from
  ``lax.all_gather``'s autodiff. A group of leaves travels packed in one
  buffer, one collective each way (the reference's comm buffers,
  ``dygraph_sharding_optimizer.py:571``): a layer's part is one gather,
  not one a leaf.
* :func:`ef_quantized_all_gather`: the int8 wire format with an error-
  feedback residual; the backward reduce-scatters in full precision.
* :func:`scan_gather`: the layer loop with gather-on-use. The loop body
  gets a :class:`LayerGather` and gathers what it uses inside itself, so a
  body that checkpoints gathers again in the backward's replay and no
  block's full parameters outlive the block. With ``cfg.overlap``, block
  i+1's gathers are issued (``async_op``) before block i runs, and block
  i+1's first forward takes them instead of gathering.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ...flags import flag
from .. import collective as C
from .quantize import dequantize_int8, quantize_int8

__all__ = ["Zero3Config", "zero3_from_flags", "resolve_zero3",
           "resolve_zero_stage", "all_gather_param", "gather_group",
           "ef_quantized_all_gather", "gather_tree", "scan_gather",
           "LayerGather", "GATHERS"]

# group gathers issued (forward, prefetch and replay), and the group
# reduce-scatters their backward issues
GATHERS = {"all_gather": 0, "reduce_scatter": 0}


@dataclasses.dataclass(frozen=True)
class Zero3Config:
    """overlap: issue block i+1's gathers before block i runs. quantize:
    int8 error-feedback wire format for the block gathers. ef: error
    feedback for the quantized gather (False is a test's ablation)."""
    overlap: bool = True
    quantize: bool = False
    ef: bool = True

    def meta(self):
        return {"overlap": bool(self.overlap),
                "quantize": bool(self.quantize), "ef": bool(self.ef)}


def zero3_from_flags() -> Zero3Config:
    return Zero3Config(overlap=bool(flag("zero3_overlap_ag")),
                       quantize=bool(flag("zero3_quantize_ag")))


def resolve_zero3(arg) -> Zero3Config:
    """``"auto"`` reads the flags, None the defaults, a Zero3Config
    forces."""
    if arg == "auto":
        return zero3_from_flags()
    if arg is None:
        return Zero3Config()
    return arg


def resolve_zero_stage(zero_stage, zero1_dp: bool = False, *,
                       op: str = "build_hybrid_train_step") -> int:
    """``"auto"`` reads FLAGS_zero_stage, None is 0, and the legacy
    ``zero1_dp=True`` is stage 1 (a different explicit stage is
    refused)."""
    from ...enforce import enforce
    stage = zero_stage
    if stage == "auto":
        stage = int(flag("zero_stage"))
    stage = 0 if stage is None else int(stage)
    if zero1_dp:
        enforce(stage in (0, 1),
                "zero1_dp is the legacy spelling of zero_stage=1 — do not "
                "combine it with a different explicit stage", op=op,
                zero_stage=stage)
        stage = 1
    return stage


def _pack(xs, dims):
    """Each tensor with its gather dim moved first, flattened, one after
    the other: the buffer one collective moves for a group of leaves."""
    parts = [x.movedim(d, 0).reshape(-1) for x, d in zip(xs, dims)]
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts)


def _gather_flat(shards, dims, group, sync_op=True):
    """One all-gather of the group's packed shards: ``[n, total]``."""
    n = C.group_size(group)
    inner = C.all_gather_into(_pack(shards, dims), 0, group, sync_op=False)
    w = C.Work(inner, lambda: inner.wait().view(n, -1))
    return w.wait() if sync_op else w


class _AllGatherGroup(torch.autograd.Function):
    """Full leaves from this rank's shards, a group of leaves in ONE
    all-gather (their shards packed into one buffer); the backward packs
    the full gradients the same way and reduce-scatters them in ONE
    collective, each rank keeping the group's sum of its shards."""

    @staticmethod
    def forward(ctx, dims, group, prefetched, *shards):
        ctx.dims, ctx.group = dims, group
        ctx.fronts = [tuple(x.movedim(d, 0).shape)
                      for x, d in zip(shards, dims)]
        ctx.dtype, ctx.device = shards[0].dtype, shards[0].device
        if prefetched is None:
            GATHERS["all_gather"] += 1
            flat = _gather_flat(shards, dims, group)
        else:
            flat = prefetched.wait()
        n, off, out = flat.shape[0], 0, []
        for (k, *rest), d in zip(ctx.fronts, dims):
            size = k * int(torch.Size(rest).numel())
            full = flat[:, off:off + size].reshape((n * k,) + tuple(rest))
            out.append(full.movedim(0, d))
            off += size
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        GATHERS["reduce_scatter"] += 1
        n = C.group_size(ctx.group)
        parts = [(g.movedim(d, 0).reshape(n, -1) if g is not None else
                  torch.zeros((n, int(torch.Size(f).numel())),
                              dtype=ctx.dtype, device=ctx.device))
                 for g, d, f in zip(grads, ctx.dims, ctx.fronts)]
        buf = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        mine = C.reduce_scatter_into(buf, 0, ctx.group).reshape(-1)
        out, off = [], 0
        for front, d in zip(ctx.fronts, ctx.dims):
            size = int(torch.Size(front).numel())
            out.append(mine[off:off + size].view(front).movedim(0, d)
                       .contiguous())
            off += size
        return (None, None, None) + tuple(out)


def gather_group(shards, dims, group, prefetched=None):
    """The full leaves of ``shards`` (each gathered along its ``dims``
    entry) in one all-gather; their gradients come back reduce-scattered in
    one collective. ``prefetched``: a pending ``_gather_flat`` of the same
    shards, taken instead of gathering."""
    return list(_AllGatherGroup.apply(tuple(dims), group, prefetched,
                                      *shards))


def all_gather_param(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The full leaf from this rank's shard along ``dim``; its gradient is
    the group's sum reduce-scattered back to the shard."""
    return gather_group([x], [dim], group)[0]


class _QuantizedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, dim, group):
        ctx.dim, ctx.group = dim, group
        n = C.group_size(group)
        xr = x.float() + res.float()
        # one scale per source shard: a gather only concatenates, so each
        # destination dequantizes each shard with its source's grid
        scale = torch.clamp(torch.amax(torch.abs(xr)),
                            min=torch.finfo(torch.float32).tiny) / 127.0
        q = quantize_int8(xr, scale)
        new_res = xr - dequantize_int8(q, scale)
        qg = C.all_gather(q, group=group)                  # [n, *shard]
        sg = C.all_gather(scale.reshape(()), group=group)  # [n]
        GATHERS["all_gather"] += 2
        full = qg.float() * sg.reshape((n,) + (1,) * x.dim())
        full = full.movedim(0, dim)
        shp = list(x.shape)
        shp[dim] *= n
        full = full.reshape(shp).to(x.dtype)
        return full, new_res.to(res.dtype)

    @staticmethod
    def backward(ctx, ct_full, ct_res):
        GATHERS["reduce_scatter"] += 1
        g = C.reduce_scatter_into(ct_full.contiguous(), ctx.dim, ctx.group)
        return g, torch.zeros_like(ct_res) if ct_res is not None else None, \
            None, None


def ef_quantized_all_gather(x, res, dim: int, group):
    """(full leaf ~ gather(x + res), new residual): int8 codes and one fp32
    scale per source shard on the wire; the full leaf's gradient
    reduce-scatters in full precision (straight through) and the residual
    takes none."""
    return _QuantizedGather.apply(x, res, dim, group)


def gather_tree(shards: Dict[str, torch.Tensor], zdims, group):
    """Plain gather of one layer's parameters: ``zdims`` are the STACKED
    dims (of the ``[L, ...]`` leaves), so a slice gathers dim ``zd - 1``;
    ``zd < 1`` passes through. The sharded leaves go in one group."""
    return LayerGather(shards, zdims, group)(shards)


class LayerGather:
    """One layer's shards and the gathers a loop body asks for.

    ``lg(names)`` returns the full tensors of those names: a prefetched
    gather the first time (``prefetch()``), a fresh one after (a
    checkpoint's replay). ``lg.shards`` holds the per-layer shard tensors
    (autograd inputs). Quantized gathers (``residuals``) record each leaf's
    new residual in ``new_residuals``. ``sync_keys`` are never prefetched:
    a body that replays them under a selective checkpoint must issue the
    same operations in the forward as in the replay."""

    def __init__(self, shards, zdims, group, residuals=None, ef=True,
                 sync_keys=()):
        self.shards = shards
        self.sync_keys = frozenset(sync_keys)
        self.zdims = zdims
        self.group = group
        self.residuals = residuals
        self.ef = ef
        self.new_residuals = {}
        self._pending = None

    def _sharded(self, keys):
        """The keys gathered as one group (sorted), quantized ones apart."""
        return tuple(sorted(k for k in keys if self.zdims[k] >= 1
                            and not self._quantized(k)))

    def _quantized(self, k):
        return self.residuals is not None and \
            self.residuals[k].shape[-1] > 0

    def prefetch(self):
        """Issue the gather of every sharded leaf but ``sync_keys``, as one
        group (a body that asks for exactly that group takes it)."""
        keys = self._sharded(k for k in self.shards
                             if k not in self.sync_keys)
        if keys and self.residuals is None:
            GATHERS["all_gather"] += 1
            # the shards' data only: the autograd node is the group
            # gather's, made when the body takes the result
            self._pending = (keys, _gather_flat(
                [self.shards[k].detach() for k in keys],
                [self.zdims[k] - 1 for k in keys], self.group,
                sync_op=False))

    def __call__(self, shards: Dict[str, torch.Tensor]):
        """The full tensors of ``shards`` (a subset of this layer's, maybe
        the copies a checkpoint hands its function): the sharded ones in
        one group gather, the quantized ones one by one."""
        out = {k: x for k, x in shards.items() if self.zdims[k] < 1}
        for k, x in shards.items():
            if self.zdims[k] >= 1 and self._quantized(k):
                res = self.residuals[k]
                if not self.ef:
                    res = torch.zeros_like(res)
                full, nres = ef_quantized_all_gather(
                    x, res, self.zdims[k] - 1, self.group)
                self.new_residuals[k] = (nres.detach() if self.ef
                                         else torch.zeros_like(nres))
                out[k] = full
        keys = self._sharded(shards)
        if keys:
            prefetched = None
            if self._pending is not None and self._pending[0] == keys:
                prefetched = self._pending[1]
                self._pending = None
            fulls = gather_group([shards[k] for k in keys],
                                 [self.zdims[k] - 1 for k in keys],
                                 self.group, prefetched)
            out.update(zip(keys, fulls))
        return out


def scan_gather(fn, carry, stacked, zdims, group, *, cfg: Optional[
        Zero3Config] = None, residuals=None, sync_keys=()):
    """The layer loop with gather-on-use: ``fn(lg, carry) -> carry`` for each
    layer i, ``lg`` the :class:`LayerGather` of layer i's slices of
    ``stacked`` (``[L, ...]`` dp shards; ``zdims`` their stacked dims,
    ``< 1`` for a leaf that is not sharded). With ``cfg.overlap`` (and no
    quantization) layer i+1's gathers are issued before ``fn`` runs layer
    i. ``residuals`` (stacked like ``stacked``, fp32; a 0-column leaf is not
    quantized) switch on the int8 gathers; ``sync_keys`` are gathered
    where they are used, never ahead (``LayerGather``). Returns ``(carry,
    new_residuals)``, the residuals restacked (None without)."""
    cfg = cfg if cfg is not None else Zero3Config()
    layers = {k: v.unbind(0) for k, v in stacked.items()}
    L = len(next(iter(layers.values())))
    res_layers = ({k: v.unbind(0) for k, v in residuals.items()}
                  if residuals is not None else None)

    def layer(i):
        return LayerGather(
            {k: v[i] for k, v in layers.items()}, zdims, group,
            residuals=(None if res_layers is None
                       else {k: v[i] for k, v in res_layers.items()}),
            ef=cfg.ef, sync_keys=sync_keys)

    prefetch = cfg.overlap and residuals is None
    new_res = []
    nxt = layer(0)
    if prefetch:
        nxt.prefetch()
    for i in range(L):
        lg = nxt
        if i + 1 < L:
            nxt = layer(i + 1)
            if prefetch:
                nxt.prefetch()     # independent of fn: runs beside it
        carry = fn(lg, carry)
        if res_layers is not None:
            new_res.append({k: lg.new_residuals.get(k, res_layers[k][i])
                            for k in res_layers})
    if res_layers is None:
        return carry, None
    return carry, {k: torch.stack([r[k] for r in new_res])
                   for k in res_layers}
