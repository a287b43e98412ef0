"""Bigger-than-device training by per-block PARAMETER streaming
(counterpart: ``paddle_tpu/distributed/sharding/param_stream.py``:
``supports_pinned_host``, ``park``, ``fetch`` and
``build_param_streamed_train_step``; the reference's GroupShardedStage3
parameter slicing with gather-on-use, release and ``offload=True``).

The parameters and the optimizer state live in pinned host memory, one flat
buffer per segment (the embedding, each transformer block, the head), and
stream through the device one segment at a time, forward and backward. On
the device a step holds the cached boundary activations (one ``[B, S, H]``
per block), one or two blocks' parameters, one block's gradients and
moments, and one block's recompute residuals. The backward is fused with
the update: a block's gradients exist only inside its own step and are
never gathered for the whole model. Per step the host link carries the
parameters down twice (forward, then the backward's recompute), the new
parameters up once and the moments down and up once.

The JAX package compiles five programs; here they are five functions:
the embedding forward, the block forward (under ``no_grad``), and the
head, block and embedding steps, each of which recomputes its forward under
autograd, takes ``torch.autograd.grad`` against the incoming gradient and
updates its segment in place through ``Optimizer._apply_leaves`` with the
segment's leaf ``offset`` (the stochastic-rounding seeds of leaf i of a
segment are those of leaf ``offset + i`` of the whole model). No autograd
graph lives past one segment.

Copies run on two streams of their own (``_host.Copier``): segment i+1 is
fetched while segment i computes, and a segment is parked (written back
into the SAME pinned buffers with ``donate=True``) while the next one
computes. The step ends by waiting for both streams, so the caller may read
the host trees as soon as it returns.

Global-norm clip is a two-pass backward over the cached boundary
activations: pass 1 re-streams the parameters through an update-free
backward that accumulates the fp32 norm^2 (``nn.clip.sum_squares``), pass 2
is the fused update with every gradient scaled by the shared coefficient
(``scale_from_norm``). By-value clip is fused into each segment's update.
"""

from __future__ import annotations

from typing import Callable

import torch

from ... import resolve_device
from .. import _tree
from . import _host
from ._host import fetch, park, supports_pinned_host
from .group_sharded import _leaf_streamable

__all__ = ["build_param_streamed_train_step", "park", "fetch",
           "supports_pinned_host"]


def _with_grad(tree):
    """(tree of fresh autograd leaves over the same storage, the leaves)."""
    pairs = _tree.flatten(tree)
    leaves = [t.detach().requires_grad_(True) for _, t in pairs]
    return _tree.unflatten([p for p, _ in pairs], leaves), leaves


def _grads_tree(tree, grads):
    return _tree.unflatten([p for p, _ in _tree.flatten(tree)],
                           [None if g is None else g.contiguous()
                            for g in grads])


def build_param_streamed_train_step(
    embed_fn: Callable, block_fn: Callable, head_loss_fn: Callable,
    optimizer, device=None, donate: bool = True,
):
    """Param-streaming trainer over a segmented model:

      embed_fn(embed_params, inputs) -> x          [B, S, H] activations
      block_fn(block_params, x) -> x               one transformer block
      head_loss_fn(head_params, x, targets) -> scalar loss

    Params layout: ``{"embed": tree, "blocks": [tree x L], "head": tree}``
    (``models.gpt`` / ``models.llama`` ``streamed_fns`` and
    ``init_streamed_params`` make these).

    Returns ``(place, init_state, step)``:

    * ``place(params)`` -> host params: each segment one flat host buffer
      (pinned on the card);
    * ``init_state(hparams)`` -> host optimizer state ``{"step", "slots":
      {"embed", "blocks", "head"}}``, built one segment at a time on the
      device and parked before the next exists;
    * ``step(hparams, hstate, inputs, targets, lr) -> (hparams, hstate,
      loss)``; with ``donate=True`` the new parameters and moments are
      written into the same host buffers and the same trees come back.

    ``step.copier.stats`` holds the bytes each way of the last step; with
    ``step.copier.trace = True`` its copies and compute spans are timed
    (``_host.overlap_summary(step.copier.timeline, step.copier.origin)``).
    The optimizer must follow the per-leaf ``_init_slot`` / ``_update``
    protocol; ``ClipGradByGlobalNorm`` engages the two-pass backward,
    ``ClipGradByValue`` fuses into each update, other clips raise."""
    if not _leaf_streamable(optimizer):
        raise NotImplementedError(
            "param streaming updates each block the moment its grads exist; "
            "the optimizer must follow the per-leaf _init_slot/_update "
            f"protocol (AdamW-family). Got {type(optimizer).__name__} with "
            "a custom apply(); use build_sharded_train_step(offload=True).")
    if getattr(optimizer, "_needs_leaf_names", False):
        raise NotImplementedError(
            "name-dependent updates (apply_decay_param_fun / "
            "exclude_from_weight_decay) would see SEGMENT-relative names "
            "here (the per-block programs update subtrees, e.g. 'qkv_w' "
            "instead of 'blocks.3.qkv_w'), silently changing which "
            "parameters the filter matches. Use the moments-offload tier "
            "(build_sharded_train_step(offload=True) — threads full-tree "
            "names), or drop the name filter.")
    from ...nn.clip import (ClipGradByGlobalNorm, ClipGradByValue,
                            sum_squares)
    clip = optimizer._grad_clip
    global_clip = isinstance(clip, ClipGradByGlobalNorm)
    value_clip = isinstance(clip, ClipGradByValue)
    if clip is not None and not (global_clip or value_clip):
        raise NotImplementedError(
            "the streamed tier supports ClipGradByGlobalNorm (two-pass "
            "backward: norm pass then update pass) and ClipGradByValue "
            f"(fused per block). Got {type(clip).__name__}; drop grad_clip= "
            "or use the moments-only offload tier "
            "(build_sharded_train_step).")
    device = resolve_device(device)
    pinned = device.type == "cuda"
    copier = _host.Copier(device)

    def _seg_update(p, g, slot, lr, step, offset, scale):
        """One segment's update, in place: by-value clip clamps here, the
        global-norm coefficient scales here (the same expressions as the
        clips' own ``__call__``)."""
        if value_clip:
            g = _tree.tree_map(lambda t: None if t is None else
                               torch.clamp(t, clip.min, clip.max), g)
        if scale is not None:
            g = _tree.tree_map(lambda t: None if t is None else
                               (t * scale).to(t.dtype), g)
        optimizer._apply_leaves(p, g, slot, lr, step, offset=offset)

    # -- the five functions --------------------------------------------------
    def head_grads(hp, x, targets):
        hp_r, leaves = _with_grad(hp)
        x_r = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = head_loss_fn(hp_r, x_r, targets)
            gs = torch.autograd.grad(loss, leaves + [x_r], allow_unused=True)
        return loss.detach(), _grads_tree(hp, gs[:-1]), gs[-1]

    def block_grads(p, x_in, dx_out):
        p_r, leaves = _with_grad(p)
        x_r = x_in.detach().requires_grad_(True)
        with torch.enable_grad():
            out = block_fn(p_r, x_r)
            gs = torch.autograd.grad(out, leaves + [x_r], dx_out,
                                     allow_unused=True)
        return _grads_tree(p, gs[:-1]), gs[-1]

    def embed_grads(ep, inputs, dx):
        ep_r, leaves = _with_grad(ep)
        with torch.enable_grad():
            out = embed_fn(ep_r, inputs)
            gs = torch.autograd.grad(out, leaves, dx, allow_unused=True)
        return _grads_tree(ep, gs)

    # ------------------------------------------------------------------------
    def place(params):
        out = {"embed": copier.park_new(params["embed"]),
               "blocks": [copier.park_new(b) for b in params["blocks"]],
               "head": copier.park_new(params["head"])}
        copier.drain()
        return out

    def init_state(hparams):
        """Slots one segment at a time: fetch the segment's params, make
        its slots on the device, park them, release."""
        def seg_slots(seg):
            p = copier.fetch(seg).get()
            slots = _tree.tree_map(optimizer._init_slot, p)
            host = copier.park_new(slots)
            copier.drain()
            return host

        return {"step": 0,
                "slots": {"embed": seg_slots(hparams["embed"]),
                          "blocks": [seg_slots(b) for b in hparams["blocks"]],
                          "head": seg_slots(hparams["head"])}}

    def _target(seg):
        """Where a segment's update is parked: the same host buffer when
        donating, a new one of the same layout otherwise."""
        if donate:
            return seg
        if isinstance(seg, _host.Segment):
            return seg.like(pinned)
        return _tree.tree_map(lambda t: t.clone(), seg)

    @torch.no_grad()
    def step(hparams, hstate, inputs, targets, lr):
        blocks, slots = hparams["blocks"], hstate["slots"]
        L = len(blocks)
        # leaf-count offsets of the rounding seeds, counted per call
        n_embed = len(_tree.flatten(hparams["embed"]))
        n_block = len(_tree.flatten(blocks[0]))
        off_head = n_embed + L * n_block
        step_no = int(hstate["step"]) + 1
        lr = float(lr)
        inputs = inputs.to(device)
        targets = targets.to(device)
        copier.reset()
        new_blocks, new_block_s = [None] * L, [None] * L

        # ---- forward: stream the blocks down, cache the boundaries ----
        ep = copier.fetch(hparams["embed"])
        nxt = copier.fetch(blocks[0])
        with copier.compute("embed_fwd"):
            x = embed_fn(ep.get(), inputs)
        del ep
        x_ins = []
        for i in range(L):
            p_i = nxt.get()
            nxt = copier.fetch(blocks[i + 1]) if i + 1 < L else None
            x_ins.append(x)
            with copier.compute("block_fwd"):
                x = block_fn(p_i, x)
            del p_i

        # ---- pass 1 (global-norm clip): an update-free backward over the
        # same boundaries, accumulating the fp32 norm^2 ----
        scale = None
        if global_clip:
            hp = copier.fetch(hparams["head"])
            nxt = copier.fetch(blocks[L - 1])
            with copier.compute("head_norm"):
                _, dhp, dxn = head_grads(hp.get(), x, targets)
                n2 = sum_squares(dhp)
            del hp, dhp
            for i in range(L - 1, -1, -1):
                p_i = nxt.get()
                nxt = copier.fetch(blocks[i - 1]) if i > 0 else None
                with copier.compute("block_norm"):
                    dp, dxn = block_grads(p_i, x_ins[i], dxn)
                    n2 = n2 + sum_squares(dp)
                del p_i, dp
            ep = copier.fetch(hparams["embed"])
            with copier.compute("embed_norm"):
                n2 = n2 + sum_squares(embed_grads(ep.get(), inputs, dxn))
                scale = clip.scale_from_norm(torch.sqrt(n2))
            del ep, dxn

        # ---- head: loss, gradients and update ----
        hp, hs = copier.fetch(hparams["head"]), copier.fetch(slots["head"])
        nxt = (copier.fetch(blocks[L - 1]),
               copier.fetch(slots["blocks"][L - 1]))
        hp, hs = hp.get(), hs.get()
        with copier.compute("head_step"):
            loss, dhp, dx = head_grads(hp, x, targets)
            _seg_update(hp, dhp, hs, lr, step_no, off_head, scale)
        new_head = copier.park(hp, _target(hparams["head"]))
        new_head_s = copier.park(hs, _target(slots["head"]))
        del hp, hs, dhp, x

        # ---- backward: stream the blocks up, each updated the moment its
        # gradients exist ----
        for i in range(L - 1, -1, -1):
            p_i, s_i = nxt[0].get(), nxt[1].get()
            nxt = ((copier.fetch(blocks[i - 1]),
                    copier.fetch(slots["blocks"][i - 1])) if i > 0
                   else (copier.fetch(hparams["embed"]),
                         copier.fetch(slots["embed"])))
            with copier.compute("block_step"):
                dp, dx = block_grads(p_i, x_ins.pop(), dx)
                _seg_update(p_i, dp, s_i, lr, step_no, n_embed + i * n_block,
                            scale)
            new_blocks[i] = copier.park(p_i, _target(blocks[i]))
            new_block_s[i] = copier.park(s_i, _target(slots["blocks"][i]))
            del p_i, s_i, dp

        ep, es = nxt[0].get(), nxt[1].get()
        with copier.compute("embed_step"):
            dep = embed_grads(ep, inputs, dx)
            _seg_update(ep, dep, es, lr, step_no, 0, scale)
        new_embed = copier.park(ep, _target(hparams["embed"]))
        new_embed_s = copier.park(es, _target(slots["embed"]))
        del ep, es, dep, dx
        copier.drain()
        new_p = {"embed": new_embed, "blocks": new_blocks, "head": new_head}
        new_s = {"step": step_no,
                 "slots": {"embed": new_embed_s, "blocks": new_block_s,
                           "head": new_head_s}}
        if donate:
            hstate.update(new_s)
            new_s = hstate
        return new_p, new_s, loss

    step.copier = copier
    return place, init_state, step
