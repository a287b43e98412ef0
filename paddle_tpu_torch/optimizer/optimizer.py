"""Adam and AdamW over a dict of parameters (counterpart:
``paddle_tpu/optimizer/optimizer.py``: ``_sr_to_bf16``, ``_store_moment``,
the functional core of ``Optimizer``, ``Adam``, ``AdamW`` and
``_FUSED_TYPES``).

The JAX package's ``apply`` is pure and returns new trees; its Pallas Adam
kernel aliases the state buffers through. The port updates the parameter
tensors and the state IN PLACE under ``torch.no_grad()`` and returns the
same two dicts: ``params, state = opt.apply(params, grads, state)`` leaves
``params`` and ``state`` the very objects that were passed in.

Per leaf, ``Adam._update`` takes the one-pass CUDA kernel
(``kernels/fused_adam.py``) when the leaf is a CUDA tensor and the JAX
package's shape gate ``supported`` admits it (at least 65536 elements,
ndim >= 2); every other leaf, on the card or on the CPU, takes the composed
update ``_adam_core`` + ``_store_moment``, as the XLA path does on the TPU.
There is no switch that routes a CUDA leaf the gate admits away from the
kernel.

Stochastic rounding of bf16 moment2 (``FLAGS_bf16_stochastic_rounding_
moments``) draws from a per-leaf seed derived from ``(step, leaf index)``, as
the JAX package folds the leaf index into a key made from the step. The
kernel uses it as a Philox key; the composed path seeds a
``torch.Generator`` with it. Neither reproduces ``jax.random``'s bits.

Not in this slice, each raising NotImplementedError: ``use_multi_tensor=True``
and ``lazy_mode=True`` (ROADMAP Queue 1 item 2, what the training slice left
out), and the eager ``step()`` / ``clear_grad()`` surface over ``parameters``,
which needs ``Parameter`` (Queue 1 item 10).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..flags import flag
from ..kernels.fused_adam import adam_update, bias_corrections, sr_noise
from ..kernels.fused_adam import sr_to_bf16 as _sr_to_bf16
from ..kernels.fused_adam import supported as _fused_supported
from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW"]


def _store_moment(x, dtype, seed: Optional[Tuple[int, int]]):
    """A moment's store: stochastic rounding to bf16 under the flag when a
    seed is given, else a plain (round-to-nearest) cast."""
    if dtype == torch.bfloat16 and seed is not None \
            and flag("bf16_stochastic_rounding_moments"):
        return _sr_to_bf16(x, sr_noise(x.shape, seed, x.device))
    return x.to(dtype)


def _flatten_paths(tree, path=()):
    """(key path, leaf) pairs of a nested dict in the JAX pytree's leaf
    order (keys sorted), so leaf i is the JAX package's leaf i. A key may
    itself hold dots (a layer model's flat ``functional_train_graph`` tree:
    ``bert.encoder.layers.0.self_attn.q_proj.weight``), so leaves are found
    again by their path, never by splitting a name."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flatten_paths(v, path + (k,))
        else:
            out.append((path + (k,), v))
    return out


def _path_name(path):
    """The dot-joined name ``apply_decay_param_fun`` sees, as the JAX
    package's ``_path_name`` makes it."""
    return ".".join(str(k) for k in path)


def _flatten(tree):
    """(dot-joined name, leaf) pairs in the JAX pytree's leaf order."""
    return [(_path_name(p), v) for p, v in _flatten_paths(tree)]


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


class Optimizer:
    """Base optimizer: the functional core (``init_state`` / ``apply``).
    Subclasses implement ``_init_slot`` and ``_update``."""

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        del name
        if parameters is not None:
            raise _not_ported("the eager surface (parameters=, step(), "
                              "clear_grad())", 10)
        self._lr = learning_rate
        self._weight_decay = 0.0 if weight_decay is None else weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, lr: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = lr

    def _lr_step(self):
        if isinstance(self._lr, LRScheduler):
            self._lr.step()

    # -- functional core -----------------------------------------------------
    def _init_slot(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, p, g, slot, lr, step, seed=None):
        raise NotImplementedError

    _needs_update_rng = False
    # True when ``_leaf_ctx`` reads the leaf's full-tree name (an update
    # that runs on a subtree would see the wrong names)
    _needs_leaf_names = False

    def _leaf_ctx(self, name):
        del name
        return None

    def _update_ctx(self, ctx, p, g, slot, lr, step, seed=None):
        del ctx  # default: name-independent update
        return self._update(p, g, slot, lr, step, seed=seed)

    def init_state(self, params) -> Dict[str, Any]:
        """{"step": 0, "slots": a dict shaped like ``params`` whose leaves
        are slot dicts}, every slot tensor on its parameter's device."""
        def slots(tree):
            return {k: slots(v) if isinstance(v, dict) else self._init_slot(v)
                    for k, v in tree.items()}
        return {"step": 0, "slots": slots(params)}

    def _leaf_items(self, params, grads, slots, step, offset=None):
        """[(p, g or None, slot, ctx, seed or None), ...] in the tree's
        order. The stochastic-rounding seed of leaf i at ``step`` is
        ``(step, i)``: deterministic, distinct per leaf and per step.
        ``offset`` rebases the leaf index, ``(step, offset + i)``, when one
        update is split over several calls (the JAX package's ``offset``)."""
        items = []
        for i, (path, p) in enumerate(_flatten_paths(params)):
            g = _lookup(grads, path)
            slot = _lookup(slots, path)
            idx = i if offset is None else offset + i
            seed = (step, idx) if (self._needs_update_rng
                                   and g is not None) else None
            ctx = self._leaf_ctx(_path_name(path)) if g is not None else None
            items.append((p, g, slot, ctx, seed))
        return items

    def _apply_leaves(self, params, grads, slots, lr, step, offset=None):
        for p, g, s, ctx, seed in self._leaf_items(params, grads, slots,
                                                    step, offset=offset):
            if g is not None:
                self._update_ctx(ctx, p, g, s, lr, step, seed=seed)

    @torch.no_grad()
    def apply(self, params, grads, state, lr=None):
        """One step, in place: advances ``state["step"]`` and updates every
        parameter with a gradient and its slot. Returns ``(params,
        state)``, the same objects."""
        lr = self.get_lr() if lr is None else float(lr)
        step = int(state["step"]) + 1
        if self._grad_clip is not None:
            grads = self._grad_clip(grads)
        self._apply_leaves(params, grads, state["slots"], lr, step)
        state["step"] = step
        return params, state

    def step(self):
        raise _not_ported("the eager step() over parameters", 10)

    def clear_grad(self):
        raise _not_ported("the eager clear_grad() over parameters", 10)

    # -- weight decay helpers ------------------------------------------------
    def _decay_coeff(self) -> float:
        wd = self._weight_decay
        return 0.0 if wd is None else float(wd)

    def _apply_l2(self, g, p):
        """L2 regularization folded into the gradient (``weight_decay`` on
        non-AdamW optimizers)."""
        wd = self._decay_coeff()
        if wd:
            return g + wd * p
        return g


class Adam(Optimizer):
    """moment_dtype: storage dtype of moment1 / moment2 (default fp32); the
    update always runs in fp32 and rounds the moments on store.
    multi_precision: an fp32 ``master`` slot for non-fp32 parameters."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 moment_dtype=None, use_multi_tensor=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        if use_multi_tensor:
            raise _not_ported("use_multi_tensor=True (the multi-tensor Adam "
                              "pass)", 2)
        if lazy_mode:
            raise _not_ported("lazy_mode=True (LazyAdam row updates)", 2)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._moment_dtype = moment_dtype
        # low-precision EMA stores need stochastic rounding (_sr_to_bf16)
        self._needs_update_rng = (moment_dtype is not None
                                  and moment_dtype != torch.float32)

    def _init_slot(self, p):
        z = torch.zeros_like(p, dtype=self._moment_dtype or torch.float32)
        slot = {"moment1": z, "moment2": z.clone()}
        if self._multi_precision and p.dtype != torch.float32:
            slot["master"] = p.float()
        return slot

    def _decoupled_decay(self, p, lr):
        return 0.0

    def _adam_core(self, pf, gf, m1_prev, m2_prev, lr, step):
        """The EMA and the bias-corrected update, in fp32, with the bias
        corrections 1 - beta^step computed in float32 as the JAX package
        does."""
        m1 = self._beta1 * m1_prev + (1 - self._beta1) * gf
        m2 = self._beta2 * m2_prev + (1 - self._beta2) * torch.square(gf)
        c1, c2 = bias_corrections(self._beta1, self._beta2, step)
        upd = (m1 / c1) / (torch.sqrt(m2 / c2) + self._epsilon)
        new_pf = pf - lr * upd - self._decoupled_decay(pf, lr)
        return new_pf, m1, m2

    def _fused_coeffs(self):
        """(l2_into_grad, decoupled) decay coefficients for the fused
        kernel; they mirror _apply_l2 / _decoupled_decay exactly."""
        return self._decay_coeff(), 0.0

    def _update(self, p, g, slot, lr, step, seed=None):
        if type(self) in _FUSED_TYPES and p.is_cuda \
                and _fused_supported(p, g, slot):
            sr_seed = seed if (seed is not None and flag(
                "bf16_stochastic_rounding_moments")) else None
            l2c, decc = self._fused_coeffs()
            adam_update(p, g, slot, lr, step, sr_seed, beta1=self._beta1,
                        beta2=self._beta2, epsilon=self._epsilon, l2=l2c,
                        decoupled=decc)
            return
        gf = g.float()
        master = slot.get("master")
        pf = master if master is not None else p.float()
        gf = self._apply_l2(gf, pf) if type(self) is Adam else gf
        new_pf, m1, m2 = self._adam_core(
            pf, gf, slot["moment1"].float(), slot["moment2"].float(), lr,
            step)
        # only moment2 needs stochastic rounding: its per-step relative
        # update (1 - beta2 ~ 1e-3) is below bf16's ulp, moment1's is not
        slot["moment1"].copy_(m1)
        slot["moment2"].copy_(_store_moment(m2, slot["moment2"].dtype, seed))
        if master is not None:
            master.copy_(new_pf)
        p.copy_(new_pf)


class AdamW(Adam):
    """Adam with decoupled weight decay. ``apply_decay_param_fun(name)``
    decides per parameter (dot-joined dict path) whether it decays."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, moment_dtype=None,
                 use_multi_tensor=None, name=None, **kw):
        if lr_ratio is not None:
            raise _not_ported("lr_ratio", 2)
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         moment_dtype, use_multi_tensor, name)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._ctx_decay: Optional[bool] = None

    def _decoupled_decay(self, p, lr):
        if self._ctx_decay is False:
            return 0.0
        return lr * self._decay_coeff() * p

    @property
    def _needs_leaf_names(self):
        return self._apply_decay_param_fun is not None

    def _fused_coeffs(self):
        # _decoupled_decay(p=1, lr=1) IS the scalar coefficient: one
        # implementation of the decay filter, not two
        return 0.0, float(self._decoupled_decay(1.0, 1.0))

    def _leaf_ctx(self, name):
        fn = self._apply_decay_param_fun
        if fn is None:
            return None
        return bool(fn(name)) if name is not None else True

    def _update_ctx(self, ctx, p, g, slot, lr, step, seed=None):
        prev = self._ctx_decay
        self._ctx_decay = ctx
        try:
            return super()._update_ctx(ctx, p, g, slot, lr, step, seed=seed)
        finally:
            self._ctx_decay = prev


# the exact Adam/AdamW math: the types whose leaves may take the fused kernel
_FUSED_TYPES = (Adam, AdamW)
