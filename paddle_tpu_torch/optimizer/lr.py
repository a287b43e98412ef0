"""LR schedulers (counterpart: ``paddle_tpu/optimizer/lr.py``, a copy).

Host-side Python state (a step counter) producing a float lr, which the
optimizer's ``get_lr`` reads; nothing here touches a tensor. The JAX package's
module imports no JAX either, but the port keeps its own copy so that it never
imports ``paddle_tpu``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

__all__ = [
    "LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
    "InverseTimeDecay", "PolynomialDecay", "LinearWarmup", "ExponentialDecay",
    "MultiStepDecay", "StepDecay", "LambdaDecay", "ReduceOnPlateau",
    "CosineAnnealingDecay", "MultiplicativeDecay", "OneCycleLR", "CyclicLR",
    "LinearLR", "CosineAnnealingWarmRestarts",
]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = learning_rate
        self.step()

    def get_lr(self) -> float:
        raise NotImplementedError

    def step(self, epoch: Optional[int] = None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def __call__(self) -> float:
        return self.last_lr

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state):
        self.__dict__.update(state)

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1,
                 verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5
                * min(step ** -0.5, step * self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: List[int], values: List[float], last_epoch=-1,
                 verbose=False):
        self.boundaries = boundaries
        self.values = values
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * max(div, 1)
        else:
            step = min(step, decay_steps)
        frac = (1 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self.final_lr = learning_rate if not isinstance(learning_rate, LRScheduler) else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * self.last_epoch / self.warmup_steps + self.start_lr
        if self.lr_sched is not None:
            self.lr_sched.step(self.last_epoch - self.warmup_steps)
            return self.lr_sched()
        return self.final_lr


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = milestones
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda: Callable[[int], float],
                 last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        lr = self.base_lr
        for e in range(1, self.last_epoch + 1):
            lr *= self.lr_lambda(e)
        return lr


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_0, self.T_mult, self.eta_min = T_0, T_mult, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t, ti = self.last_epoch, self.T_0
        while t >= ti:
            t -= ti
            ti *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t / ti)) / 2


class LinearLR(LRScheduler):
    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = min(self.last_epoch, self.total_steps)
        factor = self.start_factor + (self.end_factor - self.start_factor) * t / self.total_steps
        return self.base_lr * factor


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr, self.epsilon = cooldown, min_lr, epsilon
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self._current = learning_rate
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return getattr(self, "_current", self.base_lr)

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            self.last_epoch += 1
            self.last_lr = self.get_lr()
            return
        m = float(metrics)
        if self.best is None or self._is_better(m):
            self.best = m
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self._current * self.factor, self.min_lr)
            if self._current - new_lr > self.epsilon:
                self._current = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        self.last_lr = self._current

    def _is_better(self, m):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return m < self.best * (1 - self.threshold)
            return m < self.best - self.threshold
        if self.threshold_mode == "rel":
            return m > self.best * (1 + self.threshold)
        return m > self.best + self.threshold


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3, anneal_strategy="cos",
                 three_phase=False, last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return start + (end - start) * pct

    def get_lr(self):
        t = min(self.last_epoch, self.total_steps)
        up = self.phase_pct * self.total_steps
        if t <= up:
            return self._interp(self.initial_lr, self.max_lr, t / max(up, 1))
        if self.three_phase:
            # phase 2: anneal back to initial_lr; phase 3: to end_lr
            down_end = 2 * up
            if t <= down_end:
                return self._interp(self.max_lr, self.initial_lr,
                                    (t - up) / max(up, 1))
            return self._interp(self.initial_lr, self.end_lr,
                                (t - down_end) / max(self.total_steps - down_end, 1))
        return self._interp(self.max_lr, self.end_lr,
                            (t - up) / max(self.total_steps - up, 1))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.step_up = step_size_up
        self.step_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.step_up + self.step_down
        cycle = self.last_epoch // total
        pos = self.last_epoch % total
        if pos < self.step_up:
            pct = pos / self.step_up
        else:
            pct = 1 - (pos - self.step_up) / self.step_down
        amp = (self.max_lr - self.base_lr) * pct
        if self.scale_fn is not None:
            arg = cycle + 1 if self.scale_mode == "cycle" else self.last_epoch
            amp *= self.scale_fn(arg)
        elif self.mode == "triangular2":
            amp /= 2 ** cycle
        elif self.mode == "exp_range":
            amp *= self.exp_gamma ** self.last_epoch
        return self.base_lr + amp
