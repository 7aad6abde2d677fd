"""Learning-rate schedulers (parity: MXNet's ``mx.lr_scheduler``).

Counterpart of the JAX package's ``lr_scheduler.py``, with the same
classes and semantics: a scheduler maps ``num_update`` to a learning rate
on the host, with linear or constant warm-up.  The optimizer reads it at
every update (``Optimizer.learning_rate``); the fused update hands the
value to the multi-tensor kernel through device memory, so a changing rate
never rebuilds anything.

As in the reference, ``warmup_final_lr`` is fixed at construction, while
``Optimizer.__init__`` later overwrites ``base_lr`` with its own learning
rate: the warm-up then ramps towards the scheduler's ``base_lr`` and the
schedule after it starts from the optimizer's.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler", "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode
        if warmup_begin_lr > base_lr:
            raise ValueError("base lr must be larger than warmup_begin_lr")

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) * num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        raise ValueError(self.warmup_mode)

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(step, list) and len(step) >= 1
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            frac = 1 - (num_update - self.warmup_steps) / self.max_steps
            self.base_lr = self.final_lr + (self.base_lr_orig - self.final_lr) * frac ** self.power
        return self.base_lr


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            frac = (num_update - self.warmup_steps) / self.max_steps
            self.base_lr = self.final_lr + (self.base_lr_orig - self.final_lr) * (
                1 + math.cos(math.pi * frac)
            ) / 2
        return self.base_lr
