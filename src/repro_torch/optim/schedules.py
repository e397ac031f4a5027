"""Step-indexed learning-rate schedules (the JAX package's
``optim/schedules.py``).  A schedule maps the optimizer's step (an int,
1 at the first update) to a float, computed in fp32 as the reference
computes it."""

from __future__ import annotations

import numpy as np

_f = np.float32


def constant(value: float):
    return lambda step: float(_f(value))


def cosine_decay(peak: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        frac = np.clip(_f(step) / _f(max(total_steps, 1)), _f(0), _f(1))
        cos = _f(0.5) * (_f(1) + np.cos(_f(np.pi) * frac))
        # python scalars meet the fp32 value as the reference's weak
        # types do: computed in double, then rounded to fp32
        return float(_f(peak) * (_f(final_frac) + _f(1 - final_frac) * cos))
    return fn


def linear_warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(peak, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        if step <= warmup_steps:
            return float(_f(peak) * _f(step) / _f(max(warmup_steps, 1)))
        return cos(step - warmup_steps)
    return fn
