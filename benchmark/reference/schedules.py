"""LR schedules (counterpart of `mot3d_tpu/train/schedules.py`).

The reference trains detection with detectron2's WarmupMultiStepLR
(`Detection/cfg_setup.py:109-114`): linear warmup from
`base_lr * warmup_factor` over `warmup_iters`, then a multiplicative `gamma`
drop at each milestone in `steps`.  Its shipped values (no warmup, no
milestones) make it a constant LR.
"""

from __future__ import annotations

from typing import Callable, Sequence


def warmup_multistep(base_lr: float, warmup_iters: int = 0,
                     warmup_factor: float = 1.0, steps: Sequence[int] = (),
                     gamma: float = 1.0) -> Callable[[int], float]:
    """count -> lr, where count is the number of updates already made (0 on
    the first update, as optax counts).  lr(t) = base * (warmup_factor +
    (1 - warmup_factor) * t / warmup_iters) for t < warmup_iters, times
    gamma ** (#milestones <= t).  As a `LambdaLR` factor it gives the LR
    itself when the optimizer's base LR is 1."""
    milestones = sorted(steps)

    def schedule(count: int) -> float:
        if warmup_iters > 0:
            alpha = min(max(float(count) / float(warmup_iters), 0.0), 1.0)
            warm = warmup_factor * (1.0 - alpha) + alpha
        else:
            warm = 1.0
        decay = gamma ** sum(int(count) >= m for m in milestones)
        return base_lr * warm * decay

    return schedule
