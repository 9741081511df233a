"""Learning-rate schedules, stepped once per epoch (copy of
pointstowood_tpu/train/schedule.py, pure Python).

The reference steps its schedulers per *epoch*, not per batch
(reference: pointstowood/src/trainer.py:123,219): OneCycleLR is built with
``total_steps=num_epochs``, and CosineAnnealingWarmupRestarts (the --tune
path, trainer.py:120) likewise advances per epoch. Both are reimplemented
here as pure functions of the 0-based epoch step so training state stays
functional.
"""

from __future__ import annotations

import math


def onecycle_cos_lr(
    step: int,
    *,
    max_lr: float = 1e-4,
    total_steps: int,
    pct_start: float = 0.05,
    div_factor: float = 100.0,
    final_div_factor: float = 1e4,
) -> float:
    """torch.optim.lr_scheduler.OneCycleLR with anneal_strategy='cos'.

    Matches torch's phase math: warmup from initial_lr = max_lr/div_factor
    to max_lr over [0, pct_start*total_steps - 1], then cosine anneal to
    min_lr = initial_lr/final_div_factor by step total_steps - 1.
    """
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    warmup_end = float(pct_start * total_steps) - 1.0
    final_end = float(total_steps) - 1.0
    step = min(float(step), final_end)

    def _cos_anneal(start, end, pct):
        return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))

    if warmup_end <= 0:
        if step <= 0:
            return max_lr if warmup_end == 0 else initial_lr
        return _cos_anneal(max_lr, min_lr, step / final_end if final_end > 0 else 1.0)
    if step <= warmup_end:
        return _cos_anneal(initial_lr, max_lr, step / warmup_end)
    return _cos_anneal(max_lr, min_lr, (step - warmup_end) / (final_end - warmup_end))


def cosine_warmup_restarts_lr(
    step: int,
    *,
    first_cycle_steps: int,
    max_lr: float = 1e-6,
    min_lr: float = 1e-8,
    warmup_steps: int = 5,
    gamma: float = 0.5,
    cycle_mult: float = 1.0,
) -> float:
    """CosineAnnealingWarmupRestarts (reference cosine_scheduler.py:5-88)
    with cycle_mult == 1 (the only configuration the trainer uses,
    trainer.py:120). ``step`` counts scheduler.step() calls: the reference
    initializes at step_in_cycle = -1 (lr = min_lr) and the first step()
    moves to 0.

    step < 0 returns min_lr (the pre-first-step value).
    """
    if cycle_mult != 1.0:
        raise ValueError("reference only uses cycle_mult=1")
    if first_cycle_steps <= 0:
        return min_lr
    if step < 0:
        return min_lr
    cycle = step // first_cycle_steps
    step_in_cycle = step % first_cycle_steps
    cur_max = max_lr * (gamma**cycle)
    if step_in_cycle < warmup_steps:
        return (cur_max - min_lr) * step_in_cycle / warmup_steps + min_lr
    return min_lr + (cur_max - min_lr) * (
        1.0
        + math.cos(
            math.pi * (step_in_cycle - warmup_steps) / (first_cycle_steps - warmup_steps)
        )
    ) / 2.0
