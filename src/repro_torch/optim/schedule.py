"""LR schedules: cosine decay with linear warmup (paper: 10% warmup).
Port of ``repro.optim.schedule``, evaluated on the host in float32 as the
reference evaluates it."""

from __future__ import annotations

import numpy as np


def cosine_warmup(peak_lr: float, total_steps: int, warmup_frac: float = 0.1,
                  final_frac: float = 0.0):
    warmup = max(int(total_steps * warmup_frac), 1)
    f32 = np.float32

    def lr(step) -> float:
        step = f32(step)
        if step < warmup:
            return float(f32(peak_lr) * step / f32(warmup))
        prog = np.clip((step - f32(warmup)) / f32(max(total_steps - warmup, 1)), f32(0), f32(1))
        cos = f32(final_frac * peak_lr) + f32((1 - final_frac) * peak_lr) * f32(0.5) * (
            f32(1.0) + np.cos(f32(np.pi) * prog))
        return float(cos)

    return lr
