"""Learning-rate schedules (pure functions of the step counter).

The port's copy of ``repro/optim/schedules.py``.  A schedule takes the
step as an int or an integer tensor and returns a float32 0-d tensor on
the step's device (the CPU for an int), computed in float32 as the
reference computes it, so a train step never reads the step on the host.

One difference: the cosine is evaluated in float64 and rounded once to
float32, the correctly rounded value.  The reference's float32 ``jnp.cos``
(on the CPU, glibc's ``cosf``) is within 1 ulp of it but not always equal,
and ``torch.cos`` in float32 is neither, so ``warmup_cosine`` equals the
reference's exactly on the warmup and floor stretches and within 1 ulp on
the cosine.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = step / max(1.0, float(warmup_steps))
        t = (step - warmup_steps) / max(1.0, float(total_steps - warmup_steps))
        t = t.clamp(0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (
            1 + torch.cos((math.pi * t).to(torch.float64)).to(torch.float32))
        peak = torch.full((), peak_lr, dtype=torch.float32, device=step.device)
        return peak * torch.where(step < warmup_steps, warm, cos)
    return f
