"""Learning-rate schedules.

The paper (§5.1): initial lr 0.01 for all workers with step decay driven
by the local dataset size, which makes worker lrs heterogeneous (and
private) after a few epochs.

Each schedule maps a step to a float32 lr, as the JAX package's do. A
step given as a tensor (the device step of ``Worker.scan_train``) gives a
0-d float32 tensor on its device, computed there with no host sync;
``step_decay`` given a Python int gives a host ``np.float32``.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step)


def constant(lr: float):
    def fn(step) -> torch.Tensor:
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.full((), lr, dtype=torch.float32, device=dev)
    return fn


def step_decay(lr0: float, decay: float = 0.5, every: int = 1000):
    """``lr0 * decay^(step // every)`` in float32; ``every`` derives from
    the worker's local dataset size, so it differs per worker. At the
    paper's decay of 0.5 every power is exact, so the host and the device
    forms give the same bits."""
    def fn(step):
        if isinstance(step, torch.Tensor):
            k = torch.div(step, every, rounding_mode="floor").float()
            return lr0 * torch.pow(decay, k)
        return np.float32(lr0) * np.float32(np.float32(decay)
                                            ** (step // every))
    return fn


def cosine_decay(lr0: float, total_steps: int, floor: float = 0.0):
    def fn(step) -> torch.Tensor:
        frac = torch.clamp(_steps(step) / max(total_steps, 1), 0.0, 1.0)
        return floor + 0.5 * (lr0 - floor) * (1 + torch.cos(math.pi * frac))
    return fn


def warmup_cosine(lr0: float, warmup: int, total_steps: int,
                  floor: float = 0.0):
    cos = cosine_decay(lr0, max(total_steps - warmup, 1), floor)

    def fn(step) -> torch.Tensor:
        s = _steps(step)
        w = torch.clamp(s / max(warmup, 1), max=1.0) * lr0
        return torch.where(s < warmup, w, cos(s - warmup))
    return fn
