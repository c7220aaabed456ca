"""Learning-rate schedules.

The paper (§5.1): initial lr 0.01 for all workers with step decay driven
by the local dataset size, which makes worker lrs heterogeneous (and
private) after a few epochs.
"""
from __future__ import annotations

import numpy as np


def step_decay(lr0: float, decay: float = 0.5, every: int = 1000):
    """``lr0 * decay^(step // every)`` in float32, as the JAX package
    computes it. ``step`` is the worker's host-side step count, so the lr
    is a host number and costs no device round trip."""
    def fn(step: int) -> np.float32:
        return np.float32(lr0) * np.float32(np.float32(decay)
                                            ** (step // every))
    return fn
