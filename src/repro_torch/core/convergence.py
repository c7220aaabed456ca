"""Convergence tracking (Fig. 4 / Theorem 1 empirical counterpart)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CostHistory:
    """Per-round global training cost, with the paper's observed behaviour
    checks: cost stabilizes after enough rounds; the first 2 rounds may be
    slow because ternary direction info only becomes correct at round 3."""
    costs: list = field(default_factory=list)

    def append(self, cost: float) -> None:
        self.costs.append(float(cost))

    def converged(self, window: int = 5, tol: float = 1e-3) -> bool:
        if len(self.costs) < window + 1:
            return False
        recent = np.asarray(self.costs[-window:])
        return float(np.max(recent) - np.min(recent)) < tol * max(
            1.0, abs(float(np.mean(recent))))

    def monotone_fraction(self) -> float:
        """Fraction of rounds where cost did not increase — a soft empirical
        convergence signal (strict monotonicity is not guaranteed by Thm 1)."""
        if len(self.costs) < 2:
            return 1.0
        c = np.asarray(self.costs)
        return float(np.mean(c[1:] <= c[:-1] + 1e-12))

    def total_reduction(self) -> float:
        if len(self.costs) < 2:
            return 0.0
        return self.costs[0] - self.costs[-1]
