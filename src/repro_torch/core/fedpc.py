"""FedPC configuration — the public protocol scalars of Algorithms 1 & 2,
and the optional axes of the round: the privacy wire, a fan-in
aggregation tree and a fault schedule.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.tree import TreeSpec
from repro_torch.fed.faults import FaultPlan
from repro_torch.privacy.spec import PrivacySpec


@dataclass(frozen=True)
class FedPCConfig:
    n_workers: int
    alpha0: float = 0.01          # master lr for the round-1 rule of Eq. (3)
    beta: float = 0.2             # significance threshold of Eq. (5)
    alpha_round1: float = 0.01    # Eq. (4) threshold (worker lr at round 1)
    betas: tuple | None = None    # per-worker beta_k; None = uniform
    participation: float = 1.0    # C-fraction of workers per round
    privacy: PrivacySpec | None = None  # secure-agg / local-DP wire
    renorm_shares: bool = False   # Eq. (3) shares renormalized over sampled set
    tree: TreeSpec | None = None  # hierarchical fan-in aggregation tree
    faults: FaultPlan | None = None  # deterministic fault schedule

    def __post_init__(self):
        if self.betas is not None and len(self.betas) != self.n_workers:
            raise ValueError(
                f"betas has {len(self.betas)} entries for "
                f"{self.n_workers} workers")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}")

    def beta_vector(self, device) -> torch.Tensor:
        """(N,) per-worker beta_k — ``betas`` when set, else uniform."""
        if self.betas is not None:
            return torch.tensor(self.betas, dtype=torch.float32,
                                device=device)
        return torch.full((self.n_workers,), self.beta, dtype=torch.float32,
                          device=device)
