"""Goodness function — Eq. (1) of the paper::

    G_k^t = S_k / C_k^t                  if t == 1
    G_k^t = S_k (C_k^{t-1} - C_k^t)      if t  > 1

The argmax is the round's pilot k*. ``t`` may be a device tensor: the
branch is a ``torch.where``, and ``k_star`` stays on the device.
"""
from __future__ import annotations

import torch


def goodness(costs: torch.Tensor, prev_costs: torch.Tensor,
             sizes: torch.Tensor, t,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. (1). Returns (N,) float32 scores.

    Non-participants (``mask == 0``) score ``-inf``. A worker with no cost
    history (``prev_cost == +inf``) scores by the round-1 rule ``S_k/C_k``
    instead of the degenerate ``S_k·(inf − C_k) = inf``.
    """
    sizes, costs, prev_costs = sizes.float(), costs.float(), prev_costs.float()
    g1 = sizes / torch.clamp_min(costs, 1e-12)
    gt = torch.where(torch.isfinite(prev_costs), sizes * (prev_costs - costs),
                     g1)
    g = torch.where(torch.as_tensor(t, device=costs.device) <= 1, g1, gt)
    if mask is not None:
        g = torch.where(mask > 0, g, float("-inf"))
    return g


def select_pilot(costs: torch.Tensor, prev_costs: torch.Tensor,
                 sizes: torch.Tensor, t, mask: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (k_star, scores); ties go to the lowest index."""
    scores = goodness(costs, prev_costs, sizes, t, mask)
    return torch.argmax(scores), scores


def rotation_entropy(pilot_history: torch.Tensor,
                     n_workers: int) -> torch.Tensor:
    """Empirical entropy (nats) of the pilot choice over a window, a §4.2
    diagnostic: high means the master cannot keep polling one worker;
    near 0 is when the worker-side evasion rules should trigger."""
    counts = torch.bincount(pilot_history,
                            minlength=n_workers)[:n_workers].float()
    p = counts / torch.clamp_min(counts.sum(), 1.0)
    return -torch.where(p > 0, p * torch.log(p), 0.0).sum()
