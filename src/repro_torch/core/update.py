"""Master update rule — Eq. (3) of the paper.

Given the pilot's full weights and the other workers' ternary codes, the
master forms the next global model::

    t == 1:  P^1 = Q_{k*}^1 - alpha_0 * sum_{k != k*} p_k T_k
    t  > 1:  P^t = Q_{k*}^t - sum_{k != k*} p_k beta_k T_k (P^{t-1} - P^{t-2})

where p_k = S_k / S is each worker's data share. The non-pilot
contribution nudges every parameter along (or against) the global model's
own previous step, scaled by how much data agrees with that direction.

Tensor-level reference semantics; ``repro_torch.kernels.master_update``
runs the t > 1 rule over codes stacked on a worker axis in one launch.
The round-1 rule has no kernel of its own and stays this plain function.
"""
from __future__ import annotations

import torch

from repro_torch.utils import PyTree, tree_map


def masked_weights(p_shares: torch.Tensor, betas: torch.Tensor,
                   k_star) -> torch.Tensor:
    """Per-worker coefficients p_k * beta_k with the pilot masked out."""
    n = p_shares.shape[0]
    keep = torch.arange(n, device=p_shares.device) != k_star
    return torch.where(keep, p_shares * betas, 0.0)


def master_update_round1(q_pilot: torch.Tensor, ternaries: torch.Tensor,
                         p_shares: torch.Tensor, k_star,
                         alpha0: float) -> torch.Tensor:
    """Eq. (3), t == 1: ``ternaries`` (N, *shape) int8; the pilot's row
    may hold anything, its weight is masked to 0."""
    n = p_shares.shape[0]
    keep = (torch.arange(n, device=p_shares.device) != k_star).float()
    contrib = torch.tensordot(keep * p_shares, ternaries.float(), dims=1)
    return (q_pilot.float() - alpha0 * contrib).to(q_pilot.dtype)


def master_update(q_pilot: torch.Tensor, ternaries: torch.Tensor,
                  p_shares: torch.Tensor, betas: torch.Tensor, k_star,
                  p_prev: torch.Tensor, p_prev2: torch.Tensor
                  ) -> torch.Tensor:
    """Eq. (3), t > 1: ``ternaries`` (N, *shape) int8."""
    w = masked_weights(p_shares, betas, k_star)
    coeff = torch.tensordot(w, ternaries.float(), dims=1)
    step = (p_prev - p_prev2).float()
    return (q_pilot.float() - coeff * step).to(q_pilot.dtype)


def master_update_tree(q_pilot: PyTree, ternaries: PyTree,
                       p_shares: torch.Tensor, betas: torch.Tensor, k_star,
                       p_prev: PyTree, p_prev2: PyTree, t,
                       alpha0: float = 0.01) -> PyTree:
    """Eq. (3) over a tree of leaves, both branches: ``ternaries`` a tree
    of (N, *leaf.shape) int8 stacks; ``t`` may be a device tensor, so both
    branches are computed and selected without a host sync."""
    def per_leaf(qp, tern, p1, p2):
        r1 = master_update_round1(qp, tern, p_shares, k_star, alpha0)
        rt = master_update(qp, tern, p_shares, betas, k_star, p1, p2)
        return torch.where(torch.as_tensor(t, device=r1.device) <= 1, r1,
                           rt)

    return tree_map(per_leaf, q_pilot, ternaries, p_prev, p_prev2)
