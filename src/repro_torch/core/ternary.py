"""Ternarization of parameter evolution — Eq. (4) and Eq. (5) of the paper.

Round 1 (Eq. 4), against the public init ``P^0`` with threshold ``alpha``::

    T = -1 if Q - P0 < -alpha;  0 if |Q - P0| <= alpha;  +1 if Q - P0 > alpha

Round t >= 2 (Eq. 5), against the global model's own last step::

    T = 0 if |Q - P1| < beta |P1 - P2|, else sign((Q - P1) (P1 - P2))

Elementwise over tensors of any shape: the reference semantics that the
wire kernels in ``repro_torch.kernels`` must reproduce bit for bit.
"""
from __future__ import annotations

import torch

TERNARY_DTYPE = torch.int8


def ternarize_round1(q: torch.Tensor, p0: torch.Tensor,
                     alpha: float) -> torch.Tensor:
    """Eq. (4): ternary code for the first round, vs. the initial model."""
    d = (q - p0).float()
    return (d > alpha).to(TERNARY_DTYPE) - (d < -alpha).to(TERNARY_DTYPE)


def ternarize(q: torch.Tensor, p_prev: torch.Tensor, p_prev2: torch.Tensor,
              beta) -> torch.Tensor:
    """Eq. (5): ternary code from round 2 onward, vs. the model history.
    The sign is taken of the product, so an underflowing product gives 0."""
    q, p1, p2 = q.float(), p_prev.float(), p_prev2.float()
    step = p1 - p2
    delta = q - p1
    significant = delta.abs() >= beta * step.abs()
    return torch.where(significant, torch.sign(delta * step),
                       0.0).to(TERNARY_DTYPE)
