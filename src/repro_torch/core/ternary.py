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

from repro_torch.utils import PyTree, tree_map

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


def ternarize_tree_round1(q: PyTree, p0: PyTree, alpha: float) -> PyTree:
    return tree_map(lambda a, b: ternarize_round1(a, b, alpha), q, p0)


def ternarize_tree(q: PyTree, p_prev: PyTree, p_prev2: PyTree,
                   beta) -> PyTree:
    return tree_map(lambda a, b, c: ternarize(a, b, c, beta), q, p_prev,
                    p_prev2)


def ternary_density(t: torch.Tensor) -> torch.Tensor:
    """Fraction of non-zero codes: how much signal a worker contributes
    (all-zero codes are the §4.2 evasion behaviour)."""
    return t.float().abs().mean()
