"""FedPC configuration and the round as plain tensor math over trees —
Algorithms 1 & 2 of the paper.

:class:`FedPCConfig` holds the public protocol scalars and the optional
axes of the round: the privacy wire, a fan-in aggregation tree and a
fault schedule.

:func:`master_round` is the round over stacked trees (a leading worker
axis on every leaf), in plain PyTorch::

    k*        = argmax goodness(costs, prev_costs, sizes)    [Alg. 1 line 4]
    Q_pilot   = row k* of the stack                          [Alg. 1 line 5]
    T_k       = ternary(Q_k, P^{t-1}, P^{t-2}, beta_k)       [Alg. 1 line 6]
    P^t       = Eq. (3)                                      [Alg. 1 line 7]

It uses no flat buffer and no kernel, so it is the second oracle for the
round that ``fed.rounds.WirePath.round_step`` runs through the kernels.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.core.goodness import select_pilot
from repro_torch.core.ternary import (ternarize_tree, ternarize_tree_round1,
                                     ternary_density)
from repro_torch.core.tree import TreeSpec
from repro_torch.core.update import master_update_tree
from repro_torch.fed.faults import FaultPlan
from repro_torch.privacy.spec import PrivacySpec
from repro_torch.utils import PyTree, tree_leaves, tree_map, tree_zeros_like


@dataclass(frozen=True)
class FedPCConfig:
    n_workers: int
    alpha0: float = 0.01          # master lr for the round-1 rule of Eq. (3)
    beta: float = 0.2             # significance threshold of Eq. (5)
    alpha_round1: float = 0.01    # Eq. (4) threshold (worker lr at round 1)
    # Wire widths per ternary code and per weight, kept for the
    # reference's signature: no code of either package reads them. Eq. (8)
    # takes its width only as fedpc_bytes_per_round(weight_bits=).
    pack_bits: int = 2
    weight_bits: int = 32
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


class FedPCState(NamedTuple):
    """Master-side state between rounds (all public to every participant)."""
    params: PyTree            # P^{t-1} — current global model
    params_prev: PyTree       # P^{t-2} — needed by Eq. (3)/(5)
    prev_costs: torch.Tensor  # (N,) last-round worker costs, +inf at first
    round: torch.Tensor       # 0-d int32, 1-based round about to run


class WorkerResult(NamedTuple):
    """What worker k produces locally before any communication."""
    params: PyTree            # Q_k^t — stays on the worker unless pilot
    cost: torch.Tensor        # C_k^t — the only always-uploaded value


def init_state(params: PyTree, n_workers: int) -> FedPCState:
    """Round 1: P^{t-2} = 0 and every cost +inf, on the params' device."""
    dev = tree_leaves(params)[0].device
    return FedPCState(
        params=params,
        params_prev=tree_zeros_like(params),
        prev_costs=torch.full((n_workers,), float("inf"),
                              dtype=torch.float32, device=dev),
        round=torch.ones((), dtype=torch.int32, device=dev),
    )


def worker_ternary(cfg: FedPCConfig, local_params: PyTree,
                   state: FedPCState, beta=None) -> PyTree:
    """Alg. 2 line 8: Eq. (4) at round 1, Eq. (5) after. Both branches are
    computed and selected on the round, which may be a device tensor.
    ``beta`` (a float or a 0-d tensor) is the worker's own beta_k in place
    of ``cfg.beta``."""
    beta = cfg.beta if beta is None else beta
    t1 = ternarize_tree_round1(local_params, state.params, cfg.alpha_round1)
    # At round 1 params_prev is zeros; the selected branch ignores it.
    tt = ternarize_tree(local_params, state.params, state.params_prev, beta)
    pick = torch.as_tensor(state.round) <= 1
    return tree_map(lambda a, b: torch.where(pick.to(a.device), a, b), t1,
                    tt)


def master_round(cfg: FedPCConfig, state: FedPCState, stacked_params: PyTree,
                 costs: torch.Tensor, sizes: torch.Tensor
                 ) -> tuple[FedPCState, dict]:
    """Alg. 1 lines 3–8 over every worker's local model, stacked on a
    leading (N,) axis of each leaf. Returns (state', aux) with ``aux``
    holding ``k_star``, ``goodness`` and ``ternary_density``.

    The math needs only the pilot's row and everyone else's codes; the
    simulator enforces that split on the wire and books its bytes. Every
    worker's codes are computed here, each at its own beta_k, and the
    pilot's weight in Eq. (3) is zero.
    """
    k_star, scores = select_pilot(costs, state.prev_costs, sizes,
                                  state.round)
    betas = cfg.beta_vector(costs.device)
    n = costs.shape[0]
    per_worker = [worker_ternary(cfg, tree_map(lambda x: x[k],
                                               stacked_params),
                                 state, betas[k]) for k in range(n)]
    ternaries = tree_map(lambda *xs: torch.stack(xs), *per_worker)
    q_pilot = tree_map(lambda x: x[k_star], stacked_params)
    sizes = sizes.float()
    p_shares = sizes / sizes.sum()
    new_params = master_update_tree(
        q_pilot, ternaries, p_shares, betas, k_star, state.params,
        state.params_prev, state.round, cfg.alpha0)
    new_state = FedPCState(params=new_params, params_prev=state.params,
                           prev_costs=costs.float(), round=state.round + 1)
    density = torch.stack([ternary_density(l)
                           for l in tree_leaves(ternaries)]).mean()
    return new_state, {"k_star": k_star, "goodness": scores,
                       "ternary_density": density}


def fedpc_round(cfg: FedPCConfig):
    """``(state, stacked_params, costs, sizes) -> (state', aux)``: the
    counterpart of the JAX package's ``fedpc_round_jit``, bound to
    ``cfg`` and run eagerly (nothing is compiled)."""
    return functools.partial(master_round, cfg)
