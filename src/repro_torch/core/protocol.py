"""Communication accounting of §3 — the Eq. (8) byte models.

Per round: every worker downloads the model (V each), the pilot uploads
its full model (V), the N−1 others upload 2-bit codes (V/16 each)::

    D = V (N + 1) + V (N - 1) / 16          (float32 weights)
"""
from __future__ import annotations

from repro_torch.utils import PyTree, tree_size


def fedpc_bytes_per_round(model_bytes: float, n_workers: int) -> float:
    """Eq. (8): D = V(N+1) + V(N-1)/16, float32 weights and 2-bit codes."""
    return model_bytes * (n_workers + 1) + model_bytes * (n_workers - 1) / 16.0


def fedavg_bytes_per_round(model_bytes: float, n_workers: int) -> float:
    """FedAvg: every worker downloads and uploads the model."""
    return 2.0 * model_bytes * n_workers


def model_size_bytes(params: PyTree) -> int:
    """Size of a model instance on the wire (float32 weights, §5.2)."""
    return tree_size(params) * 4
