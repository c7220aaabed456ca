"""Communication accounting of §3 — the Eq. (8) byte models.

Per round: every worker downloads the model (V each), the pilot uploads
its full model (V), the N−1 others upload 2-bit codes (V/16 each)::

    D = V (N + 1) + V (N - 1) / 16          (float32 weights)
"""
from __future__ import annotations

from repro_torch.utils import PyTree, tree_size


def _fedpc_wire_bytes(model_bytes: float, n_workers: int,
                      code_bits: float) -> float:
    """The Eq. (8) shape: V(N+1) download and pilot upload, plus N-1
    non-pilot uplinks at ``code_bits`` per float32 parameter."""
    ratio = 32 / code_bits
    return (model_bytes * (n_workers + 1)
            + model_bytes * (n_workers - 1) / ratio)


def fedpc_bytes_per_round(model_bytes: float, n_workers: int) -> float:
    """Eq. (8): D = V(N+1) + V(N-1)/16, float32 weights and 2-bit codes."""
    return _fedpc_wire_bytes(model_bytes, n_workers, 2.0)


def fedpc_masked_bytes_per_round(model_bytes: float, n_workers: int,
                                 word_bits: int = 32) -> float:
    """The secure-aggregation wire: each non-pilot uplink carries one
    masked word of ``word_bits`` (``PrivacySpec.modulus_bits``) per
    parameter, 8x the 2-bit codes at 16 bits, 16x at 32. Download and
    pilot upload are unchanged."""
    return _fedpc_wire_bytes(model_bytes, n_workers, float(word_bits))


def fedavg_bytes_per_round(model_bytes: float, n_workers: int) -> float:
    """FedAvg: every worker downloads and uploads the model."""
    return 2.0 * model_bytes * n_workers


def model_size_bytes(params: PyTree) -> int:
    """Size of a model instance on the wire (float32 weights, §5.2)."""
    return tree_size(params) * 4
