"""Communication accounting of §3 — the Eq. (8) byte models.

Per round: every worker downloads the model (V each), the pilot uploads
its full model (V), the N−1 others upload 2-bit codes (V/16 each)::

    D = V (N + 1) + V (N - 1) / 16          (float32 weights)
"""
from __future__ import annotations

from repro_torch.core.tree import TreeSpec
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


def fedpc_tree_bytes_per_round(model_bytes: float, n_workers: int,
                               fanout: int, *, levels: int | None = None,
                               word_bits: int | None = None) -> float:
    """Eq. (8) under hierarchical fan-in aggregation: ``V(N+1)`` download
    and pilot upload; the N-1 non-pilot leaf uplinks carry 2-bit codes on
    the plain tree (``word_bits=None``) or ``word_bits``-wide masked words;
    each interior level l moves ``w_l`` partials of one integer word per
    parameter (uint32 on the plain tree, ``word_bits`` on the masked one)."""
    ts = TreeSpec(fanout=fanout, levels=levels)
    leaf_bits = 2.0 if word_bits is None else float(word_bits)
    interior_bits = 32.0 if word_bits is None else float(word_bits)
    total = model_bytes * (n_workers + 1)
    total += model_bytes * (n_workers - 1) * leaf_bits / 32.0
    for w_l in ts.level_widths(n_workers)[1:]:
        total += model_bytes * w_l * interior_bits / 32.0
    return total


def recovery_dealing_bytes_per_round(n_workers: int,
                                     group_size: int | None = None) -> float:
    """Dropout-recovery dealing per round: each worker deals one Shamir
    share of its ``group_size - 1`` within-group pair seeds (4 bytes each)
    to each of its ``group_size - 1`` siblings, ``n (g - 1)^2 · 4`` bytes.
    ``group_size=None`` is the flat wire: one cohort-wide group."""
    g = n_workers if group_size is None else group_size
    return float(n_workers) * (g - 1) ** 2 * 4.0


def recovery_reconstruction_bytes(n_deaths: int, threshold: int,
                                  group_size: int | None = None, *,
                                  n_workers: int | None = None) -> float:
    """Dropout-recovery reconstruction: per post-uplink death,
    ``threshold`` surviving siblings each upload their 4-byte-per-seed
    share of the dead worker's ``group_size - 1`` seeds."""
    if group_size is None:
        if n_workers is None:
            raise ValueError("flat-wire reconstruction needs n_workers")
        group_size = n_workers
    return float(n_deaths) * threshold * (group_size - 1) * 4.0


def fedavg_bytes_per_round(model_bytes: float, n_workers: int) -> float:
    """FedAvg: every worker downloads and uploads the model."""
    return 2.0 * model_bytes * n_workers


def model_size_bytes(params: PyTree) -> int:
    """Size of a model instance on the wire (float32 weights, §5.2)."""
    return tree_size(params) * 4
