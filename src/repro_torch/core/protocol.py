"""FedPC wire protocol of §3: message types and communication accounting.

The master drives a synchronous round: every worker downloads the model
(V each) and reports its cost; the pilot uploads its full model (V); the
N−1 others upload 2-bit codes (V/16 each)::

    D = V (N + 1) + V (N - 1) / 16          (float32 weights)

:class:`CommLedger` books those bytes per party and round; the functions
below are the analytic byte models of Fig. 6.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.packing import packed_size
from repro_torch.core.tree import TreeSpec
from repro_torch.utils import PyTree, tree_bytes, tree_size


class Command(enum.Enum):
    SEND_MODEL = "SEND_MODEL"
    SEND_TERNARY = "SEND_TERNARY"


@dataclass(frozen=True)
class CostReport:
    """Worker -> master after local training: the only always-shared scalar."""
    worker_id: int
    round: int
    cost: float


@dataclass(frozen=True)
class ModelUpload:
    """Pilot worker -> master: full local model instance Q_{k*}^t."""
    worker_id: int
    round: int
    params: PyTree


@dataclass(frozen=True)
class TernaryUpload:
    """Non-pilot worker -> master: 2-bit packed evolution codes."""
    worker_id: int
    round: int
    packed: Any          # uint8 buffer
    layout: Any          # (structure, shapes): public architecture only


@dataclass
class CommLedger:
    """Byte accounting per round, per direction, per party."""
    downlink: list = field(default_factory=list)   # master -> workers
    uplink_model: list = field(default_factory=list)
    uplink_ternary: list = field(default_factory=list)

    def record_round(self, model_bytes: int, n_workers: int,
                     n_params: int) -> dict:
        down = model_bytes * n_workers
        up_model = model_bytes
        up_ternary = packed_size(n_params) * (n_workers - 1)
        self.downlink.append(down)
        self.uplink_model.append(up_model)
        self.uplink_ternary.append(up_ternary)
        return {"downlink": down, "uplink_model": up_model,
                "uplink_ternary": up_ternary,
                "total": down + up_model + up_ternary}

    def total(self) -> int:
        return (sum(self.downlink) + sum(self.uplink_model)
                + sum(self.uplink_ternary))


def _fedpc_wire_bytes(model_bytes: float, n_workers: int, code_bits: float,
                      weight_bits: int = 32) -> float:
    """The Eq. (8) shape: V(N+1) download and pilot upload, plus N-1
    non-pilot uplinks at ``code_bits`` per parameter
    (R = weight_bits / code_bits)."""
    ratio = weight_bits / code_bits
    return (model_bytes * (n_workers + 1)
            + model_bytes * (n_workers - 1) / ratio)


def fedpc_bytes_per_round(model_bytes: float, n_workers: int,
                          weight_bits: int = 32) -> float:
    """Eq. (8): D = V(N+1) + V(N-1)/R with R = weight_bits / 2 (2-bit
    codes): R = 16 for the paper's float32 weights, 8 for 16-bit ones."""
    return _fedpc_wire_bytes(model_bytes, n_workers, 2.0, weight_bits)


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


def phong_bytes_per_round(model_bytes: float, n_workers: int) -> float:
    """Phong et al. (sequential weight transmission): the same 2VN per
    epoch as FedAvg, as the paper's Fig. 6 counts it."""
    return 2.0 * model_bytes * n_workers


def reduction_vs_fedavg(model_bytes: float, n_workers: int,
                        weight_bits: int = 32) -> float:
    """Fraction of FedAvg's bytes that FedPC saves (paper: 31.25% at N = 3
    up to 42.20% at N = 10, float32 weights)."""
    fp = fedpc_bytes_per_round(model_bytes, n_workers, weight_bits)
    fa = fedavg_bytes_per_round(model_bytes, n_workers)
    return 1.0 - fp / fa


def model_size_bytes(params: PyTree, force_itemsize: int | None = 4) -> int:
    """Size of a model instance on the wire: float32 weights by default, as
    the paper counts them (§5.2); ``force_itemsize=None`` sums the leaves'
    in-memory dtypes instead."""
    if force_itemsize is None:
        return tree_bytes(params)
    return tree_size(params) * force_itemsize
