"""PrivacySpec — the one config object of the privacy-preserving wire.

* **Pairwise-masked secure aggregation** (``secure_agg``): every worker
  adds a per-round additive mask to its fixed-point-weighted ternary
  fields before they leave it; the masks sum to zero over the cohort, so
  the master recovers exactly ``sum_k W_k field_k`` mod 2**modulus_bits
  and never one worker's directions. ``mask_seed=None`` keeps the integer
  wire but adds no mask, which gives the same bits (cancellation is exact).
* **Local-DP ternary randomized response** (``dp_epsilon``): each 2-bit
  code is replaced, with probability ``flip_prob``, by a uniform draw from
  {-1, 0, +1}; the master divides by ``1 - flip_prob`` so the expected
  update is the noiseless one.
* **Accounting / enforcement**: ``delta`` sets the advanced-composition
  read-out of ``PrivacyAccountant``; ``enforce`` (the default) has both
  FedPC drivers audit their round program once, on ``meta`` tensors,
  before round 1 (``privacy.audit.check_round_program``); a violation
  raises ``LeakageError`` before any round runs.

Fixed point: worker ``k`` scales its fields by ``W_k = round(w_k
2**fixpoint_bits)`` and the master multiplies the de-biased integer sum by
``2**-fixpoint_bits``. ``modulus_bits`` picks the wire word (16, the
default, or 32); ``fixpoint_bits`` defaults per modulus (14 or 24) so the
signed de-bias residue cannot wrap (``wrap_headroom_workers``).

A copy of the JAX package's ``repro.privacy.spec``, with ``word_dtype``
naming PyTorch's types.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

# The RR flip is drawn from the low 16 bits of a uint32, so the flip
# probability is realized on a 1/65536 grid.
RR_RESOLUTION = 1 << 16

# Largest per-round epsilon whose flip probability still rounds to a
# non-zero threshold (p = 3/(e^eps + 2) >= 0.5/65536).
MAX_DP_EPSILON = math.log(3.0 * RR_RESOLUTION / 0.5 - 2.0)

# Smallest epsilon whose flip probability rounds below 1.0 (at p == 1 the
# 1/(1-p) unbias is undefined).
MIN_DP_EPSILON = math.log(3.0 * RR_RESOLUTION / (RR_RESOLUTION - 0.5) - 2.0)

# Per-modulus fixed-point defaults and upper bounds: the de-bias residue
# |sum_k W_k code_k| <= sum_k W_k <= 2**fb + N/2 must stay under
# 2**(modulus_bits - 1) for the signed reinterpretation to be exact.
_FIXPOINT_DEFAULT = {16: 14, 32: 24}
_FIXPOINT_MAX = {16: 14, 32: 26}


@dataclass(frozen=True)
class PrivacySpec:
    """Configuration of the secure-aggregation + DP wire path."""
    secure_agg: bool = True        # pairwise-masked integer aggregation
    mask_seed: int | None = 0      # pairwise-seed root; None = masking off
    modulus_bits: int = 16         # wire word width: 16 (default) or 32
    fixpoint_bits: int | None = None  # weight scale 2**bits; None = default
    dp_epsilon: float | None = None  # per-round per-coordinate eps; None=off
    dp_seed: int = 1               # randomized-response bit stream root
    delta: float = 1e-5            # advanced-composition delta
    enforce: bool = True           # audit the runtime's round program
    recovery_threshold: int | None = None  # Shamir t for dropout recovery

    def __post_init__(self):
        if self.recovery_threshold is not None and self.recovery_threshold < 2:
            raise ValueError(
                f"recovery_threshold must be >= 2 (a 1-of-n dealing would "
                f"hand every sibling the dead worker's seeds outright), "
                f"got {self.recovery_threshold}")
        if self.modulus_bits not in (16, 32):
            raise ValueError(
                f"modulus_bits must be 16 or 32 (the wire word is one "
                f"uint16/uint32 per parameter), got {self.modulus_bits}")
        if self.fixpoint_bits is None:
            object.__setattr__(self, "fixpoint_bits",
                               _FIXPOINT_DEFAULT[self.modulus_bits])
        hi = _FIXPOINT_MAX[self.modulus_bits]
        if not 8 <= self.fixpoint_bits <= hi:
            raise ValueError(
                f"fixpoint_bits must be in [8, {hi}] for modulus_bits="
                f"{self.modulus_bits} (the signed de-bias residue "
                f"sum_k W_k code_k must stay under 2**{self.modulus_bits - 1}"
                f"), got {self.fixpoint_bits}")
        if self.dp_epsilon is not None:
            if not MIN_DP_EPSILON <= self.dp_epsilon <= MAX_DP_EPSILON:
                raise ValueError(
                    f"dp_epsilon must be in [{MIN_DP_EPSILON:.2e}, "
                    f"{MAX_DP_EPSILON:.2f}] (the RR threshold quantizes to "
                    f"1/{RR_RESOLUTION}; below the floor the flip "
                    f"probability rounds to 1 and the unbias is undefined), "
                    f"got {self.dp_epsilon}")
        if not 0.0 < self.delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")

    # -- derived switches ---------------------------------------------------

    @property
    def dp_on(self) -> bool:
        return self.dp_epsilon is not None

    @property
    def masking_on(self) -> bool:
        return self.secure_agg and self.mask_seed is not None

    @property
    def active(self) -> bool:
        """Whether the round must take the masked integer wire path."""
        return self.secure_agg or self.dp_on

    # -- randomized response ------------------------------------------------

    @property
    def rr_threshold(self) -> int:
        """uint16 flip threshold: flip when ``bits & 0xFFFF < threshold``,
        clamped to [1, 2**16 - 1]."""
        if not self.dp_on:
            return 0
        p = 3.0 / (math.exp(self.dp_epsilon) + 2.0)
        return min(RR_RESOLUTION - 1, max(1, round(p * RR_RESOLUTION)))

    @property
    def flip_prob(self) -> float:
        """The realized flip probability (threshold / 2**16)."""
        return self.rr_threshold / RR_RESOLUTION

    @property
    def eps_round(self) -> float:
        """Realized per-round per-coordinate epsilon, ``ln((3 - 2p) / p)``
        for the quantized flip probability ``p``."""
        if not self.dp_on:
            return 0.0
        p = self.flip_prob
        return math.log((3.0 - 2.0 * p) / p)

    # -- fixed-point weighting ----------------------------------------------

    @property
    def word_dtype(self) -> torch.dtype:
        """The wire word dtype of this modulus."""
        return torch.uint16 if self.modulus_bits == 16 else torch.uint32

    def wrap_headroom_workers(self) -> int:
        """The largest cohort that provably cannot wrap the signed de-bias
        residue: ``2**fb + N/2 < 2**(mb-1)``."""
        return 2 * ((1 << (self.modulus_bits - 1))
                    - (1 << self.fixpoint_bits)) - 1

    @property
    def scale(self) -> float:
        return float(1 << self.fixpoint_bits)

    @property
    def scale_mult(self) -> float:
        """The master's de-bias multiplier: the fixed-point descale (a
        power of two) with the RR unbias ``1/(1 - p)`` folded in."""
        return (1.0 / self.scale) / (1.0 - self.flip_prob)
