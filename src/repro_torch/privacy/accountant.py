"""PrivacyAccountant — per-round (eps, delta) composition on the device.

Four 0-d device tensors, carried in ``RoundState.accountant`` and updated
by ``round_step`` whenever the round's wire ran the DP mechanism, with no
host sync. Two read-outs of the same ledger:

* basic composition, ``eps_total = sum_t eps_t``;
* advanced composition (Dwork–Rothblum–Vadhan, heterogeneous form),
  ``sqrt(2 ln(1/delta) sum_t eps_t^2) + sum_t eps_t (e^{eps_t} - 1)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class PrivacyAccountant(NamedTuple):
    """Running per-coordinate (eps, delta) ledger over composed rounds."""
    spent_rounds: torch.Tensor   # int32 — rounds that ran the mechanism
    eps_sum: torch.Tensor        # float32 — sum_t eps_t
    eps_sq_sum: torch.Tensor     # float32 — sum_t eps_t^2
    eps_lin_sum: torch.Tensor    # float32 — sum_t eps_t (e^{eps_t} - 1)

    @classmethod
    def zero(cls, device=None) -> "PrivacyAccountant":
        def z(dtype):
            return torch.zeros((), dtype=dtype, device=device)
        return cls(spent_rounds=z(torch.int32), eps_sum=z(torch.float32),
                   eps_sq_sum=z(torch.float32), eps_lin_sum=z(torch.float32))

    def add(self, eps: float) -> "PrivacyAccountant":
        """Compose one round of a pure-eps mechanism; ``eps`` is rounded to
        float32 first, as the JAX package does."""
        e = torch.full((), eps, dtype=torch.float32,
                       device=self.eps_sum.device)
        return PrivacyAccountant(
            spent_rounds=self.spent_rounds + 1,
            eps_sum=self.eps_sum + e,
            eps_sq_sum=self.eps_sq_sum + e * e,
            eps_lin_sum=self.eps_lin_sum + e * (torch.exp(e) - 1.0))

    def epsilon(self, delta: float | None = None) -> torch.Tensor:
        """Total eps spent: basic composition when ``delta`` is None, the
        advanced-composition bound at ``delta`` otherwise."""
        if delta is None:
            return self.eps_sum
        return (torch.sqrt(2.0 * math.log(1.0 / delta) * self.eps_sq_sum)
                + self.eps_lin_sum)

    def best_epsilon(self, delta: float) -> torch.Tensor:
        """min(basic, advanced)."""
        return torch.minimum(self.epsilon(), self.epsilon(delta))
