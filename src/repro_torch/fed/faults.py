"""Deterministic fault injection for the federated round.

A :class:`FaultPlan` is a seeded, stateless description of the failure
axis: each round, each worker draws one fault code from a FAULT_DOMAIN
counter stream (the lowbias32 chain of every other stream here), so the
schedule is a function of ``(plan.seed, round, worker)`` alone and a
resumed run replays it.

* ``DROP_BEFORE`` — the worker dies before its uplink: no uplink bytes.
* ``DROP_AFTER`` — the worker dies after committing its masked uplink:
  its words arrived but leave the aggregate. Uplink bytes were spent.
* ``STRAGGLER`` — the uplink misses the round's timeout: discarded like a
  death, bytes spent.

All three take the worker's row out of the sum; on the masked wire its
uncancelled pairwise-mask residue is repaired from recovered seeds
(``privacy.recovery``). They differ only in byte accounting. Codes are
int32.

A copy of the JAX package's ``repro.fed.faults`` in PyTorch: the codes
are computed on the device of the round index, with no host sync.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.privacy import masking as pvm

FAULT_NONE = 0
DROP_BEFORE = 1     # died before uplink: no bytes spent, row excluded
DROP_AFTER = 2      # died after uplink: bytes spent, row excluded + repair
STRAGGLER = 3       # exceeded timeout: bytes spent, row excluded + repair


@dataclass(frozen=True)
class FaultPlan:
    """Per-round i.i.d. fault probabilities, realized deterministically.

    Probabilities are per worker per round and sum to at most 1 (the rest
    is the no-fault outcome). ``seed`` namespaces the fault stream, which
    is independent of the mask, RR and recovery streams by its domain.
    """
    seed: int = 0
    drop_before_uplink: float = 0.0
    drop_after_uplink: float = 0.0
    straggler: float = 0.0

    def __post_init__(self):
        for name in ("drop_before_uplink", "drop_after_uplink", "straggler"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.total > 1.0:
            raise ValueError(
                f"fault probabilities sum to {self.total} > 1")

    @property
    def total(self) -> float:
        return (self.drop_before_uplink + self.drop_after_uplink
                + self.straggler)

    @property
    def active(self) -> bool:
        return self.total > 0.0

    def codes(self, t, n: int, *, device=None) -> torch.Tensor:
        """The (n,) int32 fault codes of round ``t``, on the device of
        ``t`` when it is a tensor (else ``device``).

        One uniform draw per worker, the uint32 stream word converted to
        float32 (rounded to nearest) and scaled by 2**-32, split by
        cumulative thresholds summed in float32, so lowering one
        probability to zero never reshuffles the draws of the others.
        """
        dev = t.device if isinstance(t, torch.Tensor) else device
        u = pvm.as_u64(pvm.stream_key(self.seed, torch.arange(n, device=dev),
                                      t, domain=pvm.FAULT_DOMAIN))
        r = u.to(torch.float32) * 2.0 ** -32
        p1 = np.float32(self.drop_before_uplink)
        p2 = p1 + np.float32(self.drop_after_uplink)
        p3 = p2 + np.float32(self.straggler)
        none = torch.full_like(u, FAULT_NONE, dtype=torch.int32)
        out = torch.where(r < float(p3), STRAGGLER, none)
        out = torch.where(r < float(p2), DROP_AFTER, out)
        return torch.where(r < float(p1), DROP_BEFORE, out)

    def alive(self, t, n: int, *, device=None) -> torch.Tensor:
        """(n,) float32 survival mask of round ``t``: 1 where no fault."""
        return (self.codes(t, n, device=device) == FAULT_NONE).to(
            torch.float32)
