"""The §4.2 information-flow ledger.

Every value that crosses the worker→master boundary is recorded, and
full-precision parameters may cross only on the pilot path.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# Message fields that are allowed to leave a worker.
ALLOWED_UPLINK_FIELDS = {
    "cost",            # scalar loss — Thm 2's only always-shared signal
    "packed_ternary",  # 2-bit codes — Thm 3
    "masked_words",    # secure-agg wire words
    "pilot_params",    # full weights, ONLY when commanded SEND_MODEL
    "worker_id",
    "round",
    "seed_shares",     # dropout recovery: shares of pair-mask seeds
    "mask_recovery",   # dropout recovery: shares of a dead worker's seeds
}


class LeakageError(RuntimeError):
    pass


@dataclass
class LeakageLedger:
    """Records worker→master events; raises on a disallowed one."""
    events: list = field(default_factory=list)

    def record(self, worker_id: int, round_: int, kind: str,
               is_pilot: bool) -> None:
        if kind not in ALLOWED_UPLINK_FIELDS:
            raise LeakageError(f"disallowed uplink field {kind!r}")
        if kind == "pilot_params" and not is_pilot:
            raise LeakageError(
                f"worker {worker_id} attempted full-weight upload without "
                f"SEND_MODEL command at round {round_}")
        self.events.append((round_, worker_id, kind, is_pilot))
