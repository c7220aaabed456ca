"""The §4.2 information-flow ledger and the worker-side defences.

Every value that crosses the worker→master boundary is recorded, and
full-precision parameters may cross only on the pilot path. When the
goodness rotation gets stuck on one worker, that worker can defend itself
(the discussion of §4.2): report its previous cost so its goodness is 0,
or add noise to the model it uploads.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.utils import PyTree, tree_flatten, tree_unflatten

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
    """Records worker→master events; raises on a disallowed one.

    ``audits`` records the round-program audits (``repro_torch.privacy
    .audit``): both FedPC drivers audit their round program at set-up when
    the :class:`~repro_torch.privacy.spec.PrivacySpec` has ``enforce=True``
    — a violation raises :class:`LeakageError` before any round runs, and
    the passed audit is logged here, so tests (and operators) can see that
    enforcement happened."""
    events: list = field(default_factory=list)
    audits: list = field(default_factory=list)

    def record_audit(self, runtime: str, report: dict) -> None:
        """Log a passed round-program audit under the driver's name."""
        self.audits.append({"runtime": runtime, **report})

    def record(self, worker_id: int, round_: int, kind: str,
               is_pilot: bool) -> None:
        if kind not in ALLOWED_UPLINK_FIELDS:
            raise LeakageError(f"disallowed uplink field {kind!r}")
        if kind == "pilot_params" and not is_pilot:
            raise LeakageError(
                f"worker {worker_id} attempted full-weight upload without "
                f"SEND_MODEL command at round {round_}")
        self.events.append((round_, worker_id, kind, is_pilot))

    def pilot_rounds(self, worker_id: int) -> list[int]:
        return [r for (r, w, k, p) in self.events
                if w == worker_id and k == "pilot_params"]

    def consecutive_pilot_streak(self, worker_id: int) -> int:
        """The longest run of consecutive rounds the worker was pilot in,
        over the whole ledger (not the run that is current)."""
        rounds = sorted(self.pilot_rounds(worker_id))
        streak = best = 0
        prev = None
        for r in rounds:
            streak = streak + 1 if prev is not None and r == prev + 1 else 1
            best = max(best, streak)
            prev = r
        return best


def should_evade(pilot_streak: int, max_streak: int = 3) -> bool:
    """Paper: 'after a fixed number of steps, if the global model … is always
    identical to its local model instance', the worker defends itself."""
    return pilot_streak >= max_streak


def evade_cost(prev_cost):
    """Defence (2): report the cost unchanged so goodness (Eq. 1) is zero and
    the master must pick someone else."""
    return prev_cost


def dp_noise_tree(params: PyTree, generator: torch.Generator,
                  sigma: float) -> PyTree:
    """Defence (1): Gaussian-mechanism noise of std ``sigma`` on the
    uploaded instance, drawn leaf by leaf from ``generator`` (on the
    leaves' device). Its random bits are not the JAX package's
    (``jax.random.normal``): the draws differ by design, and no round path
    calls this."""
    leaves, treedef = tree_flatten(params)
    noisy = [l + sigma * torch.randn(l.shape, generator=generator,
                                     dtype=torch.float32,
                                     device=l.device).to(l.dtype)
             for l in leaves]
    return tree_unflatten(treedef, noisy)


def gradient_inversion_hardness(n_batches: int, known_lr: bool) -> dict:
    """Thm 2 bookkeeping: unknowns vs. equations available to an
    honest-but-curious master observing one worker for 2(n+1) epochs."""
    unknowns = n_batches + (0 if known_lr else 1)
    equations = 1  # per observed consecutive-epoch pair: one vector equation
    return {
        "unknowns_per_epoch": unknowns,
        "equations_per_pair": equations,
        "underdetermined": unknowns > equations,
    }
