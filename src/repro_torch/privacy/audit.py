"""The dropout-recovery guard of the JAX package's ``repro.privacy.audit``.

Only :func:`check_recovery_target` is ported; the traced-program audit of
that module (and with it ``PrivacySpec(enforce=True)``) waits for a later
slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.privacy import LeakageError


def check_recovery_target(worker: int, alive) -> None:
    """Mask-seed reconstruction may only target a declared-dead worker.

    Reconstructing a live worker's pair keys would let the server strip
    that worker's masks from its committed uplink, the attack secure
    aggregation exists to prevent, so ``recovery.recover_worker_keys``
    calls this before combining any share. ``alive`` is the round's public
    (n,) survival mask (numpy or a tensor; > 0 means live)."""
    a = torch.as_tensor(alive)
    if bool(a[int(worker)] > 0):
        raise LeakageError(
            f"mask-seed recovery targeted worker {int(worker)}, which is "
            f"still live this round — recovery may only reconstruct "
            f"declared-dead workers' seeds")
