"""Federation scenario presets — the round core's knobs, bundled.

The round core (``repro_torch.fed.rounds``) exposes two scenario axes
beyond the paper's uniform full-participation setup: FedAvg-style
C-fraction **partial participation** (McMahan et al., 1602.05629 — the
normal operating regime for cross-device federation) and **heterogeneous
per-worker beta_k** (per-client adaptive quantization, cf. the
communication survey 2405.20431). A :class:`FedScenario` names one point
in that space so benchmarks, examples and tests exercise the same regimes
by name. The privacy axis (``repro_torch.privacy``) rides along as an
optional :class:`~repro_torch.privacy.spec.PrivacySpec`: secure-aggregation
masking and local-DP randomized response on the wire, enforced by the
round-program audit (``enforce=True``, the default).

A copy of the JAX package's ``repro.configs.federation``: the same six
presets and the same numpy draw of beta_k.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.privacy.spec import PrivacySpec


@dataclass(frozen=True)
class FedScenario:
    """One federation regime: who participates, with what thresholds."""
    name: str
    participation: float = 1.0        # C-fraction of workers per round
    beta_menu: tuple | None = None    # per-worker beta_k draws; None=uniform
    privacy: PrivacySpec | None = None  # secure-agg / local-DP wire
    description: str = ""

    def betas_for(self, n_workers: int, seed: int = 0) -> tuple | None:
        """Deterministic per-worker beta_k draw (None in uniform regimes) —
        feed to ``FedPCConfig(betas=...)`` / ``run_fedpc(betas=...)``."""
        if self.beta_menu is None:
            return None
        rng = np.random.default_rng(seed + 4099)
        return tuple(float(rng.choice(self.beta_menu))
                     for _ in range(n_workers))


_SCENARIOS = {
    s.name: s for s in (
        FedScenario(
            "paper-uniform",
            description="The paper's §5 setup: everyone participates, one "
                        "shared beta."),
        FedScenario(
            "hetero-beta", beta_menu=(0.1, 0.2, 0.3),
            description="Full participation, per-worker significance "
                        "thresholds beta_k drawn from a menu."),
        FedScenario(
            "cross-device", participation=0.5,
            description="FedAvg-style C=0.5 sampling: half the fleet is "
                        "drawn each round."),
        FedScenario(
            "cross-device-hetero", participation=0.25,
            beta_menu=(0.1, 0.2, 0.3),
            description="C=0.25 sampling + heterogeneous beta_k — the "
                        "adaptive-quantization cross-device regime."),
        FedScenario(
            "secure-agg", privacy=PrivacySpec(),
            description="Pairwise-masked secure aggregation: the master "
                        "sees only the modular sum of fixed-point-weighted "
                        "ternary fields, never a worker's directions."),
        FedScenario(
            "secure-agg-ldp", participation=0.5,
            privacy=PrivacySpec(dp_epsilon=4.0),
            description="Secure aggregation + per-round eps=4 local-DP "
                        "randomized response on the codes, under C=0.5 "
                        "sampling — the full privacy stack."),
    )
}


def get_scenario(name: str) -> FedScenario:
    if name not in _SCENARIOS:
        raise KeyError(
            f"unknown federation scenario {name!r}; have "
            f"{sorted(_SCENARIOS)}")
    return _SCENARIOS[name]


def list_scenarios() -> list[str]:
    return sorted(_SCENARIOS)
