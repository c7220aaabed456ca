"""Configurations of the port: for now the federation scenario presets
(``configs.federation``). The architecture registry and the model configs
of the JAX package's ``repro.configs`` are not ported yet."""
from repro_torch.configs.federation import (  # noqa: F401
    FedScenario, get_scenario, list_scenarios,
)
