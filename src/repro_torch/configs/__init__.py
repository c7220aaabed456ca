"""Config registry: importing this package registers every architecture
(the JAX package's ``repro.configs``, field for field) and the federation
scenario presets (``configs.federation``); ``models.build_model`` builds
every architecture.
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, get_config, list_configs, register,
)
from repro_torch.configs.federation import (  # noqa: F401
    FedScenario, get_scenario, list_scenarios,
)

# Assigned architectures (public-literature pool) + the paper-analog config.
from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b,
    fedpc_mlp,
    grok_1_314b,
    jamba_1_5_large_398b,
    mistral_large_123b,
    mistral_nemo_12b,
    phi4_mini_3_8b,
    qwen2_vl_7b,
    qwen3_14b,
    whisper_medium,
    xlstm_350m,
)

ASSIGNED = (
    "mistral-nemo-12b",
    "mistral-large-123b",
    "grok-1-314b",
    "jamba-1.5-large-398b",
    "phi4-mini-3.8b",
    "deepseek-moe-16b",
    "xlstm-350m",
    "whisper-medium",
    "qwen2-vl-7b",
    "qwen3-14b",
)
