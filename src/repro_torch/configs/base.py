"""Architecture config schema + registry: a copy of the JAX package's
``configs/base.py``, so both packages build a model from the same fields.

Each assigned architecture gets one ``<id>.py`` exporting ``CONFIG``; the
registry maps ``--arch <id>`` to it. ``reduced()`` builds the smoke-test
variant (≤2 pattern periods, d_model ≤ 512, ≤4 experts) of the *same
family*.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# A block descriptor: (mixer, ffn).
#   mixer ∈ {'attn', 'swa', 'mamba', 'mlstm', 'slstm'}
#   ffn   ∈ {'mlp', 'moe', 'none'}
Block = tuple[str, str]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                 # dense | moe | hybrid | ssm | audio | vlm
    citation: str

    n_layers: int = 12
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 2048
    vocab: int = 32000
    head_dim: Optional[int] = None  # default d_model // n_heads

    # attention details
    qk_norm: bool = False
    rope_theta: float = 1e6
    sliding_window: Optional[int] = None   # tokens; None = full attention
    max_seq: int = 131072
    ffn_act: str = "swiglu"                # swiglu | gelu

    # layer pattern: repeated `period = len(pattern)` times after the first
    # `first_k_dense` plain (attn, mlp) blocks.
    pattern: tuple = (("attn", "mlp"),)
    first_k_dense: int = 0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert_ff: int = 0
    d_ff_dense: Optional[int] = None       # width of first_k_dense MLPs
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # Mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None          # default d_model // 16

    # xLSTM
    lstm_proj_factor: float = 2.0          # mLSTM up-projection

    # encoder-decoder (audio)
    n_encoder_layers: int = 0
    n_frames: int = 1500                   # whisper 30 s @ 50 Hz

    # VLM
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)   # t/h/w split of head_dim//2
    n_patches: int = 1024

    norm_eps: float = 1e-5
    param_dtype: str = "float32"           # smoke default; dryrun uses bf16
    tie_embeddings: bool = False

    def __post_init__(self):
        period = len(self.pattern)
        assert (self.n_layers - self.first_k_dense) % period == 0, (
            f"{self.name}: {self.n_layers} layers − {self.first_k_dense} "
            f"dense not divisible by pattern period {period}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or max(self.d_model // 16, 1)

    @property
    def n_units(self) -> int:
        return (self.n_layers - self.first_k_dense) // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def supports_long_decode(self) -> bool:
        """True iff decode memory is sub-quadratic in context (SSM/hybrid or
        sliding-window attention) — gates the long_500k shape."""
        mixers = {m for m, _ in self.pattern}
        recurrent = {"mamba", "mlstm", "slstm"}
        if mixers & recurrent:
            return True   # pure SSM or hybrid (attention is a minority and
                          # its KV cache at B=1 stays modest, e.g. Jamba 1:7)
        return self.sliding_window is not None or "swa" in mixers

    @property
    def supports_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims (brief: ≤2 periods,
        d_model ≤ 512, ≤4 experts)."""
        period = len(self.pattern)
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, max(n_heads // 2, 1))
        head_dim = max(d_model // n_heads, 16)
        kw = dict(
            n_layers=self.first_k_dense + period * (1 if period > 1 else 2),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            max_seq=1024,
            sliding_window=(64 if self.sliding_window else None),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            d_expert_ff=min(self.d_expert_ff, 128) if self.d_expert_ff else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            n_frames=min(self.n_frames, 32),
            n_patches=min(self.n_patches, 16),
            mrope_sections=(
                (head_dim // 2 - 2 * (3 * (head_dim // 2) // 8),
                 3 * (head_dim // 2) // 8,
                 3 * (head_dim // 2) // 8)
                if self.mrope else self.mrope_sections),
            dt_rank=max(d_model // 16, 1),
            param_dtype="float32",
        )
        return self.replace(**kw)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401 — populate registry
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
