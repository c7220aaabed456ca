"""Jamba-1.5-Large 398B [hybrid] — arXiv:2403.19887.

72L, d_model 8192, 64 heads (GQA kv=8), d_ff 24576, vocab 65536.
Mamba:attention 7:1 interleave (one attention layer per 8-layer period),
MoE every other layer: 16 experts top-2. SSM layers make decode state O(1)
in context → long_500k runs natively.
"""
from repro_torch.configs.base import ArchConfig, register

_PERIOD = (
    ("mamba", "mlp"),
    ("mamba", "moe"),
    ("mamba", "mlp"),
    ("attn", "moe"),     # the 1-in-8 attention layer
    ("mamba", "mlp"),
    ("mamba", "moe"),
    ("mamba", "mlp"),
    ("mamba", "moe"),
)

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    citation="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    max_seq=262144,
    pattern=_PERIOD,
    n_experts=16,
    top_k=2,
    d_expert_ff=24576,
    d_state=16,
    d_conv=4,
    expand=2,
))
