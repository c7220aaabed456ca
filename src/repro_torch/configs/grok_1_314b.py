"""Grok-1 314B [moe] — hf:xai-org/grok-1.

64L, d_model 6144, 48 heads (GQA kv=8), vocab 131072, MoE: 8 experts top-2,
expert d_ff 32768. Full attention → long_500k skipped (DESIGN.md §4).
Experts (E=8) don't divide the model axis (16) → tensor-parallel experts
(see sharding/specs.py).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    arch_type="moe",
    citation="hf:xai-org/grok-1",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    max_seq=8192,
    rope_theta=1e4,
    pattern=(("attn", "moe"),),
    n_experts=8,
    top_k=2,
    d_expert_ff=32768,
))
