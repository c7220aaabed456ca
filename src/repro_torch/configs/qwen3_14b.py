"""Qwen3-14B [dense] — hf:Qwen/Qwen3-8B family card (14B variant).

40L, d_model 5120, 40 heads (GQA kv=8, head_dim 128), d_ff 17408,
vocab 151936, qk-norm. Full attention → long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-14b",
    arch_type="dense",
    citation="hf:Qwen/Qwen3-8B",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    max_seq=32768,
    rope_theta=1e6,
    qk_norm=True,
    pattern=(("attn", "mlp"),),
))
