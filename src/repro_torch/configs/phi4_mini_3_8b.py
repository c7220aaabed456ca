"""Phi-4-mini 3.8B [dense] — arXiv:2412.08905.

32L, d_model 3072, 24 heads (GQA kv=8), d_ff 8192, vocab 200064.
RoPE + SwiGLU + GQA. Full attention → long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    citation="arXiv:2412.08905",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=200064,
    max_seq=131072,
    rope_theta=1e4,
    pattern=(("attn", "mlp"),),
))
