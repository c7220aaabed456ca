"""Mistral-Large-123B [dense] — hf:mistralai/Mistral-Large-Instruct-2407.

88L, d_model 12288, 96 heads (GQA kv=8), d_ff 28672, vocab 32768.
Pure full attention → long_500k decode is skipped (see DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-large-123b",
    arch_type="dense",
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=32768,
    max_seq=32768,
    rope_theta=1e6,
    pattern=(("attn", "mlp"),),
))
