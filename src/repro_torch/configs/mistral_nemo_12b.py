"""Mistral-Nemo-12B [dense] — hf:mistralai/Mistral-Nemo-Base-2407.

40L, d_model 5120, 32 heads (GQA kv=8, head_dim 128), d_ff 14336,
vocab 131072, 128k context. We expose the sliding-window attention variant
(window = its 128k training context) so `long_500k` decode keeps a bounded
(windowed) KV cache — the documented dense-arch carve-out in DESIGN.md.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    arch_type="dense",
    citation="hf:mistralai/Mistral-Nemo-Base-2407",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    max_seq=131072,
    sliding_window=131072,
    rope_theta=1e6,
    pattern=(("attn", "mlp"),),
))
