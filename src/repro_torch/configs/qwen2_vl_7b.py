"""Qwen2-VL-7B [vlm] — arXiv:2409.12191.

28L, d_model 3584, 28 heads (GQA kv=4), d_ff 18944, vocab 152064.
M-RoPE (t/h/w position components). The ViT vision tower is a STUB per the
brief: `input_specs()` provides patch embeddings (B, n_patches, d_model)
merged into the token stream through a trainable projector.
Full attention → long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    citation="arXiv:2409.12191",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    max_seq=32768,
    rope_theta=1e6,
    pattern=(("attn", "mlp"),),
    mrope=True,
    mrope_sections=(16, 24, 24),
    n_patches=1024,
))
