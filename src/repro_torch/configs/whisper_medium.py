"""Whisper-medium [audio] — arXiv:2212.04356.

Encoder-decoder, 24+24L, d_model 1024, 16 heads (MHA), d_ff 4096,
vocab 51865, GELU MLPs. The mel-spectrogram + conv frontend is a STUB per
the brief: `input_specs()` feeds precomputed frame embeddings
(B, n_frames=1500, d_model) through a trainable linear adapter.
Decode shapes exercise the text decoder (self-attn cache + fixed cross-attn
cache); long_500k is skipped (enc-dec, full attention — DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium",
    arch_type="audio",
    citation="arXiv:2212.04356",
    n_layers=24,                # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    max_seq=32768,
    ffn_act="gelu",
    pattern=(("attn", "mlp"),),
    n_frames=1500,
))
