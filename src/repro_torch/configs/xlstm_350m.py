"""xLSTM-350M [ssm] — arXiv:2405.04517.

24L, d_model 1024, 4 heads, vocab 50304, d_ff=0 (mixer-only blocks).
Alternating sLSTM + mLSTM blocks. Recurrent state is O(1) in context →
long_500k runs natively; sLSTM is inherently sequential (paper §2 of
xLSTM acknowledges this) — see roofline notes.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m",
    arch_type="ssm",
    citation="arXiv:2405.04517",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab=50304,
    max_seq=1048576,
    pattern=(("mlstm", "none"), ("slstm", "none")),
    lstm_proj_factor=2.0,
))
