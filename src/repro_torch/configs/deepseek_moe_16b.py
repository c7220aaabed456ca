"""DeepSeekMoE-16B [moe] — arXiv:2401.06066.

28L, d_model 2048, 16 heads (kv=16, i.e. MHA), fine-grained experts:
64 routed top-6 + 2 shared, expert d_ff 1408, vocab 102400. First layer is
a dense MLP (width 10944 per the paper) — `first_k_dense=1`.
Full attention → long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    citation="arXiv:2401.06066",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,                 # per-expert width (assigned spec)
    d_ff_dense=10944,          # the single dense layer's MLP width
    vocab=102400,
    max_seq=16384,
    rope_theta=1e4,
    pattern=(("attn", "moe"),),
    first_k_dense=1,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    d_expert_ff=1408,
))
