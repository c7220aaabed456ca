"""FedPC paper-analog config: a small dense model for the paper-table
benchmarks (Tables 1–4, Fig 4/6) on synthetic data.

The paper trains ResNet50-FIXUP / U-Net; offline we reproduce the
*federated-training behaviour* (approximation ratio, convergence,
communication) with a compact transformer — the FedPC protocol is
model-agnostic (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="fedpc-paper",
    arch_type="dense",
    citation="DOI 10.1016/j.sysarc.2022.102413 (this paper)",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    max_seq=256,
    rope_theta=1e4,
    pattern=(("attn", "mlp"),),
))
