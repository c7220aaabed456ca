"""Roofline terms and analytic model FLOPs, the JAX package's
``launch/analysis.py`` with the H100 production mesh's constants.

Sources:
  * the counter (``launch.hlo_stats``) → per-device FLOPs, bytes, peak
    live bytes and collective bytes by mesh axis, from one rank's local
    ops under DTensor;
  * analytic 6·N·D model FLOPs for the useful-compute ratio.

The reference's HLO text parser (``parse_collectives``) and the roofline
it feeds have no counterpart: there is no HLO; the counter sees DTensor's
collectives as ops.

Collective time is split by axis: model-axis bytes cross NVLink inside a
node (``NVLINK_BW``), data/pod bytes the network (``NET_BW``); ``fits``
compares a device's peak live bytes with ``HBM_BYTES``. All constants are
datasheet figures (``launch.mesh``), so every time here is counted, not
measured.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, NET_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16)


# ---------------------------------------------------------------------------
# Analytic model FLOPs (6·N·D dense / 6·N_active·D MoE)
# ---------------------------------------------------------------------------

def active_params(cfg: ArchConfig) -> tuple[int, int]:
    """(total_params, active_params_per_token) for the backbone."""
    D, dh = cfg.d_model, cfg.resolved_head_dim
    total = cfg.vocab * D * (1 if cfg.tie_embeddings else 2)
    act = total

    def attn_p():
        return D * (cfg.n_heads * dh) * 2 + D * (cfg.n_kv_heads * dh) * 2

    def mlp_p(dff):
        mult = 3 if cfg.ffn_act == "swiglu" else 2
        return mult * D * dff

    def mamba_p():
        di, ds, dtr = cfg.d_inner, cfg.d_state, cfg.resolved_dt_rank
        return (D * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * ds
                + di * D)

    def mlstm_p():
        di = int(cfg.lstm_proj_factor * D)
        di = (di // cfg.n_heads) * cfg.n_heads
        return D * 2 * di + 3 * di * di + di * 2 * cfg.n_heads + di * D

    def slstm_p():
        return D * 4 * D + D * 4 * D + D * D

    per_unit_total = per_unit_active = 0
    for mixer, f in cfg.pattern:
        if mixer in ("attn", "swa"):
            m = attn_p()
        elif mixer == "mamba":
            m = mamba_p()
        elif mixer == "mlstm":
            m = mlstm_p()
        else:
            m = slstm_p()
        per_unit_total += m
        per_unit_active += m
        if f == "mlp":
            per_unit_total += mlp_p(cfg.d_ff)
            per_unit_active += mlp_p(cfg.d_ff)
        elif f == "moe":
            routed = cfg.n_experts * 3 * D * cfg.d_expert_ff
            shared = (3 * D * cfg.n_shared_experts * cfg.d_expert_ff
                      if cfg.n_shared_experts else 0)
            per_unit_total += routed + shared + D * cfg.n_experts
            per_unit_active += (cfg.top_k * 3 * D * cfg.d_expert_ff
                                + shared + D * cfg.n_experts)
    total += per_unit_total * cfg.n_units
    act += per_unit_active * cfg.n_units
    if cfg.first_k_dense:
        dense = attn_p() + mlp_p(cfg.d_ff_dense or cfg.d_ff)
        total += dense * cfg.first_k_dense
        act += dense * cfg.first_k_dense
    if cfg.is_encdec:
        enc = (attn_p() + mlp_p(cfg.d_ff)) * cfg.n_encoder_layers
        cross = attn_p() * cfg.n_layers
        total += enc + cross + D * D
        act += enc + cross + D * D
    return int(total), int(act)


def model_flops(cfg: ArchConfig, n_tokens: int, kind: str) -> float:
    """6·N_active·D for train, 2·N_active·D for forward-only kinds."""
    _, act = active_params(cfg)
    mult = 6.0 if kind == "train" else 2.0
    return mult * act * n_tokens


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    nvlink_s: float
    network_s: float
    collective_s: float
    flops_device: float
    bytes_device: float
    collective_bytes_device: float
    peak_bytes_device: float
    fits: bool
    model_flops_total: float
    useful_ratio: float
    dominant: str

    def to_dict(self):
        return {k: getattr(self, k) for k in (
            "compute_s", "memory_s", "nvlink_s", "network_s",
            "collective_s", "flops_device", "bytes_device",
            "collective_bytes_device", "peak_bytes_device", "fits",
            "model_flops_total", "useful_ratio", "dominant")}


def roofline_from_stats(stats, n_chips: int, cfg: ArchConfig,
                        n_tokens: int, kind: str) -> Roofline:
    """Roofline terms from the counter's per-device stats. MODEL_FLOPS is
    the global 6·N_active·D and the useful ratio divides by chips. The
    collective term is the NVLink time of the model-axis bytes plus the
    network time of the rest; ``dominant`` names the largest of compute,
    memory, nvlink and network."""
    flops_dev = float(stats.flops)
    bytes_dev = float(stats.bytes)
    compute_s = flops_dev / PEAK_FLOPS_BF16
    memory_s = bytes_dev / HBM_BW
    model_b = float(stats.bytes_by_axis.get("model", 0.0))
    nvlink_s = model_b / NVLINK_BW
    network_s = (stats.collective_device_bytes - model_b) / NET_BW
    mf = model_flops(cfg, n_tokens, kind)
    useful = mf / (flops_dev * n_chips) if flops_dev else float("nan")
    terms = {"compute": compute_s, "memory": memory_s, "nvlink": nvlink_s,
             "network": network_s}
    dominant = max(terms, key=terms.get)
    return Roofline(compute_s, memory_s, nvlink_s, network_s,
                    nvlink_s + network_s, flops_dev, bytes_dev,
                    stats.collective_device_bytes, float(stats.peak_bytes),
                    stats.peak_bytes <= HBM_BYTES, mf, useful, dominant)
