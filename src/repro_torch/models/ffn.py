"""Feed-forward blocks: SwiGLU (llama-family) and GELU (whisper)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init, dtype_of, silu
from repro_torch.sharding import activations as act


def init_mlp(cfg: ArchConfig, generator: torch.Generator,
             d_ff: int | None = None) -> dict:
    D = cfg.d_model
    Fw = d_ff or cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    if cfg.ffn_act == "swiglu":
        return {
            "w_gate": dense_init(generator, D, Fw, dt),
            "w_up": dense_init(generator, D, Fw, dt),
            "w_down": dense_init(generator, Fw, D, dt),
        }
    return {
        "w_up": dense_init(generator, D, Fw, dt),
        "w_down": dense_init(generator, Fw, D, dt),
    }


def mlp(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in p:
        h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # jax.nn.gelu(approximate=True) is the tanh form
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    if h.ndim == 3:
        h = act.ffn_hidden(h)
    return h @ p["w_down"]
