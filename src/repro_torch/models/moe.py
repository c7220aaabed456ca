"""Mixture-of-Experts: top-k routing with capacity-based scatter dispatch.

The counterpart of the JAX package's ``models/moe.py``, on one card:

  1. router logits (T, E) in fp32, softmax, top-k, renormalize;
  2. position-in-expert via cumsum over the flat (T·k,) assignment stream;
  3. tokens scattered into (E, C, D) expert buffers (overflow dropped — the
     classic capacity-factor discipline);
  4. per-expert SwiGLU as batched products over the E axis;
  5. gather back, combine with gate weights, add shared-expert output.

Aux losses: switch-style load balance + router z-loss.

Dispatch is SHARD-LOCAL, as the reference's is: the token stream is
viewed as (s, T/s) blocks matching the data-parallel shards of the active
mesh (``sharding.activations.dp_size()``), and position-in-expert is
computed *within each block*, so the scatter into (E, s, C_loc, D)
buffers never crosses shards. Off a mesh (one card) s == 1 and the
semantics are the paper-standard global capacity. Expert-parallel
buffers (E divides the model axis) keep the global dispatch, as the
reference measured them to; ``FORCE_GLOBAL_DISPATCH`` forces it.
Nothing here syncs with the host (no ``nonzero``, boolean indexing,
``.item()`` or range-checked ``index_put_(accumulate=True)``), so a
worker's step that routes tokens can be captured in a CUDA graph and a
decode step runs under ``torch.cuda.set_sync_debug_mode("error")``.

Two runs give the same bits. Each token's K copies are a broadcast of its
row, whose backward sums the K gradients in a fixed order (a gather's
backward would add them atomically). The kept assignments own distinct
slots, so the buffer is written, not summed: the reference adds each
dropped assignment's zero row to slot (0, C-1); here it goes to a spare
row past the buffer, which is never read. The gather back reads (0, b,
C-1) for a dropped one of block b, times a zero gate, as the reference
does; its backward
is ``index_put_(accumulate=True)``, which sorts its indices on CUDA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.ffn import init_mlp, mlp
from repro_torch.models.layers import (dense_init, dtype_of, silu,
                                       trunc_normal)
from repro_torch.sharding import activations as act


def init_moe(cfg: ArchConfig, generator: torch.Generator) -> dict:
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_expert_ff
    dt = dtype_of(cfg.param_dtype)
    p = {
        "router": dense_init(generator, D, E, torch.float32),
        "experts_gate": trunc_normal(generator, (E, D, Fe), math.sqrt(D),
                                     dt),
        "experts_up": trunc_normal(generator, (E, D, Fe), math.sqrt(D), dt),
        "experts_down": trunc_normal(generator, (E, Fe, D), math.sqrt(Fe),
                                     dt),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, generator,
                               d_ff=cfg.n_shared_experts * cfg.d_expert_ff)
    return p


# Force the paper-standard global-capacity dispatch even on a mesh.
FORCE_GLOBAL_DISPATCH = [False]


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / max(cfg.n_experts, 1))
    return max(c, cfg.top_k)


def route(p: dict, cfg: ArchConfig, xf: torch.Tensor, s_blk: int = 1):
    """Routing of the (T, D) token stream: ``(logits, probs, gates, e_idx,
    pos, keep)`` — router logits and softmax (T, E) fp32, the renormalized
    top-k gates and experts (T, K), and each assignment's position in its
    expert within its block of ``T / s_blk`` tokens and whether it fits
    that block's capacity, over the token-major (T·K,) stream."""
    E, K = cfg.n_experts, cfg.top_k
    logits = xf.float() @ p["router"]                        # (T, E) fp32
    probs = torch.softmax(logits, dim=-1)
    gate_vals, e_idx = torch.topk(probs, K, dim=-1)          # (T, K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    flat_e = e_idx.reshape(s_blk, -1)                        # (s, Tl*K)
    onehot = F.one_hot(flat_e, E)                            # (s, Tl*K, E)
    # scanned along the innermost dim of (s, E, Tl*K): CUDA's scan over an
    # outer dim runs a thread a column, 64 threads for 24k rows
    pos_all = torch.cumsum(onehot.transpose(1, 2), dim=2).transpose(
        1, 2) - onehot
    pos = pos_all.gather(2, flat_e[..., None])[..., 0]       # (s, Tl*K)
    keep = pos < capacity(cfg, xf.shape[0] // s_blk)
    return logits, probs, gate_vals, e_idx, pos.reshape(-1), keep.reshape(-1)


def moe(p: dict, cfg: ArchConfig, x: torch.Tensor
        ) -> tuple[torch.Tensor, dict]:
    """x (B, S, D) → (out, aux). aux: load_balance, z_loss, drop_frac."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    s_blk = act.dp_size()
    # Block-local dispatch pays off for tensor-parallel experts (E does
    # not divide 'model'); expert-parallel buffers keep global dispatch,
    # as the reference measured them to.
    if T % s_blk or FORCE_GLOBAL_DISPATCH[0] \
            or (s_blk > 1 and E % act.model_size() == 0):
        s_blk = 1
    Tl = T // s_blk
    C = capacity(cfg, Tl)                                    # per block
    xf = x.reshape(T, D)
    logits, probs, gate_vals, e_idx, pos, keep = route(p, cfg, xf,
                                                       s_blk=s_blk)
    flat_e = e_idx.reshape(-1)
    gate_flat = gate_vals.reshape(-1) * keep.float()

    # ---- block-local scatter into expert buffers ------------------------
    # A kept assignment owns slot (e, b, pos) of its block b; a dropped one
    # writes its zero row to the spare row E*s*C, never over a kept slot.
    blk = torch.arange(T * K, device=x.device) // (Tl * K)
    slot = (flat_e * s_blk + blk) * C + pos
    n_slots = E * s_blk * C
    rows = xf[:, None].expand(T, K, D).reshape(T * K, D)     # token-major
    contrib = torch.where(keep[:, None], rows, 0).to(x.dtype)
    buf = torch.zeros((n_slots + 1, D), dtype=x.dtype, device=x.device)
    at, contrib = act.scatter_rows("aten::index_put (MoE scatter, split "
                                   "slots)", torch.where(keep, slot, n_slots),
                                   contrib)
    buf = buf.index_put((at,), contrib)
    del at                      # a temporary, as the slots of the gather
    buf = act.expert_block_buf(buf[:n_slots].view(E, s_blk, C, D))

    # ---- expert SwiGLU over the E axis ----------------------------------
    w_gate = act.expert_weights(p["experts_gate"])
    w_up = act.expert_weights(p["experts_up"])
    w_down = act.expert_weights(p["experts_down"], transposed=True)
    xb = buf.reshape(E, s_blk * C, D)
    h = act.expert_block_hidden(
        (silu(torch.bmm(xb, w_gate)) * torch.bmm(xb, w_up)).view(
            E, s_blk, C, -1))
    out_buf = act.expert_block_buf(
        torch.bmm(h.reshape(E, s_blk * C, -1), w_down).view(
            E, s_blk, C, D))                                 # (E, s, C, D)

    # ---- block-local gather + combine -----------------------------------
    y_flat = act.gather_rows(
        "aten::index (MoE gather, sharded slots)", out_buf, (n_slots, D),
        lambda: torch.where(keep, slot, blk * C + C - 1), E)  # (T*K, D)
    y = (y_flat.float() * gate_flat[:, None]).reshape(T, K, D).sum(1)
    y = y.to(x.dtype)
    if "shared" in p:
        y = y + mlp(p["shared"], cfg, xf)

    # ---- aux losses ------------------------------------------------------
    # Switch load balance: E * sum_e (token_frac_e * prob_frac_e)
    assign_frac = F.one_hot(e_idx, E).float().sum(1).mean(0)     # (E,)
    prob_frac = probs.mean(0)
    lb = E * (assign_frac / K * prob_frac).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    drop_frac = 1.0 - keep.float().mean()
    aux = {"load_balance": lb, "z_loss": z, "drop_frac": drop_frac}
    return y.reshape(B, S, D), aux
