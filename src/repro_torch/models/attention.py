"""Attention: GQA, optional qk-norm, sliding window, KV caches, cross-attn.

The counterpart of the JAX package's ``models/attention.py``, with its
math, not ``F.scaled_dot_product_attention``'s. Three entry points:
  * ``attn_train``   — full-sequence causal (or bidirectional) attention;
  * ``attn_decode``  — one-token step against a (possibly ring) KV cache;
  * ``cross_attn``   — decoder→encoder attention with precomputed K/V.

Caches are plain dicts of tensors:
  self-attn cache: {'k': (B, S_cache, Hk, dh), 'v': ...}
For sliding-window archs S_cache == window and writes wrap (ring buffer);
RoPE is applied to keys at insert time so ring eviction is safe. Where the
reference returns a new cache, ``attn_prefill`` and ``attn_decode`` write
into the one they are given and return it: a serving step then moves no
more than the slots it fills.

Where the reference asks ``preferred_element_type=float32`` of a product
of bf16 operands, the operands are cast to float32 first: a product of
two bf16 values is exact in float32, so the result is the reference's
(float32 sums of exact products), and it stays float32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import scan_config
from repro_torch.models.layers import (apply_rope, dense_init, draw_device,
                                       dtype_of, rms_norm)
from repro_torch.sharding import activations as act

NEG_INF = -1e30


def init_attention(cfg: ArchConfig, generator: torch.Generator,
                   cross: bool = False) -> dict:
    dh = cfg.resolved_head_dim
    D = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    p = {
        "wq": dense_init(generator, D, cfg.n_heads * dh, dt),
        "wk": dense_init(generator, D, cfg.n_kv_heads * dh, dt),
        "wv": dense_init(generator, D, cfg.n_kv_heads * dh, dt),
        "wo": dense_init(generator, cfg.n_heads * dh, D, dt),
    }
    if cfg.qk_norm and not cross:
        dev = draw_device(generator)
        p["q_norm"] = torch.ones((dh,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((dh,), dtype=dt, device=dev)
    return p


def _repeat_kv(k, n_heads):
    """(B, S, Hk, dh) -> (B, S, H, dh) by group repetition."""
    hk = k.shape[2]
    if hk == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // hk, dim=2)


def _split_heads(x, n, dh):
    return act.head_split(x, n).reshape(x.shape[:-1] + (n, dh))


def _merge_heads(out):
    """(B, S, H, dh) → (B, S, H·dh), placed as the row-parallel ``wo``
    takes it."""
    return act.head_split(out.reshape(out.shape[:-2] + (-1,)),
                          out.shape[-2])


def _scale(dh: int) -> float:
    """``1 / sqrt(dh)`` rounded as the reference rounds it, in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _qkv(p, cfg: ArchConfig, x, cos, sin):
    dh = cfg.resolved_head_dim
    q = _split_heads(x @ p["wq"], cfg.n_heads, dh)
    k = _split_heads(x @ p["wk"], cfg.n_kv_heads, dh)
    v = _split_heads(x @ p["wv"], cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return act.heads(q), act.heads(k), act.heads(v)


def _sdpa(q, k, v, mask, dh):
    """GQA attention. q (B,Sq,H,dh); k/v (B,Sk,Hk,dh) UN-repeated.

    The reference's path choice by the model axis (``model_size()``, 1
    off a mesh):
      * only H divides 'model' → repeat K/V to H heads, after which the
        head dim shards cleanly;
      * else the grouped branch: the H query heads form Hk groups of
        G = H/Hk, KV-major (head h reads KV head h // G, as ``jnp.repeat``
        along the head axis orders them).
    Scores and the weighted sum are float32. mask: (B|1, 1, Sq, Sk) bool
    keep.
    """
    h, hk = q.shape[2], k.shape[2]
    msize = act.model_size()
    if msize > 1 and hk % msize != 0 and h % msize == 0:
        k = act.heads(_repeat_kv(k, h))
        v = act.heads(_repeat_kv(v, h))
        return act.heads(act.local_heads(_sdpa_repeated, q, k, v, mask, dh))
    return act.heads(act.local_heads(_sdpa_grouped, q, k, v, mask, dh))


def _sdpa_repeated(q, k, v, mask, dh):
    """Attention of q and k/v of the same H heads."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * _scale(dh)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _sdpa_grouped(q, k, v, mask, dh):
    """Attention of the H query heads in Hk groups of G = H/Hk."""
    b, sq, h, _ = q.shape
    hk = k.shape[2]
    g = h // hk
    qg = q.reshape(b, sq, hk, g, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) * _scale(dh)
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype).float(), v.float())
    return out.to(v.dtype).reshape(b, sq, h, dh)


# Blocked (flash-style) attention for full-sequence passes, by the key
# block. By default only inference prefill is blocked, in 512-key blocks:
# on the gradient path autograd keeps every tile's scores for the
# backward, so the blocked route saves no memory there and runs slower
# than the materialized scores. ``set_attn_block`` opts the gradient path
# in all the same; None keeps it materialized.
ATTN_BLOCK = [None]           # gradient path
ATTN_BLOCK_PREFILL = [512]    # inference prefill


def set_attn_block(b):
    ATTN_BLOCK[0] = b


def set_attn_block_prefill(b):
    ATTN_BLOCK_PREFILL[0] = b


def _sdpa_blocked(q, k, v, dh, causal: bool, window: Optional[int],
                  block: int):
    """Blocked attention (:func:`_blocked`), on each device's heads under
    a mesh."""
    return act.heads(act.local_heads(_blocked, q, k, v, dh, causal, window,
                                     block))


def _blocked(q, k, v, dh, causal: bool, window: Optional[int], block: int):
    """Two-level blocked online-softmax attention (flash-style).

    An outer loop over QUERY tiles, an inner loop over KEY blocks with a
    running max, normalizer and (…, q_tile, dh) float32 accumulator; every
    block is visited (a fully masked one adds exp(-1e30 - m) = 0), so the
    dry run's counter traces one tile and one block of each
    (``scan_config.loop``).
    """
    b, sq, h, _ = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = _scale(dh)
    dev = q.device
    qg = q.reshape(b, sq, hk, g, dh)
    kf, vf = k.float(), v.float()
    qt = min(block, sq)
    if sq % qt:
        qt = sq
    outs = []
    for iq in scan_config.loop("attn_q_tiles", sq // qt):
        q_tile = qg[:, iq * qt:(iq + 1) * qt].float()
        q_idx = iq * qt + torch.arange(qt, device=dev)
        m_run = torch.full((b, hk, g, qt), -torch.inf, device=dev)
        l_run = torch.zeros((b, hk, g, qt), device=dev)
        acc = torch.zeros((b, hk, g, qt, dh), device=dev)
        for ib in scan_config.loop("attn_k_blocks", sk // block):
            k_blk = kf[:, ib * block:(ib + 1) * block]
            v_blk = vf[:, ib * block:(ib + 1) * block]
            logits = torch.einsum("bqkgd,bskd->bkgqs", q_tile, k_blk) * scale
            if causal:
                k_idx = ib * block + torch.arange(block, device=dev)
                keep = k_idx[None, :] <= q_idx[:, None]
                if window is not None:
                    keep &= (q_idx[:, None] - k_idx[None, :]) < window
                logits = torch.where(keep, logits, NEG_INF)
            m_new = torch.maximum(m_run, logits.amax(-1))   # (b,hk,g,qt)
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(),
                              v_blk)
            acc = acc * corr[..., None] + pv
            m_run = m_new
        outs.append((acc / torch.clamp_min(l_run, 1e-30)[..., None]
                     ).to(v.dtype))                         # (b,hk,g,qt,dh)
    outs = outs * (sq // qt // len(outs))
    out = torch.stack(outs, 3).reshape(b, hk, g, sq, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def _sdpa_full_seq(q, k, v, dh, causal: bool, window: Optional[int],
                   grad_path: bool = True):
    """Full-sequence attention dispatcher: blocked when the path's block
    (``ATTN_BLOCK[0]`` on the gradient path, ``ATTN_BLOCK_PREFILL[0]``
    off it) is set, the key length is a multiple of it above one block and
    the heads shard over the model axis; else the materialized-score
    baseline."""
    s = k.shape[1]
    blk = ATTN_BLOCK[0] if grad_path else ATTN_BLOCK_PREFILL[0]
    msize = act.model_size()
    heads_shard = (msize == 1 or k.shape[2] % msize == 0
                   or q.shape[2] % msize == 0)
    if blk and s % blk == 0 and s > blk and heads_shard:
        if not grad_path and msize > 1 and k.shape[2] % msize != 0:
            # repeat so the head dim shards inside the blocked loops too
            k = act.heads(_repeat_kv(k, q.shape[2]))
            v = act.heads(_repeat_kv(v, q.shape[2]))
        return _sdpa_blocked(q, k, v, dh, causal, window, blk)
    mask = causal_mask(s, window, q.device) if causal else None
    return _sdpa(q, k, v, mask, dh)


def causal_mask(s: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """(1, 1, S, S) keep-mask: causal, optionally sliding-window."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    keep = ki <= qi
    if window is not None:
        keep &= (qi - ki) < window
    return keep[None, None]


def attn_train(p, cfg: ArchConfig, x, cos, sin,
               causal: bool = True) -> torch.Tensor:
    """Full-sequence attention. x (B, S, D)."""
    dh = cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x, cos, sin)
    out = _sdpa_full_seq(q, k, v, dh, causal, cfg.sliding_window)
    return _merge_heads(out) @ p["wo"]


def attn_prefill(p, cfg: ArchConfig, x, cos, sin, cache: dict
                 ) -> tuple[torch.Tensor, dict]:
    """Full-sequence causal attention that also fills the KV cache (in
    place).

    The cache ring layout matches :func:`attn_decode`: slot j holds position
    p with p % S_cache == j, so for S <= S_cache this is a plain prefix
    write; for SWA prompts longer than the window, the last `window`
    positions land in their ring slots.
    """
    dh = cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x, cos, sin)
    s = x.shape[1]
    out = _sdpa_full_seq(q, k, v, dh, True, cfg.sliding_window,
                         grad_path=False)
    y = _merge_heads(out) @ p["wo"]

    s_cache = cache["k"].shape[1]
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        new = act.like("aten::copy_ (KV cache fill)", new, c)
        if s <= s_cache:
            c[:, :s] = new
        else:
            # keep the last window, placed at their ring slots
            c.copy_(torch.roll(new[:, -s_cache:], s % s_cache, dims=1))
    return y, cache


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
               device=None, lead: tuple = ()) -> dict:
    """Self-attention cache, with ``lead`` dims in front (the unit axis of
    a stack); for sliding-window archs the cache is the ring of the last
    `min(window, max_len)` positions."""
    s_cache = max_len if cfg.sliding_window is None \
        else min(cfg.sliding_window, max_len)
    shape = (*lead, batch, s_cache, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p, cfg: ArchConfig, x, pos, cache: dict,
                cos, sin) -> tuple[torch.Tensor, dict]:
    """One-token decode. x (B, 1, D); pos an int or a 0-d device tensor
    (uniform across the batch), read on the device; cos/sin (B|1, 1,
    dh//2) at the absolute position.

    Keys are stored post-RoPE, in place; the ring write index is
    pos % S_cache.
    """
    dh = cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x, cos, sin)
    s_cache = cache["k"].shape[1]
    slot = pos % s_cache
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        new = act.like("aten::index_copy_ (KV cache write)", new, c)
        if isinstance(slot, torch.Tensor):
            # DTensor (torch 2.11) has no strategy for index_copy_
            act.local(c, 1).index_copy_(1, slot.reshape(1).long(),
                                        act.local(new, 1).to(c.dtype))
        else:
            c[:, slot:slot + 1] = new

    # keep-mask over cache slots: slot index valid iff it holds a position
    # <= pos and (for SWA) within the window. With ring writes, a slot j
    # holds position: the largest p' <= pos with p' % S == j.
    ki = torch.arange(s_cache, device=x.device)
    if isinstance(pos, torch.Tensor):
        filled = ki <= torch.clamp_max(pos, s_cache - 1)
    else:
        filled = ki <= min(pos, s_cache - 1)   # before wrap: only <= pos
    keep = filled | (pos >= s_cache)
    mask = keep[None, None, None, :]             # (1,1,1,S_cache)

    out = _sdpa(q, act.heads(cache["k"]), act.heads(cache["v"]), mask, dh)
    y = _merge_heads(out) @ p["wo"]
    return y, cache


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_kv(p, cfg: ArchConfig, enc_out) -> dict:
    """Precompute encoder K/V once per request (prefill)."""
    dh = cfg.resolved_head_dim
    k = _split_heads(enc_out @ p["wk"], cfg.n_kv_heads, dh)
    v = _split_heads(enc_out @ p["wv"], cfg.n_kv_heads, dh)
    return {"k": k, "v": v}


def cross_attn(p, cfg: ArchConfig, x, kv: dict) -> torch.Tensor:
    """x (B, Sq, D) attends over encoder memory (no mask, no rope)."""
    dh = cfg.resolved_head_dim
    q = _split_heads(x @ p["wq"], cfg.n_heads, dh)
    out = _sdpa(q, kv["k"], kv["v"], None, dh)
    return _merge_heads(out) @ p["wo"]
