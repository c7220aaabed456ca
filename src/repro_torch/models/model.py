"""Model facade: build any registered architecture from its ArchConfig.

The counterpart of the JAX package's ``models/model.py``; the API is its
own, functional, over nested dicts of tensors with the reference's keys:

    m = build_model(get_config("qwen3-14b"))
    params = m.init(torch.Generator("cuda").manual_seed(0))   # on CUDA
    loss, aux = m.loss(params, batch)
    params, opt_state, metrics = m.train_step(params, opt_state, batch, lr)
    state = m.init_decode_state(batch, max_len)                # on CUDA
    logits, state = m.prefill(params, batch, state)
    logits, state = m.decode_step(params, state, step_batch)

Batch conventions:
  LM:    {"tokens": (B, S) int}
  VLM:   + {"vision_embed": (B, P, D), "positions": (3, B, S) int}
  audio: {"tokens": (B, S) int, "audio_embed": (B, F, D)}
Decode step: {"token": (B, 1) int, "pos": an int or a 0-d device int
tensor} (+ "positions" (3, B, 1) vlm); ``pos`` is read on the device,
never fetched to the host.

``init`` and ``init_decode_state`` place their tensors on CUDA unless the
caller passes ``device=`` (``"cpu"`` in tests), and raise where there is
no card. ``prefill`` and ``decode_step`` fill the caches of the state they
are given in place and return it. ``forward`` (full-sequence logits, the
path ``loss`` takes) and ``loss_and_grad`` (the worker's ``((loss, aux),
grads)``) are the port's additions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (dtype_of, mrope_cos_sin, rms_norm,
                                       rope_cos_sin, sinusoidal_at,
                                       sinusoidal_positions)
from repro_torch.optim.optimizers import Optimizer, apply_updates, momentum
from repro_torch.sharding import activations as act
from repro_torch.utils import resolve_device, tree_leaves, value_and_grad

PyTree = Any


def _needs_rope(cfg: ArchConfig) -> bool:
    return not cfg.is_encdec  # whisper uses sinusoidal tables instead


def _rope_for(cfg: ArchConfig, batch: dict, S: int, device):
    if not _needs_rope(cfg):
        return None, None
    dh = cfg.resolved_head_dim
    if cfg.mrope and "positions" in batch:
        return mrope_cos_sin(batch["positions"], dh, cfg.rope_theta,
                             cfg.mrope_sections)    # (B, S, dh//2)
    pos = torch.arange(S, dtype=torch.int32, device=device)[None]  # (1, S)
    return rope_cos_sin(pos, dh, cfg.rope_theta)


def _lookup(tokens, table) -> torch.Tensor:
    # F.embedding's CUDA backward sorts the ids and sums each row's
    # gradients in that order: no atomics, the same bits every run. On a
    # mesh the table is gathered whole first: DTensor's vocab-sharded
    # lookup leaves a masked partial that it cannot add or reduce.
    return F.embedding(tokens, act.replicated("aten::embedding", table))


def _embed(cfg: ArchConfig, params: PyTree, batch: dict) -> torch.Tensor:
    x = _lookup(batch["tokens"], params["embed"])
    if cfg.arch_type == "vlm" and "vision_embed" in batch:
        patches = batch["vision_embed"] @ params["patch_proj"]
        n_p = patches.shape[1]
        x = torch.cat([x[:, :n_p] + patches.to(x.dtype), x[:, n_p:]], dim=1)
    if cfg.is_encdec:
        pe = torch.from_numpy(sinusoidal_positions(x.shape[1], cfg.d_model))
        x = x + pe.to(device=x.device, dtype=x.dtype)
    return act.residual(x)


def _logits(cfg: ArchConfig, params: PyTree, x) -> torch.Tensor:
    x = rms_norm(x, params["norm_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return act.logits(x @ head)


def _xent(logits, labels) -> torch.Tensor:
    # The gold logits stay (B, S, 1) until the mean: on vocab-sharded
    # logits (a mesh) DTensor's masked gather cannot be squeezed first.
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long()[..., None])
    return (lse[..., None] - gold).mean()


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable
    forward: Callable
    loss: Callable
    loss_and_grad: Callable
    train_step: Callable
    init_decode_state: Callable
    prefill: Callable
    prefill_sequential: Callable
    decode_step: Callable
    optimizer: Optimizer


def build_model(cfg: ArchConfig, optimizer: Optional[Optimizer] = None
                ) -> Model:
    """The model of ``cfg``."""
    opt = optimizer or momentum()
    act_dtype = dtype_of(cfg.param_dtype)

    def init(generator: torch.Generator, *, device=None) -> PyTree:
        """Random weights drawn from ``generator`` (on its device) and
        placed on ``device`` (``None`` means CUDA)."""
        return tf.init_stack(cfg, generator, resolve_device(device))

    # ---------------- forward / loss ----------------
    def forward(params: PyTree, batch: dict):
        """Full-sequence logits (B, S, V) and the MoE auxiliaries."""
        S = batch["tokens"].shape[1]
        cos, sin = _rope_for(cfg, batch, S, params["embed"].device)
        x = _embed(cfg, params, batch)
        cross_kvs = None
        if cfg.is_encdec:
            enc = tf.apply_encoder(cfg, params, batch["audio_embed"])
            cross_kvs = tf.encoder_cross_kvs(cfg, params, enc)
        x = tf.apply_dense_prefix_train(cfg, params, x, cos, sin)
        x, aux = tf.apply_units_train(cfg, params, x, cos, sin,
                                      cross_kvs=cross_kvs)
        return _logits(cfg, params, x), aux

    def loss(params: PyTree, batch: dict):
        """Next-token cross-entropy plus, for a MoE stack, the router's
        load-balance and z-loss terms averaged over its MoE blocks."""
        logits, aux = forward(params, batch)
        labels = batch["tokens"][:, 1:]
        l = _xent(logits[:, :-1], labels)
        n_moe = sum(1 for _, f in cfg.pattern if f == "moe") * cfg.n_units
        if n_moe:
            l = l + cfg.router_aux_weight * aux["load_balance"] / n_moe \
                  + 1e-3 * aux["z_loss"] / n_moe
        return l, aux

    def loss_and_grad(params: PyTree, batch):
        """``((loss, aux), grads)`` with ``grads`` shaped like ``params``;
        ``batch`` a batch dict or a worker loader's ``(tokens,)``."""
        if not isinstance(batch, dict):
            batch = {"tokens": batch[0]}
        return value_and_grad(loss, params, batch)

    def train_step(params: PyTree, opt_state: PyTree, batch: dict, lr):
        (l, aux), grads = loss_and_grad(params, batch)
        updates, opt_state = opt.update(grads, opt_state, params, lr)
        params = apply_updates(params, updates)
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for g in tree_leaves(grads)))
        return params, opt_state, {"loss": l, "grad_norm": gnorm, **aux}

    # ---------------- serving ----------------
    def init_decode_state(batch: int, max_len: int, *, device=None) -> dict:
        """Zeroed caches on ``device`` (``None`` means CUDA)."""
        dev = resolve_device(device)
        state = {"units": tf.init_unit_caches(cfg, batch, max_len, act_dtype,
                                              dev)}
        dp = tf.init_dense_prefix_caches(cfg, batch, max_len, act_dtype, dev)
        if dp is not None:
            state["dense"] = dp
        if cfg.is_encdec:
            shape = (cfg.n_units, batch, cfg.n_frames, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            state["cross"] = {
                f"b{j}": {k: torch.zeros(shape, dtype=act_dtype, device=dev)
                          for k in ("k", "v")}
                for j in range(len(cfg.pattern))}
        return state

    def prefill(params: PyTree, batch: dict, state: dict):
        """Parallel prefill: full-sequence forward that fills the decode
        caches in one pass. Returns (last_logits (B,1,V), state)."""
        S = batch["tokens"].shape[1]
        cos, sin = _rope_for(cfg, batch, S, params["embed"].device)
        x = _embed(cfg, params, batch)
        new_state = dict(state)
        if cfg.is_encdec:
            enc = tf.apply_encoder(cfg, params, batch["audio_embed"])
            new_state["cross"] = tf.encoder_cross_kvs(cfg, params, enc)
        if "dense" in state:
            x, new_state["dense"] = tf.apply_dense_prefix_prefill(
                cfg, params, x, cos, sin, state["dense"])
        x, new_state["units"], _aux = tf.apply_units_prefill(
            cfg, params, x, cos, sin, state["units"],
            cross_kvs=new_state.get("cross"))
        return _logits(cfg, params, x[:, -1:]), new_state

    def prefill_sequential(params: PyTree, batch: dict, state: dict):
        """Prompt processing as a loop of decode steps — kept as the exact
        cache-parity oracle for tests (slow; O(S) sequential)."""
        if cfg.is_encdec:
            enc = tf.apply_encoder(cfg, params, batch["audio_embed"])
            state = dict(state)
            state["cross"] = tf.encoder_cross_kvs(cfg, params, enc)
        tokens = batch["tokens"]
        logits = torch.zeros((tokens.shape[0], 1, cfg.vocab),
                             dtype=act_dtype, device=tokens.device)
        for i in range(tokens.shape[1]):
            step_batch = {"token": tokens[:, i:i + 1], "pos": i}
            if cfg.mrope and "positions" in batch:
                step_batch["positions"] = batch["positions"][:, :, i:i + 1]
            logits, state = decode_step(params, state, step_batch)
        return logits, state

    def decode_step(params: PyTree, state: dict, step_batch: dict):
        tok = step_batch["token"]            # (B, 1)
        pos = step_batch["pos"]              # an int or a 0-d device tensor
        x = _lookup(tok, params["embed"])
        dev = x.device
        if cfg.is_encdec:
            pe = sinusoidal_at(pos, cfg.d_model, dev).to(x.dtype)
            x = x + pe[None, None]
            cos = sin = None
        elif cfg.mrope and "positions" in step_batch:
            cos, sin = mrope_cos_sin(step_batch["positions"],
                                     cfg.resolved_head_dim, cfg.rope_theta,
                                     cfg.mrope_sections)
        else:
            p11 = (pos.reshape(1, 1) if isinstance(pos, torch.Tensor)
                   else torch.full((1, 1), pos, dtype=torch.int32,
                                   device=dev))
            cos, sin = rope_cos_sin(p11, cfg.resolved_head_dim,
                                    cfg.rope_theta)

        new_state = dict(state)
        if "dense" in state:
            x, new_state["dense"] = tf.apply_dense_prefix_decode(
                cfg, params, x, pos, state["dense"], cos, sin)
        x, new_state["units"] = tf.apply_units_decode(
            cfg, params, x, pos, state["units"], cos, sin,
            cross_kvs=state.get("cross"))
        return _logits(cfg, params, x), new_state

    return Model(
        cfg=cfg,
        init=init,
        forward=forward,
        loss=loss,
        loss_and_grad=loss_and_grad,
        train_step=train_step,
        init_decode_state=init_decode_state,
        prefill=prefill,
        prefill_sequential=prefill_sequential,
        decode_step=decode_step,
        optimizer=opt,
    )
