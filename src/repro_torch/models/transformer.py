"""Config-driven block stack: init + apply for train / prefill / decode.

The counterpart of the JAX package's ``models/transformer.py``. Layers are
grouped into repeating *units* (one period of ``cfg.pattern``); unit
parameters are stacked along a leading axis, as in the reference's tree,
and the stack is applied by a Python loop over that axis that indexes the
stacked leaves (the reference's ``lax.scan``). Heterogeneous hybrids
(Jamba's 7:1 mamba:attn, xLSTM's mLSTM/sLSTM alternation) are handled by
the per-position sub-block types inside a unit.

Caches mirror the unit structure: ``cache['units']['b<j>']`` holds the
per-unit-stacked state for pattern position j (KV rings for attention,
SSM/LSTM states for recurrent mixers), filled in place.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import scan_config, ssm
from repro_torch.models.layers import (dense_init, draw_device, dtype_of,
                                       embed_init, rms_norm,
                                       sinusoidal_positions)
from repro_torch.sharding import activations as act
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten

PyTree = Any

ATTN_MIXERS = ("attn", "swa")


class _Recurrent(NamedTuple):
    """The functions that serve one recurrent mixer kind."""
    init: Callable          # (cfg, generator) -> params
    train: Callable         # (p, cfg, x) -> h
    prefill: Callable       # (p, cfg, x) -> (h, state)
    decode: Callable        # (p, cfg, x, state) -> (h, state)
    init_state: Callable    # (cfg, batch, dtype, device, lead) -> state


RECURRENT = {
    "mamba": _Recurrent(ssm.init_mamba, ssm.mamba_train, ssm.mamba_prefill,
                        ssm.mamba_decode, ssm.init_mamba_state),
    "mlstm": _Recurrent(
        ssm.init_mlstm, ssm.mlstm_train,
        lambda p, cfg, x: ssm.mlstm_train(p, cfg, x, return_state=True),
        ssm.mlstm_decode,
        lambda cfg, b, dtype, device, lead: ssm.init_mlstm_state(
            cfg, b, device, lead=lead)),
    "slstm": _Recurrent(
        ssm.init_slstm, ssm.slstm_train,
        lambda p, cfg, x: ssm.slstm_train(p, cfg, x, return_state=True),
        ssm.slstm_decode,
        lambda cfg, b, dtype, device, lead: ssm.init_slstm_state(
            cfg, b, device, lead=lead)),
}


def _recurrent(mixer: str) -> _Recurrent:
    if mixer not in RECURRENT:
        raise ValueError(f"unknown mixer {mixer}")
    return RECURRENT[mixer]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(cfg: ArchConfig, generator: torch.Generator, mixer: str,
                ffn: str, cross: bool = False,
                d_ff: Optional[int] = None) -> dict:
    dt = dtype_of(cfg.param_dtype)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt,          # noqa: E731
                              device=draw_device(generator))
    p: dict = {"norm1": ones()}
    if mixer in ATTN_MIXERS:
        p["mixer"] = attn.init_attention(cfg, generator)
    else:
        p["mixer"] = _recurrent(mixer).init(cfg, generator)
    if cross:
        p["norm_x"] = ones()
        p["cross"] = attn.init_attention(cfg, generator, cross=True)
    if ffn == "mlp":
        p["norm2"] = ones()
        p["ffn"] = ffn_mod.init_mlp(cfg, generator, d_ff=d_ff)
    elif ffn == "moe":
        p["norm2"] = ones()
        p["ffn"] = moe_mod.init_moe(cfg, generator)
    return p


def _stack_init(fn: Callable[[], PyTree], n: int, device) -> PyTree:
    """``n`` draws of ``fn()`` stacked into ``(n, ...)`` leaves on
    ``device``: each stacked leaf is allocated once and filled a unit at a
    time, so the peak holds the stack and one unit's draw."""
    leaves, treedef = tree_flatten(fn())
    stacked = [torch.empty((n, *x.shape), dtype=x.dtype, device=device)
               for x in leaves]
    for u in range(n):
        if u:
            leaves = tree_flatten(fn())[0]
        for s, x in zip(stacked, leaves):
            s[u].copy_(x)
        del leaves
    return tree_unflatten(treedef, stacked)


def init_stack(cfg: ArchConfig, generator: torch.Generator,
               device) -> PyTree:
    """The reference's parameter tree (same keys, same stacked shapes),
    drawn from ``generator`` on its device and placed on ``device``."""
    dt = dtype_of(cfg.param_dtype)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt,          # noqa: E731
                              device=device)
    params: dict = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dt).to(device),
        "norm_f": ones(),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab,
                                       dt).to(device)

    if cfg.first_k_dense:
        d_ff = cfg.d_ff_dense or cfg.d_ff
        params["dense_blocks"] = _stack_init(
            lambda: _init_block(cfg, generator, "attn", "mlp", d_ff=d_ff),
            cfg.first_k_dense, device)

    params["units"] = {
        f"b{j}": _stack_init(
            lambda m=mixer, f_=f: _init_block(cfg, generator, m, f_,
                                              cross=cfg.is_encdec),
            cfg.n_units, device)
        for j, (mixer, f) in enumerate(cfg.pattern)}

    if cfg.is_encdec:
        params["audio_proj"] = dense_init(generator, cfg.d_model,
                                          cfg.d_model, dt).to(device)
        params["encoder_blocks"] = _stack_init(
            lambda: _init_block(cfg, generator, "attn", "mlp"),
            cfg.n_encoder_layers, device)
        params["enc_norm_f"] = ones()
    if cfg.arch_type == "vlm":
        params["patch_proj"] = dense_init(generator, cfg.d_model,
                                          cfg.d_model, dt).to(device)
    return params


def _unit(stack: PyTree, u: int) -> PyTree:
    """Unit ``u`` of a stacked tree: views of its leaves."""
    return tree_map(lambda a: a[u], stack)


def _n_stacked(stack: PyTree) -> int:
    return tree_flatten(stack)[0][0].shape[0]


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _store(cache: dict, new: dict) -> None:
    """Copy a recurrent mixer's new state into its cache, in place."""
    for k, v in new.items():
        cache[k].copy_(act.like("aten::copy_ (recurrent state)", v,
                                cache[k]))


def _ffn_residual(cfg: ArchConfig, bp: dict, x, cross_kv):
    """Cross-attention and the feed-forward after the mixer's residual.
    Returns (x, aux): the MoE's auxiliaries, ``{}`` for any other block."""
    aux: dict = {}
    if cross_kv is not None:
        h = rms_norm(x, bp["norm_x"], cfg.norm_eps)
        x = x + attn.cross_attn(bp["cross"], cfg, h, cross_kv)
    if "ffn" in bp:
        h = rms_norm(x, bp["norm2"], cfg.norm_eps)
        if "router" in bp["ffn"]:
            h, aux = moe_mod.moe(bp["ffn"], cfg, h)
        else:
            h = ffn_mod.mlp(bp["ffn"], cfg, h)
        x = act.residual(x + h)
    return x, aux


def _apply_block_train(cfg: ArchConfig, bp: dict, mixer: str, f: str, x,
                       cos, sin, cross_kv=None, causal=True):
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    if mixer in ATTN_MIXERS:
        h = attn.attn_train(bp["mixer"], cfg, h, cos, sin, causal=causal)
    else:
        h = _recurrent(mixer).train(bp["mixer"], cfg, h)
    x = act.residual(act.add("aten::add (residual, a partial sum beside "
                             "a shard)", x, h))
    return _ffn_residual(cfg, bp, x, cross_kv)


def _apply_block_prefill(cfg: ArchConfig, bp: dict, mixer: str, f: str, x,
                         cos, sin, cache, cross_kv=None):
    """Full-sequence pass that also fills the decode cache entry (in
    place). Returns (x, aux)."""
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    if mixer in ATTN_MIXERS:
        h, _ = attn.attn_prefill(bp["mixer"], cfg, h, cos, sin, cache)
    else:
        h, new = _recurrent(mixer).prefill(bp["mixer"], cfg, h)
        _store(cache, new)
    x = act.residual(x + h)
    return _ffn_residual(cfg, bp, x, cross_kv)


def _apply_block_decode(cfg: ArchConfig, bp: dict, mixer: str, f: str, x,
                        pos, cache, cos, sin, cross_kv=None):
    """One token through a block, its cache updated in place; the MoE's
    auxiliaries are dropped, as the reference drops them."""
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    if mixer in ATTN_MIXERS:
        h, _ = attn.attn_decode(bp["mixer"], cfg, h, pos, cache, cos, sin)
    else:
        h, new = _recurrent(mixer).decode(bp["mixer"], cfg, h, cache)
        _store(cache, new)
    x = act.residual(x + h)
    return _ffn_residual(cfg, bp, x, cross_kv)[0]


# ---------------------------------------------------------------------------
# Stack application
# ---------------------------------------------------------------------------

def zero_aux(device) -> dict:
    """The MoE auxiliaries' starting sums: all 0."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("load_balance", "z_loss", "drop_frac")}


def _acc_aux(acc: dict, aux: dict) -> dict:
    """``acc`` plus a block's auxiliaries (``{}`` adds nothing)."""
    if not aux:
        return acc
    return {k: acc[k] + aux[k] for k in acc}


def _stack(n: int, name: str, unit: Callable, carry):
    """``carry = unit(u, carry)`` for u in range(n), ``carry`` what passes
    from unit to unit. While the dry run's counter counts, off the
    gradient path, unit 0 alone is traced, counted ``n`` times
    (``scan_config.loop``): every unit runs the same ops on the same
    shapes."""
    for u in scan_config.loop(name, n):
        carry = unit(u, carry)
    return carry


def _unit_blocks(cfg: ArchConfig, params: PyTree, u: int, caches=None,
                 cross_kvs=None):
    """(block params, mixer, ffn, cache, cross K/V) of unit ``u``, each a
    view of unit u of its stack."""
    for j, (mixer, f) in enumerate(cfg.pattern):
        key = f"b{j}"
        yield (_unit(params["units"][key], u), mixer, f,
               None if caches is None else _unit(caches[key], u),
               None if cross_kvs is None else _unit(cross_kvs[key], u))


def apply_units_train(cfg: ArchConfig, params: PyTree, x, cos, sin,
                      cross_kvs=None, causal=True):
    """The unit stack in train (no cache) mode. Returns (x, aux), aux
    summed block by block in the stack's order."""
    def unit(u, carry):
        x, acc = carry
        for bp, mixer, f, _, ckv in _unit_blocks(cfg, params, u,
                                                 cross_kvs=cross_kvs):
            x, aux = _apply_block_train(cfg, bp, mixer, f, x, cos, sin,
                                        cross_kv=ckv, causal=causal)
            acc = _acc_aux(acc, aux)
        return x, acc

    return _stack(cfg.n_units, "units", unit, (x, zero_aux(x.device)))


def apply_units_prefill(cfg: ArchConfig, params: PyTree, x, cos, sin,
                        caches, cross_kvs=None):
    """The unit stack in parallel-prefill mode: full-sequence compute plus
    cache fill (in place). Returns (x, caches, aux)."""
    def unit(u, carry):
        x, acc = carry
        for bp, mixer, f, c, ckv in _unit_blocks(cfg, params, u, caches,
                                                 cross_kvs):
            x, aux = _apply_block_prefill(cfg, bp, mixer, f, x, cos, sin, c,
                                          cross_kv=ckv)
            acc = _acc_aux(acc, aux)
        return x, acc

    x, acc = _stack(cfg.n_units, "units", unit, (x, zero_aux(x.device)))
    return x, caches, acc


def apply_units_decode(cfg: ArchConfig, params: PyTree, x, pos, caches,
                       cos, sin, cross_kvs=None):
    def unit(u, x):
        for bp, mixer, f, c, ckv in _unit_blocks(cfg, params, u, caches,
                                                 cross_kvs):
            x = _apply_block_decode(cfg, bp, mixer, f, x, pos, c, cos, sin,
                                    cross_kv=ckv)
        return x

    return _stack(cfg.n_units, "units", unit, x), caches


def init_unit_caches(cfg: ArchConfig, batch: int, max_len: int, dtype,
                     device=None) -> PyTree:
    """Stacked (n_units, ...) cache tree for the decode loop: KV rings for
    attention, the recurrent mixers' states."""
    lead = (cfg.n_units,)
    caches = {}
    for j, (mixer, _) in enumerate(cfg.pattern):
        if mixer in ATTN_MIXERS:
            c = attn.init_cache(cfg, batch, max_len, dtype, device, lead=lead)
        else:
            c = _recurrent(mixer).init_state(cfg, batch, dtype, device, lead)
        caches[f"b{j}"] = c
    return caches


# ---------------------------------------------------------------------------
# Dense prefix (deepseek first_k_dense)
# ---------------------------------------------------------------------------

def apply_dense_prefix_train(cfg: ArchConfig, params: PyTree, x, cos, sin):
    if "dense_blocks" not in params:
        return x
    for u in range(_n_stacked(params["dense_blocks"])):
        x, _ = _apply_block_train(cfg, _unit(params["dense_blocks"], u),
                                  "attn", "mlp", x, cos, sin)
    return x


def apply_dense_prefix_prefill(cfg: ArchConfig, params: PyTree, x, cos, sin,
                               caches):
    if "dense_blocks" not in params:
        return x, caches
    for u in range(_n_stacked(params["dense_blocks"])):
        x, _ = _apply_block_prefill(cfg, _unit(params["dense_blocks"], u),
                                    "attn", "mlp", x, cos, sin,
                                    _unit(caches, u))
    return x, caches


def apply_dense_prefix_decode(cfg: ArchConfig, params: PyTree, x, pos,
                              caches, cos, sin):
    if "dense_blocks" not in params:
        return x, caches
    for u in range(_n_stacked(params["dense_blocks"])):
        x = _apply_block_decode(cfg, _unit(params["dense_blocks"], u),
                                "attn", "mlp", x, pos, _unit(caches, u),
                                cos, sin)
    return x, caches


def init_dense_prefix_caches(cfg: ArchConfig, batch: int, max_len: int,
                             dtype, device=None):
    if not cfg.first_k_dense:
        return None
    return attn.init_cache(cfg, batch, max_len, dtype, device,
                           lead=(cfg.first_k_dense,))


# ---------------------------------------------------------------------------
# Whisper encoder
# ---------------------------------------------------------------------------

def apply_encoder(cfg: ArchConfig, params: PyTree, audio_embed):
    """audio_embed (B, F, D) — stub frontend output → encoder hidden."""
    x = audio_embed @ params["audio_proj"]
    pe = torch.from_numpy(sinusoidal_positions(x.shape[1], cfg.d_model))
    x = x + pe.to(device=x.device, dtype=x.dtype)

    def layer(u, x):
        return _apply_block_train(cfg, _unit(params["encoder_blocks"], u),
                                  "attn", "mlp", x, None, None,
                                  causal=False)[0]

    x = _stack(_n_stacked(params["encoder_blocks"]), "encoder_blocks",
               layer, x)
    return rms_norm(x, params["enc_norm_f"], cfg.norm_eps)


def encoder_cross_kvs(cfg: ArchConfig, params: PyTree, enc_out):
    """Per-unit, per-position cross K/V stacks (computed once per request)."""
    def per_stacked(stack):
        kvs = [attn.cross_kv(_unit(stack, u)["cross"], cfg, enc_out)
               for u in range(cfg.n_units)]
        return {k: torch.stack([kv[k] for kv in kvs]) for k in ("k", "v")}

    return {f"b{j}": per_stacked(params["units"][f"b{j}"])
            for j in range(len(cfg.pattern))}
