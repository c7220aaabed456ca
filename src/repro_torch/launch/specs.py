"""Abstract inputs per (architecture × input shape) for the dry run, the
JAX package's ``launch/specs.py`` over DTensor.

``input_specs`` returns the step function and its arguments as ``meta``
DTensors placed by ``param_specs`` / ``batch_spec`` / ``cache_specs``:
shapes, dtypes and placements, no data, no device memory (the counterpart
of ``ShapeDtypeStruct``s with ``NamedSharding``s).

Input shapes (assigned):
  train_4k     seq 4096,   global_batch 256   (training)      -> train_step
  prefill_32k  seq 32768,  global_batch 32    (prefill)       -> prefill
  decode_32k   seq 32768 cache, global_batch 128 (decode)     -> decode_step
  long_500k    seq 524288 cache, global_batch 1  (long decode)-> decode_step
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import momentum
from repro_torch.sharding.specs import (P, batch_spec, cache_specs,
                                        param_specs, placements, spec_leaves)
from repro_torch.utils import tree_flatten, tree_unflatten

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def shape_supported(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    info = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.supports_long_decode:
        return False, ("full-attention architecture: 500k decode cache is "
                       "quadratic-history; skipped per DESIGN.md §4")
    if info["kind"] == "decode" and not cfg.supports_decode:
        return False, "encoder-only architecture has no decode step"
    return True, ""


def placed(shape, dtype, mesh, spec) -> torch.Tensor:
    """A ``meta`` DTensor of global ``shape`` with the placements of
    ``spec`` on ``mesh`` (this rank's shard, no data)."""
    from torch.distributed.tensor import DTensor, Shard

    pl = placements(spec, mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    x = torch.empty(local, dtype=dtype, device="meta")
    return DTensor.from_local(x, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def tree_placed(tree, mesh, spec_tree):
    """``tree``'s leaves as :func:`placed` DTensors by ``spec_tree``."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        placed(x.shape, x.dtype, mesh, s)
        for x, s in zip(leaves, spec_leaves(spec_tree))])


@dataclass
class StepSpec:
    fn: Callable          # to trace
    args: tuple           # meta DTensors


def _extra_batch(cfg: ArchConfig, mesh, batch: int, seq: int,
                 dtype) -> dict:
    """Modality-stub inputs (brief carve-out): precomputed embeddings."""
    extras = {}
    data_spec = batch_spec(mesh, batch, extra_dims=2)
    if cfg.arch_type == "vlm":
        n_p = min(cfg.n_patches, seq)
        extras["vision_embed"] = placed((batch, n_p, cfg.d_model), dtype,
                                        mesh, data_spec)
        extras["positions"] = placed((3, batch, seq), torch.int32, mesh,
                                     P(None, *batch_spec(mesh, batch, 1)))
    if cfg.is_encdec:
        extras["audio_embed"] = placed((batch, cfg.n_frames, cfg.d_model),
                                       dtype, mesh, data_spec)
    return extras


def input_specs(cfg: ArchConfig, shape_name: str, mesh) -> StepSpec:
    """Build the (function, abstract-args) pair for one dry-run combo."""
    info = SHAPES[shape_name]
    seq, batch = info["seq"], info["batch"]
    cfg = cfg.replace(param_dtype="bfloat16")
    model = build_model(cfg, optimizer=momentum(accum_dtype=torch.bfloat16))
    dtype = torch.bfloat16

    params_shape = model.init(None, device="meta")
    params = tree_placed(params_shape, mesh,
                          param_specs(params_shape, mesh))
    tok_spec = batch_spec(mesh, batch, extra_dims=1)

    if info["kind"] == "train":
        opt_shape = model.optimizer.init(params_shape)
        opt_state = tree_placed(opt_shape, mesh,
                                 param_specs(opt_shape, mesh))
        batch_tree = {
            "tokens": placed((batch, seq), torch.int32, mesh, tok_spec),
            **_extra_batch(cfg, mesh, batch, seq, dtype),
        }
        return StepSpec(fn=model.train_step,
                        args=(params, opt_state, batch_tree, 1e-3))

    state_shape = model.init_decode_state(batch, seq, device="meta")
    state = tree_placed(state_shape, mesh,
                         cache_specs(state_shape, mesh, batch))
    if info["kind"] == "prefill":
        batch_tree = {
            "tokens": placed((batch, seq), torch.int32, mesh, tok_spec),
            **_extra_batch(cfg, mesh, batch, seq, dtype),
        }
        return StepSpec(fn=model.prefill, args=(params, batch_tree, state))

    # decode: one new token against a seq-length cache
    step_batch: dict[str, Any] = {
        "token": placed((batch, 1), torch.int32, mesh,
                        batch_spec(mesh, batch, 1)),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }
    if cfg.mrope:
        step_batch["positions"] = placed(
            (3, batch, 1), torch.int32, mesh,
            P(None, *batch_spec(mesh, batch, 1)))
    return StepSpec(fn=model.decode_step, args=(params, state, step_batch))
