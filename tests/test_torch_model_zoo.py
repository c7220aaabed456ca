"""The port's model zoo against the JAX package's: the architecture
registry, every registered config's full-size parameter tree (as shapes),
and ``build_model`` on the seven attention + MLP configs (reduced), from
the JAX package's own initial weights carried across with
``repro_torch.convert``, within the tolerances of ``tests/_zoo_parity.py``
(the MoE and recurrent configs: ``tests/test_torch_model_zoo_7b.py``).
bfloat16: the port's bfloat16 model held to the JAX package's float32
model on the same (bfloat16) weights, within 3% relative L2 on the
logits and 0.2% on the loss (bfloat16 rounds each matmul output and norm
to 8 significant bits, a relative 2^-9 = 0.2% at most, and a 2-layer
stack compounds a few of them; the loss averages its positions' errors).
"""
import dataclasses
import functools
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _zoo_parity import (SERVE, B, S, _close, _np, _pair, _paths,
                         loss_and_train_step_match,
                         param_tree_carries_across,
                         prefill_decode_and_sequential_match)
from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import get_config as jget
from repro.configs import list_configs as jlist
from repro.models import build_model as jbuild
from repro_torch.configs import ASSIGNED as T_ASSIGNED
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_configs as tlist
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.utils import tree_leaves, tree_size

ZOO_7A = ("fedpc-paper", "qwen3-14b", "phi4-mini-3.8b", "mistral-nemo-12b",
          "mistral-large-123b", "whisper-medium", "qwen2-vl-7b")


def test_registry_matches():
    assert tlist() == jlist()
    assert T_ASSIGNED == J_ASSIGNED
    for name in jlist():
        for j, t in ((jget(name), tget(name)),
                     (jget(name).reduced(), tget(name).reduced())):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            for prop in ("resolved_head_dim", "resolved_dt_rank", "n_units",
                         "d_inner", "is_encdec", "supports_long_decode"):
                assert getattr(t, prop) == getattr(j, prop), (name, prop)
    with pytest.raises(KeyError, match="unknown arch"):
        tget("no-such-arch")


@functools.lru_cache(maxsize=None)
def _full_size(arch: str, n_layers: int | None = None) -> tuple:
    """The JAX package's full-size tree of ``arch`` (at ``n_layers``
    layers where given) as (path, shape, dtype), traced with
    ``jax.eval_shape`` (nothing allocated)."""
    cfg = jget(arch) if n_layers is None else jget(arch).replace(
        n_layers=n_layers)
    return tuple(_paths(jax.eval_shape(jbuild(cfg).init,
                                       jax.random.PRNGKey(0))))


@pytest.mark.parametrize("arch", jlist())
def test_every_config_builds_at_full_size(arch):
    # shapes and dtypes only: the port's init with no generator draws
    # nothing and puts every leaf on the meta device
    own = tbuild(tget(arch)).init(None, device="meta")
    assert all(x.is_meta for x in tree_leaves(own))
    want = _full_size(arch)
    assert _paths(own) == list(want)
    assert tree_size(own) == sum(math.prod(s) for _, s, _ in want)


@functools.lru_cache(maxsize=None)
def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_param_counts_are_the_reference_s():
    smoke = _smoke()
    assert set(smoke.ZOO_ARCHS) <= set(smoke.SERVE_PARAMS_OF)
    for arch, n in smoke.SERVE_PARAMS_OF.items():
        assert n == sum(math.prod(s) for _, s, _ in _full_size(arch)), arch
    # the served depth of a cut bfloat16 run
    assert set(smoke.SERVE_CUT_PARAMS_OF) == set(smoke.SERVE_LAYERS_OF)
    for arch, n in smoke.SERVE_CUT_PARAMS_OF.items():
        tree = _full_size(arch, smoke.SERVE_LAYERS_OF[arch])
        assert n == sum(math.prod(s) for _, s, _ in tree), arch


@pytest.mark.parametrize("arch", ["qwen3-14b", "mistral-nemo-12b",
                                  "phi4-mini-3.8b", "qwen2-vl-7b",
                                  "whisper-medium"])
def test_chip_smoke_prefill_bound_counts_the_counter_s_products(arch):
    # The serving bound's matmul products (with attention over every key,
    # as the blocked prefill visits them): the dry run's counter on the
    # same full-size prefill on meta, the encoder, the cross-attention
    # and the adapters included.
    stats, _, every = _smoke()._count_prefill(
        torch, tget(arch).replace(param_dtype="bfloat16"))
    assert stats.flops == pytest.approx(every, rel=1e-9)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    m = tbuild(tget("fedpc-paper").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_decode_state(1, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ZOO_7A)
def test_param_tree_carries_across(arch, dtype):
    param_tree_carries_across(arch, dtype)


@pytest.mark.parametrize("arch", ZOO_7A)
def test_loss_and_train_step_match(arch):
    loss_and_train_step_match(arch)


@pytest.mark.parametrize("arch", ZOO_7A)
def test_prefill_decode_and_sequential_match(arch):
    prefill_decode_and_sequential_match(arch)


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bfloat16_model_holds_to_the_float32_reference():
    cfg, _, tm, jp, tp, jb, tb, _ = _pair("qwen3-14b", "bfloat16")
    assert tget("qwen3-14b").qk_norm
    jm32 = jbuild(cfg.replace(param_dtype="float32"))
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    want_loss, _ = jax.jit(jm32.loss)(jp32, jb)
    with torch.no_grad():
        tl, _ = tm.loss(tp, tb)
        logits, _ = tm.forward(tp, tb)
        last, _ = tm.prefill(tp, tb, tm.init_decode_state(B, S,
                                                          device="cpu"))
    assert logits.dtype == torch.bfloat16
    want_logits = jax.jit(lambda p, b: jm32.prefill(
        p, b, jm32.init_decode_state(B, S))[0])(jp32, jb)
    assert abs(float(tl) - float(want_loss)) <= 2e-3 * abs(float(want_loss))
    assert _rel_l2(logits[:, -1:], want_logits) <= 0.03
    assert _rel_l2(last, want_logits) <= 0.03


def test_blocked_prefill_through_the_model():
    # A 1,024-token prompt takes the blocked path in prefill; with the
    # block widened past the prompt it is materialized: the same logits
    # and caches.
    cfg = tget("qwen3-14b").reduced()
    tm = tbuild(cfg)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 1024)).astype(np.int32))
    outs = []
    try:
        for blk in (512, 1024):
            tattn.set_attn_block_prefill(blk)
            with torch.no_grad():
                outs.append(tm.prefill(tp, {"tokens": toks},
                                       tm.init_decode_state(1, 1024,
                                                            device="cpu")))
    finally:
        tattn.set_attn_block_prefill(512)
    _close(outs[0][0], outs[1][0].numpy(), SERVE)
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        _close(a, b.numpy(), SERVE)
