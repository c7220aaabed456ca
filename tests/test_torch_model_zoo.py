"""The port's model zoo against the JAX package's: the architecture
registry, the parameter tree, and ``build_model`` on the seven
attention + MLP configs (reduced), from the JAX package's own initial
weights carried across with ``repro_torch.convert``.

Float32, per config: ``loss`` within ``rtol=1e-5``; the params after one
``train_step`` within ``rtol=1e-4, atol=1e-6`` (a gradient sums over the
batch and the sequence in another order in XLA and ATen); ``prefill``'s
last logits, one ``decode_step`` after it, ``prefill_sequential`` and the
caches within ``rtol=1e-4, atol=1e-5``. bfloat16: the port's bfloat16
model held to the JAX package's float32 model on the same (bfloat16)
weights, within 3% relative L2 on the logits and 0.2% on the loss
(bfloat16 rounds each matmul output and norm to 8 significant bits, a
relative 2^-9 = 0.2% at most, and a 2-layer stack compounds a few of
them; the loss averages its positions' errors). A model with a recurrent mixer or MoE raises
``NotImplementedError``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import get_config as jget
from repro.configs import list_configs as jlist
from repro.models import build_model as jbuild
from repro_torch.configs import ASSIGNED as T_ASSIGNED
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_configs as tlist
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.utils import tree_flatten, tree_leaves

ZOO_7A = ("fedpc-paper", "qwen3-14b", "phi4-mini-3.8b", "mistral-nemo-12b",
          "mistral-large-123b", "whisper-medium", "qwen2-vl-7b")
ZOO_7B = ("deepseek-moe-16b", "grok-1-314b", "jamba-1.5-large-398b",
          "xlstm-350m")
B, S = 2, 32
LOSS = dict(rtol=1e-5, atol=1e-6)
STEP = dict(rtol=1e-4, atol=1e-6)
SERVE = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    return np.asarray(x, np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), _np(j), **tol)


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


@pytest.mark.parametrize("arch", ZOO_7B)
def test_unported_mixers_raise(arch):
    with pytest.raises(NotImplementedError, match="7b"):
        tbuild(tget(arch).reduced())


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    m = tbuild(tget("fedpc-paper").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_decode_state(1, 8)


def _paths(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ZOO_7A)
def test_param_tree_carries_across(arch, dtype):
    jcfg = jget(arch).reduced().replace(param_dtype=dtype)
    jp = jax.tree_util.tree_map(np.asarray,
                                jbuild(jcfg).init(jax.random.PRNGKey(0)))
    carried = params_from_numpy(jp, device="cpu")
    own = tbuild(tget(arch).reduced().replace(param_dtype=dtype)).init(
        torch.Generator().manual_seed(0), device="cpu")
    want = _paths(jp)
    for tree in (carried, own):
        got = [(jax.tree_util.keystr(p), tuple(x.shape),
                str(x.dtype).replace("torch.", ""))
               for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]
        assert got == want
    # the flat layout's leaf order is the JAX order
    assert [tuple(x.shape) for x in tree_flatten(own)[0]] == \
        [s for _, s, _ in want]


def _batch(cfg, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.mrope:
        batch["positions"] = np.broadcast_to(
            np.arange(S)[None, None], (3, B, S)).astype(np.int32)
    if cfg.is_encdec:
        batch["audio_embed"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "vlm":
        batch["vision_embed"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str = "float32"):
    """Both packages' models of one reduced config, the JAX weights, the
    port's copy of them, a batch in both forms and the jitted JAX
    functions (compiled once a config)."""
    jcfg = jget(arch).reduced().replace(param_dtype=dtype)
    jm, tm = jbuild(jcfg), tbuild(tget(arch).reduced().replace(
        param_dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    b = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    fns = {name: jax.jit(getattr(jm, name)) for name in (
        "loss", "train_step", "prefill", "decode_step",
        "prefill_sequential")}
    return jcfg, jm, tm, jp, tp, jb, tb, fns


@pytest.mark.parametrize("arch", ZOO_7A)
def test_loss_and_train_step_match(arch):
    _, jm, tm, jp, tp, jb, tb, fns = _pair(arch)
    jl, jaux = fns["loss"](jp, jb)
    tl, taux = tm.loss(tp, tb)
    _close(tl, jl, LOSS)
    assert sorted(taux) == sorted(jaux)
    jp2, jo2, jmet = fns["train_step"](jp, jm.optimizer.init(jp), jb,
                                       jnp.float32(0.01))
    tp2, to2, tmet = tm.train_step(tp, tm.optimizer.init(tp), tb, 0.01)
    assert sorted(tmet) == sorted(jmet)
    _close(tmet["grad_norm"], jmet["grad_norm"], STEP)
    for a, b in zip(tree_leaves(tp2), jax.tree_util.tree_leaves(jp2)):
        _close(a, b, STEP)
    for a, b in zip(tree_leaves(to2), jax.tree_util.tree_leaves(jo2)):
        _close(a, b, STEP)
    # the worker-shaped helper: the loss, gradients shaped as the params,
    # and a loader's (tokens,) batch taken as {"tokens": ...}
    (l2, _), grads = tm.loss_and_grad(tp, tb)
    _close(l2, jl, LOSS)
    assert [g.shape for g in tree_leaves(grads)] == \
        [p.shape for p in tree_leaves(tp)]
    if set(tb) == {"tokens"}:
        assert torch.equal(tm.loss_and_grad(tp, (tb["tokens"],))[0][0], l2)


@pytest.mark.parametrize("arch", ZOO_7A)
def test_prefill_decode_and_sequential_match(arch):
    cfg, jm, tm, jp, tp, jb, tb, fns = _pair(arch)
    js = jm.init_decode_state(B, 2 * S)
    ts = tm.init_decode_state(B, 2 * S, device="cpu")
    jlog, js = fns["prefill"](jp, jb, js)
    with torch.no_grad():
        tlog, ts = tm.prefill(tp, tb, ts)
    _close(tlog, jlog, SERVE)
    tok = np.argmax(_np(jlog), -1).astype(np.int32)
    jsb = {"token": jnp.asarray(tok), "pos": jnp.asarray(S, jnp.int32)}
    tsb = {"token": torch.from_numpy(tok), "pos": torch.tensor(S)}
    if cfg.mrope:
        jsb["positions"] = jnp.full((3, B, 1), S, jnp.int32)
        tsb["positions"] = torch.full((3, B, 1), S, dtype=torch.int32)
    jlog, js = fns["decode_step"](jp, js, jsb)
    with torch.no_grad():
        tlog, ts = tm.decode_step(tp, ts, tsb)
    _close(tlog, jlog, SERVE)
    for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        _close(a, b, SERVE)
    js = jm.init_decode_state(B, 2 * S)
    ts = tm.init_decode_state(B, 2 * S, device="cpu")
    jlog, js = fns["prefill_sequential"](jp, jb, js)
    with torch.no_grad():
        tlog, ts = tm.prefill_sequential(tp, tb, ts)
    _close(tlog, jlog, SERVE)
    for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        _close(a, b, SERVE)


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


def test_blocked_prefill_through_the_model(monkeypatch):
    # A 1,024-token prompt takes the blocked path in prefill; with the
    # block widened past the prompt it is materialized: the same logits
    # and caches.
    cfg = tget("qwen3-14b").reduced()
    tm = tbuild(cfg)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 1024)).astype(np.int32))
    outs = []
    for blk in (512, 1024):
        monkeypatch.setattr(tattn, "ATTN_BLOCK_PREFILL", blk)
        with torch.no_grad():
            outs.append(tm.prefill(tp, {"tokens": toks},
                                   tm.init_decode_state(1, 1024,
                                                        device="cpu")))
    _close(outs[0][0], outs[1][0].numpy(), SERVE)
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        _close(a, b.numpy(), SERVE)
