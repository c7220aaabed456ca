"""Shared parity checks of the port's model zoo against the JAX package's
(``tests/test_torch_model_zoo.py`` for the attention + MLP configs,
``tests/test_torch_model_zoo_7b.py`` for the MoE and recurrent ones), from
the JAX package's own initial weights carried across with
``repro_torch.convert``. Not a test module: the two files call these.

Float32, per config: ``loss`` within ``rtol=1e-5``; the params after one
``train_step`` within ``rtol=1e-4, atol=1e-6`` (a gradient sums over the
batch and the sequence in another order in XLA and ATen); ``prefill``'s
last logits, one ``decode_step`` after it, ``prefill_sequential`` and the
caches within ``rtol=1e-4, atol=1e-5``; the reduced Jamba within the
looser bounds stated at ``STEP_OF`` and ``SERVE_OF``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model as tbuild
from repro_torch.utils import tree_flatten, tree_leaves

B, S = 2, 32
LOSS = dict(rtol=1e-5, atol=1e-6)
STEP = dict(rtol=1e-4, atol=1e-6)
SERVE = dict(rtol=1e-4, atol=1e-5)
# The reduced Jamba is 8 blocks deep, four times the others: each entry of
# the embedding's gradient sums the gradients of the positions holding its
# token, each back through 8 blocks, and entries near 1e-4 (the leaf's
# largest is 1.08) drift by up to 7.3e-6 in float32. A sequential Mamba
# scan in place of the log-depth one drifts as far (6.7e-6), so it is the
# depth's summation order, not the scan's.
STEP_OF = {"jamba-1.5-large-398b": dict(rtol=1e-4, atol=1e-5)}
# Its logits, by the same depth, drift by up to 1.2e-5 on entries near
# 1e-2 (measured; the largest logits are near 2), so its serving checks
# allow 3e-5.
SERVE_OF = {"jamba-1.5-large-398b": dict(rtol=1e-4, atol=3e-5)}


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    return np.asarray(x, np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), _np(j), **tol)


def _paths(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape),
             str(x.dtype).replace("torch.", ""))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def param_tree_carries_across(arch, dtype):
    """The reduced config's tree in ``dtype``, carried across and drawn by
    the port: the JAX tree's paths, shapes and dtypes, in its order."""
    jcfg = jget(arch).reduced().replace(param_dtype=dtype)
    jp = jax.tree_util.tree_map(np.asarray,
                                jbuild(jcfg).init(jax.random.PRNGKey(0)))
    carried = params_from_numpy(jp, device="cpu")
    own = tbuild(tget(arch).reduced().replace(param_dtype=dtype)).init(
        torch.Generator().manual_seed(0), device="cpu")
    want = _paths(jp)
    for tree in (carried, own):
        assert _paths(tree) == want
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
        "train_step", "prefill", "decode_step", "prefill_sequential")}
    return jcfg, jm, tm, jp, tp, jb, tb, fns


def loss_and_train_step_match(arch):
    """``loss`` (auxiliaries included), one ``train_step`` and
    ``loss_and_grad`` against the JAX model's."""
    _, jm, tm, jp, tp, jb, tb, fns = _pair(arch)
    # the reference's loss and auxiliaries as its train_step reports them
    # (one compile a config, not two)
    jp2, jo2, jmet = fns["train_step"](jp, jm.optimizer.init(jp), jb,
                                       jnp.float32(0.01))
    jl = jmet["loss"]
    tl, taux = tm.loss(tp, tb)
    _close(tl, jl, LOSS)
    assert sorted(["loss", "grad_norm", *taux]) == sorted(jmet)
    for k in taux:
        _close(taux[k], jmet[k], LOSS)
    tp2, to2, tmet = tm.train_step(tp, tm.optimizer.init(tp), tb, 0.01)
    assert sorted(tmet) == sorted(jmet)
    step = STEP_OF.get(arch, STEP)
    _close(tmet["grad_norm"], jmet["grad_norm"], step)
    for a, b in zip(tree_leaves(tp2), jax.tree_util.tree_leaves(jp2)):
        _close(a, b, step)
    for a, b in zip(tree_leaves(to2), jax.tree_util.tree_leaves(jo2)):
        _close(a, b, step)
    # the worker-shaped helper: the loss, gradients shaped as the params,
    # and a loader's (tokens,) batch taken as {"tokens": ...}
    (l2, _), grads = tm.loss_and_grad(tp, tb)
    _close(l2, jl, LOSS)
    assert [g.shape for g in tree_leaves(grads)] == \
        [p.shape for p in tree_leaves(tp)]
    if set(tb) == {"tokens"}:
        assert torch.equal(tm.loss_and_grad(tp, (tb["tokens"],))[0][0], l2)


def prefill_decode_and_sequential_match(arch):
    """``prefill`` then one ``decode_step``, and ``prefill_sequential``,
    logits and caches, against the JAX model's."""
    cfg, jm, tm, jp, tp, jb, tb, fns = _pair(arch)
    serve = SERVE_OF.get(arch, SERVE)
    js = jm.init_decode_state(B, 2 * S)
    ts = tm.init_decode_state(B, 2 * S, device="cpu")
    jlog, js = fns["prefill"](jp, jb, js)
    with torch.no_grad():
        tlog, ts = tm.prefill(tp, tb, ts)
    _close(tlog, jlog, serve)
    tok = np.argmax(_np(jlog), -1).astype(np.int32)
    jsb = {"token": jnp.asarray(tok), "pos": jnp.asarray(S, jnp.int32)}
    tsb = {"token": torch.from_numpy(tok), "pos": torch.tensor(S)}
    if cfg.mrope:
        jsb["positions"] = jnp.full((3, B, 1), S, jnp.int32)
        tsb["positions"] = torch.full((3, B, 1), S, dtype=torch.int32)
    jlog, js = fns["decode_step"](jp, js, jsb)
    with torch.no_grad():
        tlog, ts = tm.decode_step(tp, ts, tsb)
    _close(tlog, jlog, serve)
    for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        _close(a, b, serve)
    js = jm.init_decode_state(B, 2 * S)
    ts = tm.init_decode_state(B, 2 * S, device="cpu")
    jlog, js = fns["prefill_sequential"](jp, jb, js)
    with torch.no_grad():
        tlog, ts = tm.prefill_sequential(tp, tb, ts)
    _close(tlog, jlog, serve)
    for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        _close(a, b, serve)
