"""The reference's attention and LSTM toggles, set in both packages.

Both packages let a caller choose blocked attention on the gradient path
(``set_attn_block``, ``None`` materializes the scores: the default), the
prefill block (``set_attn_block_prefill``, 512 by default) and the LSTM
checkpoint chunk (``set_lstm_chunk``, 64 by default; ``None`` the naive
loop). Here the port is held to the reference under each setting, made in
both packages through their setters:

* ``set_attn_block(32)``: reduced ``qwen3-14b`` at S = 256, causal and
  with a 64-token window, ``attn_train`` and the model's loss and
  gradients within ``rtol=1e-4, atol=1e-5`` (``tests/test_parity.py``'s
  bound for the blocked path) of the JAX package's at the same block; the
  port's default, materialized route is held to the same numbers;
* ``prefill``'s last logits and caches at 16- and 64-key prefill blocks
  (64: the prompt is one block, the path materializes) and at ``None``
  against the JAX package's at the same block, within the zoo's serving
  bound;
* reduced ``xlstm-350m`` at 2 layers, S = 32: the loss within 1e-5 and
  the gradients within ``rtol=1e-4, atol=1e-5`` of the JAX package's at
  the same chunk (16, 64 and ``None``), and at 16-step chunks against its
  naive loop;
* ``utils.tree_bytes`` equal to the JAX package's.

Each toggle is restored in ``finally``, in both packages.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import ssm as jssm
from repro.models.layers import rope_cos_sin as jrope
from repro_torch import utils as tutils
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import rope_cos_sin as trope
from repro_torch.utils import tree_leaves

BLOCKED = dict(rtol=1e-4, atol=1e-5)       # tests/test_parity.py:85-107
SERVE = dict(rtol=1e-4, atol=1e-5)         # tests/_zoo_parity.py


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
    return np.asarray(x, np.float32)


_WEIGHTS: dict = {}


def _pair(arch: str, **replace):
    """The reduced ``arch`` in both packages and one set of weights in
    each: drawn once an arch and depth by the port on the CPU, carried
    into the JAX package's tree (the same paths)."""
    jcfg = jget(arch).reduced().replace(**replace)
    tcfg = tget(arch).reduced().replace(**replace)
    key = (arch, tcfg.n_layers)
    if key not in _WEIGHTS:
        own = tbuild(tcfg).init(torch.Generator().manual_seed(0),
                                device="cpu")
        _WEIGHTS[key] = jax.tree_util.tree_map(
            lambda t: t.numpy(), own,
            is_leaf=lambda x: isinstance(x, torch.Tensor))
    w = _WEIGHTS[key]
    return (jcfg, jbuild(jcfg), tbuild(tcfg),
            jax.tree_util.tree_map(jnp.asarray, w),
            params_from_numpy(w, device="cpu"))


def _jax_loss_and_grad(jm, toks):
    return jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)}), has_aux=True))


def _tokens(cfg, b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (b, s)).astype(np.int32)


@contextlib.contextmanager
def _setting(name: str, own, ref, default):
    """Set a toggle in both packages (``set_<name>``), and restore both to
    ``default`` after."""
    jmod = jssm if name == "lstm_chunk" else jattn
    tmod = tssm if name == "lstm_chunk" else tattn
    try:
        getattr(jmod, f"set_{name}")(ref)
        getattr(tmod, f"set_{name}")(own)
        yield
    finally:
        getattr(jmod, f"set_{name}")(default)
        getattr(tmod, f"set_{name}")(default)


class _Counted:
    """Counts the calls of the port's blocked attention."""

    def __init__(self, monkeypatch):
        self.n = 0
        inner = tattn._blocked

        def counted(*a, **kw):
            self.n += 1
            return inner(*a, **kw)

        monkeypatch.setattr(tattn, "_blocked", counted)


# --------------------------------------------------------------------------
# attention blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 64])
def test_attn_train_holds_to_the_blocked_gradient_path(monkeypatch, window):
    cfg = jget("qwen3-14b").reduced().replace(sliding_window=window)
    tcfg = tget("qwen3-14b").reduced().replace(sliding_window=window)
    tp = tattn.init_attention(tcfg, torch.Generator().manual_seed(0))
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    x = np.random.default_rng(1).standard_normal(
        (2, 256, cfg.d_model)).astype(np.float32)
    jcs = jrope(jnp.arange(256)[None], cfg.resolved_head_dim,
                cfg.rope_theta)
    tcs = trope(torch.arange(256)[None], tcfg.resolved_head_dim,
                tcfg.rope_theta)
    calls = _Counted(monkeypatch)
    grads = []
    for own in (None, 32):                   # materialized, then blocked
        with _setting("attn_block", own, 32, None):
            if own is None:
                want = jattn.attn_train(jp, cfg, jnp.asarray(x), *jcs)
            xt = torch.from_numpy(x).requires_grad_()
            got = tattn.attn_train(tp, tcfg, xt, *tcs)
            got.square().sum().backward()
        assert calls.n == (0 if own is None else 1)
        assert xt.grad is not None and torch.isfinite(xt.grad).all()
        np.testing.assert_allclose(_np(got), _np(want), **BLOCKED)
        grads.append(xt.grad)
    np.testing.assert_allclose(_np(grads[1]), _np(grads[0]), **BLOCKED)


@pytest.mark.parametrize("window", [None, 64])
def test_loss_and_grad_hold_to_the_blocked_gradient_path(monkeypatch,
                                                         window):
    cfg, jm, tm, jp, tp = _pair("qwen3-14b", sliding_window=window)
    toks = _tokens(cfg, 2, 256)
    calls = _Counted(monkeypatch)
    with _setting("attn_block", None, 32, None):
        (jl, _), jg = _jax_loss_and_grad(jm, toks)(jp)
    for own in (None, 32):                   # materialized, then blocked
        with _setting("attn_block", own, None, None):
            (tl, _), tg = tm.loss_and_grad(tp,
                                           {"tokens": torch.from_numpy(toks)})
        assert calls.n == (0 if own is None else cfg.n_layers)
        np.testing.assert_allclose(_np(tl), _np(jl), **BLOCKED)
        for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
            np.testing.assert_allclose(_np(a), _np(b), **BLOCKED)


@pytest.mark.parametrize("block,window", [(16, None), (64, None), (16, 32),
                                          (None, None)])
def test_prefill_block(monkeypatch, block, window):
    cfg, jm, tm, jp, tp = _pair("qwen3-14b", sliding_window=window)
    toks = _tokens(cfg, 2, 64)
    calls = _Counted(monkeypatch)
    with _setting("attn_block_prefill", block, block, 512):
        jlog, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                              jm.init_decode_state(2, 80))
        with torch.no_grad():
            tlog, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                  tm.init_decode_state(2, 80, device="cpu"))
    assert calls.n == (cfg.n_layers if block and block < 64 else 0)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **SERVE)
    for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(_np(a), _np(b), **SERVE)


@pytest.mark.parametrize("name,own,ref", [
    ("ATTN_BLOCK_PREFILL", lambda: tattn.ATTN_BLOCK_PREFILL[0],
     lambda: jattn.ATTN_BLOCK_PREFILL[0]),
    ("LSTM_CHUNK", lambda: tssm.LSTM_CHUNK[0], lambda: jssm.LSTM_CHUNK[0]),
    ("ATTN_BLOCK", lambda: tattn.ATTN_BLOCK[0],
     lambda: jattn.ATTN_BLOCK[0])])
def test_constants_are_the_reference_s_defaults(name, own, ref):
    assert own() == ref(), name
    assert jattn.ATTN_BLOCK[0] is None       # the reference materializes too
    assert tattn.ATTN_BLOCK[0] is None


# --------------------------------------------------------------------------
# LSTM chunks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("own,ref", [(16, 16), (64, 64), (16, None),
                                     (None, None)])
def test_lstm_chunk_loss_and_grad(own, ref):
    cfg, jm, tm, jp, tp = _pair("xlstm-350m", n_layers=2)
    toks = _tokens(cfg, 2, 32)        # two 16-step chunks; 64: one loop
    with _setting("lstm_chunk", own, ref, 64):
        (jl, _), jg = _jax_loss_and_grad(jm, toks)(jp)
        (tl, _), tg = tm.loss_and_grad(tp,
                                       {"tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(jl)) < 1e-5
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(_np(a), _np(b), **BLOCKED)


# --------------------------------------------------------------------------
# utils
# --------------------------------------------------------------------------

def test_tree_bytes():
    rng = np.random.default_rng(5)
    x = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": [rng.integers(0, 9, (5,)).astype(np.int32),
               rng.standard_normal((2,)).astype(np.float16)]}
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    tx = params_from_numpy(x, device="cpu")
    assert tutils.tree_bytes(tx) == jutils.tree_bytes(jx) == 12 * 4 + 20 + 4
