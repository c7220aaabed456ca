"""The reference's attention and LSTM toggles against the port's one route.

The JAX package lets a caller choose its blocked attention on the
gradient path (``set_attn_block``), the prefill block
(``set_attn_block_prefill``) and the LSTM checkpoint chunk, ``None`` the
naive loop (``set_lstm_chunk``). Nothing outside its tests sets them, so
the port keeps one route: the gradient path materializes its scores,
``ATTN_BLOCK_PREFILL`` and ``LSTM_CHUNK`` are module constants (the tests
below ``monkeypatch`` them). Here that route is held to the reference
under each of its settings:

* the port's materialized gradient path, with a 32-key prefill block, is
  held to the JAX package's 32-key blocked gradient path: reduced
  ``qwen3-14b`` at S = 256, causal and with a 64-token window,
  ``attn_train`` and the model's loss and gradients within ``rtol=1e-4,
  atol=1e-5`` (``tests/test_parity.py``'s bound for the blocked path);
* ``prefill``'s last logits and caches at 16- and 64-key prefill blocks
  (64: the prompt is one block, the path materializes) against the JAX
  package's at the same block, within the zoo's serving bound;
* reduced ``xlstm-350m`` at 2 layers, S = 32: the loss within 1e-5 and
  the gradients within ``rtol=1e-4, atol=1e-5`` of the JAX package's at
  the same chunk, and at 16-step chunks against its naive loop;
* ``utils.tree_bytes`` equal to the JAX package's.

Each toggle is restored in ``finally`` in the JAX package.
"""
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
    monkeypatch.setattr(tattn, "ATTN_BLOCK_PREFILL", 32)
    try:
        jattn.set_attn_block(32)
        want = jattn.attn_train(jp, cfg, jnp.asarray(x), *jcs)
    finally:
        jattn.set_attn_block(None)
    xt = torch.from_numpy(x).requires_grad_()
    got = tattn.attn_train(tp, tcfg, xt, *tcs)
    got.square().sum().backward()
    assert calls.n == 0                      # the gradient path materializes
    assert xt.grad is not None and torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(_np(got), _np(want), **BLOCKED)


@pytest.mark.parametrize("window", [None, 64])
def test_loss_and_grad_hold_to_the_blocked_gradient_path(monkeypatch,
                                                         window):
    cfg, jm, tm, jp, tp = _pair("qwen3-14b", sliding_window=window)
    toks = _tokens(cfg, 2, 256)
    calls = _Counted(monkeypatch)
    monkeypatch.setattr(tattn, "ATTN_BLOCK_PREFILL", 32)
    try:
        jattn.set_attn_block(32)
        (jl, _), jg = _jax_loss_and_grad(jm, toks)(jp)
    finally:
        jattn.set_attn_block(None)
    (tl, _), tg = tm.loss_and_grad(tp, {"tokens": torch.from_numpy(toks)})
    assert calls.n == 0
    np.testing.assert_allclose(_np(tl), _np(jl), **BLOCKED)
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(_np(a), _np(b), **BLOCKED)


@pytest.mark.parametrize("block,window", [(16, None), (64, None), (16, 32)])
def test_prefill_block(monkeypatch, block, window):
    cfg, jm, tm, jp, tp = _pair("qwen3-14b", sliding_window=window)
    toks = _tokens(cfg, 2, 64)
    calls = _Counted(monkeypatch)
    monkeypatch.setattr(tattn, "ATTN_BLOCK_PREFILL", block)
    try:
        jattn.set_attn_block_prefill(block)
        jlog, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                              jm.init_decode_state(2, 80))
    finally:
        jattn.set_attn_block_prefill(512)
    with torch.no_grad():
        tlog, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              tm.init_decode_state(2, 80, device="cpu"))
    assert calls.n == (cfg.n_layers if block < 64 else 0)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **SERVE)
    for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(_np(a), _np(b), **SERVE)


@pytest.mark.parametrize("name,own,ref", [
    ("ATTN_BLOCK_PREFILL", lambda: tattn.ATTN_BLOCK_PREFILL,
     lambda: jattn.ATTN_BLOCK_PREFILL[0]),
    ("LSTM_CHUNK", lambda: tssm.LSTM_CHUNK, lambda: jssm.LSTM_CHUNK[0])])
def test_constants_are_the_reference_s_defaults(name, own, ref):
    assert own() == ref(), name
    assert jattn.ATTN_BLOCK[0] is None       # the reference materializes too


# --------------------------------------------------------------------------
# LSTM chunks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("own,ref", [(16, 16), (64, 64), (16, None)])
def test_lstm_chunk_loss_and_grad(monkeypatch, own, ref):
    cfg, jm, tm, jp, tp = _pair("xlstm-350m", n_layers=2)
    toks = _tokens(cfg, 2, 32)        # two 16-step chunks; 64: one loop
    monkeypatch.setattr(tssm, "LSTM_CHUNK", own)
    try:
        jssm.set_lstm_chunk(ref)
        (jl, _), jg = _jax_loss_and_grad(jm, toks)(jp)
    finally:
        jssm.set_lstm_chunk(64)
    (tl, _), tg = tm.loss_and_grad(tp, {"tokens": torch.from_numpy(toks)})
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
