"""The port's recurrent mixers (``repro_torch.models.ssm``) against the
JAX package's ``repro.models.ssm`` on the same weights (carried across
with ``repro_torch.convert``) and inputs, float32: Mamba at reduced
``jamba-1.5-large-398b`` (d_inner 512, d_state 16, d_conv 4), mLSTM and
sLSTM at reduced ``xlstm-350m`` (d_model 256, 4 heads).

Mamba at S = 2 (under d_conv - 1: a zero-padded conv state), 32 and 512
(two 256-step chunks: the carry between chunks); mLSTM and sLSTM at
S = 16 and 128 (the reference's chunked-remat branch at 64 steps; the
port checkpoints the same chunks under autograd). The reference's
``associative_scan`` pairs the scan's terms in another tree than the
port's log-depth scan, so outputs and states are held within the serving
tolerance of the model zoo, ``rtol=1e-4, atol=1e-5``. The gradients of a
weighted sum of the output are raw sums over B x S positions, entries up
to 219 (mLSTM's ``gates_w`` at S = 128), and drift in float32 with the
leaf's scale: up to 1.6e-6 of the leaf's largest entry (3.5e-4 there;
the recurrence multiplies each step's exponential gates into the next).
So they are held within ``rtol=1e-4`` and an ``atol`` of 1e-5 of the
leaf's largest entry, six times that. Prefill then decode equals the
whole sequence: the port's prefill of S tokens then 3 decode steps
against the same tokens decoded one at a time from the zeroed state
(Mamba, whose chunk must divide the sequence) or against the full
sequence's last outputs (the LSTMs), and against the reference's decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import ssm as jssm
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm as tssm

SERVE = dict(rtol=1e-4, atol=1e-5)
B = 2
EXTRA = 3                                   # decode steps after a prefill
MIXERS = {  # name: (config, init, train with state, decode, state init)
    "mamba": ("jamba-1.5-large-398b", "init_mamba", "mamba_prefill",
              "mamba_decode"),
    "mlstm": ("xlstm-350m", "init_mlstm", "mlstm_train", "mlstm_decode"),
    "slstm": ("xlstm-350m", "init_slstm", "slstm_train", "slstm_decode"),
}


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **SERVE)


def _close_grad(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4,
                               atol=1e-5 * float(np.abs(j).max()))


def _setup(mixer):
    arch, init, _, _ = MIXERS[mixer]
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jp = getattr(jssm, init)(jcfg, jax.random.PRNGKey(7))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, tcfg, jp, tp


def _prefill(mod, mixer, p, cfg, x):
    fn = getattr(mod, MIXERS[mixer][2])
    return fn(p, cfg, x) if mixer == "mamba" else \
        fn(p, cfg, x, return_state=True)


def _x(cfg, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("mixer,s", [("mamba", 2), ("mamba", 32),
                                     ("mamba", 512), ("mlstm", 16),
                                     ("mlstm", 128), ("slstm", 16),
                                     ("slstm", 128)])
def test_full_sequence_and_state_match(mixer, s):
    jcfg, tcfg, jp, tp = _setup(mixer)
    x = _x(jcfg, s)
    jy, js = jax.jit(lambda p, x: _prefill(jssm, mixer, p, jcfg, x))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        ty, ts = _prefill(tssm, mixer, tp, tcfg, torch.from_numpy(x))
    _close(ty, jy)
    assert sorted(ts) == sorted(js)
    for k in js:
        assert ts[k].shape == js[k].shape and ts[k].dtype == torch.float32
        _close(ts[k], js[k])
    if mixer == "mamba" and s < tcfg.d_conv - 1:
        pad = tcfg.d_conv - 1 - s
        assert not bool(ts["conv"][:, :pad].any())


@pytest.mark.parametrize("mixer,s", [("mamba", 32), ("mlstm", 128),
                                     ("slstm", 128)])
def test_gradients_match(mixer, s):
    jcfg, tcfg, jp, tp = _setup(mixer)
    train = {"mamba": "mamba_train", "mlstm": "mlstm_train",
             "slstm": "slstm_train"}[mixer]
    x = _x(jcfg, s)
    w = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def jobj(p, x):
        return jnp.sum(getattr(jssm, train)(p, jcfg, x) * w)

    jgp, jgx = jax.jit(jax.grad(jobj, argnums=(0, 1)))(jp, jnp.asarray(x))
    tpl = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (getattr(tssm, train)(tpl, tcfg, xt) * torch.from_numpy(w)).sum(
        ).backward()
    _close_grad(xt.grad, jgx)
    for k in jgp:
        _close_grad(tpl[k].grad, jgp[k])


@pytest.mark.parametrize("mixer,s", [("mamba", 2), ("mamba", 32),
                                     ("mamba", 512), ("mlstm", 16),
                                     ("mlstm", 128), ("slstm", 16),
                                     ("slstm", 128)])
def test_prefill_then_decode_is_the_whole_sequence(mixer, s):
    jcfg, tcfg, jp, tp = _setup(mixer)
    decode = MIXERS[mixer][3]
    x = _x(jcfg, s + EXTRA, seed=2)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        _, st = _prefill(tssm, mixer, tp, tcfg, xt[:, :s])
        steps = []
        for i in range(s, s + EXTRA):
            y, st = getattr(tssm, decode)(tp, tcfg, xt[:, i:i + 1], st)
            steps.append(y)
        got = torch.cat(steps, 1)
        if mixer == "mamba":
            # token by token from the zeroed state: the recurrence itself
            ref = tssm.init_mamba_state(tcfg, B, torch.float32)
            for i in range(s + EXTRA):
                y, ref = tssm.mamba_decode(tp, tcfg, xt[:, i:i + 1], ref)
            want, want_state = y, ref
            got_last = got[:, -1:]
        else:
            want, want_state = _prefill(tssm, mixer, tp, tcfg, xt)
            want, got_last = want[:, s:], got
    np.testing.assert_allclose(got_last.numpy(), want.numpy(), **SERVE)
    for k in st:
        np.testing.assert_allclose(st[k].numpy(), want_state[k].numpy(),
                                   **SERVE)
    # and the reference's decode from its own prefill's state
    _, js = jax.jit(lambda p, x: _prefill(jssm, mixer, p, jcfg, x))(
        jp, jnp.asarray(x[:, :s]))
    jdecode = jax.jit(lambda p, x, st: getattr(jssm, decode)(p, jcfg, x, st))
    jsteps = []
    for i in range(s, s + EXTRA):
        y, js = jdecode(jp, jnp.asarray(x[:, i:i + 1]), js)
        jsteps.append(y)
    _close(got, jnp.concatenate(jsteps, 1))
    for k in js:
        _close(st[k], js[k])
