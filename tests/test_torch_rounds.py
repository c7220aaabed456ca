"""The port's round core against ``repro.fed.rounds``: ``round_step``
chained over 5 rounds on identical numpy worker buffers, costs and sizes.
Pilot, goodness, packed wire, new buffers and the whole RoundState are
held bitwise (the master's fused multiply-add matches XLA:CPU's, see
``test_torch_fused_wire``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as jfl
from repro.core.goodness import select_pilot as jselect
from repro.fed import rounds as jrd
from repro_torch.convert import params_from_numpy
from repro_torch.core import flat as tfl
from repro_torch.core.goodness import select_pilot as tselect
from repro_torch.fed import rounds as trd

N = 3


def _params(rng):
    dims = [24, 64, 64, 6]          # the quickstart MLP: 6,150 params
    return {f"layer{i}": {"w": rng.standard_normal((dims[i], dims[i + 1]),
                                                   dtype=np.float32) * 0.2,
                          "b": np.zeros(dims[i + 1], np.float32)}
            for i in range(3)}


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _assert_state_equal(ts, js):
    for name in ("buf_p1", "buf_p2", "prev_costs"):
        np.testing.assert_array_equal(
            _bits(getattr(ts, name).numpy()), _bits(getattr(js, name)),
            err_msg=name)
    assert int(ts.round) == int(js.round)


@pytest.mark.parametrize("betas", [None, (0.1, 0.3, 0.2)])
def test_round_step_chain_bitwise(betas):
    rng = np.random.default_rng(0)
    params = _params(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    layout = jfl.layout_of(jparams)
    jwire = jrd.WirePath(jrd.WireConfig())
    twire = trd.WirePath(trd.WireConfig())
    js = jrd.init_round_state(jparams, N, layout, telemetry=False)
    ts = trd.init_round_state(params_from_numpy(params, device="cpu"), N,
                              device="cpu")
    _assert_state_equal(ts, js)
    sizes = np.array([500.0, 300.0, 700.0], np.float32)
    jb = None if betas is None else jnp.asarray(betas, jnp.float32)
    tb = None if betas is None else torch.tensor(betas, dtype=torch.float32)
    for _ in range(5):
        p1 = np.asarray(js.buf_p1)
        bufs = (p1[None] + rng.standard_normal((N,) + p1.shape,
                                               dtype=np.float32) * 0.02)
        bufs.reshape(N, -1)[:, layout.n:] = 0.0  # keep the zero tail
        costs = rng.random(N, dtype=np.float32) + 0.5

        jw = np.asarray(jwire.uplink_stacked(jnp.asarray(bufs), js.buf_p1,
                                             js.buf_p2, t=js.round,
                                             betas=jb))
        tw = twire.uplink_stacked(torch.from_numpy(bufs), ts.buf_p1,
                                  ts.buf_p2, t=ts.round, betas=tb).numpy()
        np.testing.assert_array_equal(tw, jw)

        js, jnew, jinfo = jwire.round_step(js, jnp.asarray(bufs),
                                           jnp.asarray(costs),
                                           jnp.asarray(sizes), betas=jb)
        ts, tnew, tinfo = twire.round_step(ts, torch.from_numpy(bufs),
                                           torch.from_numpy(costs),
                                           torch.from_numpy(sizes), betas=tb)
        assert int(tinfo["k_star"]) == int(jinfo["k_star"])
        np.testing.assert_array_equal(_bits(tinfo["goodness"].numpy()),
                                      _bits(jinfo["goodness"]))
        np.testing.assert_array_equal(_bits(tnew.numpy()), _bits(jnew))
        _assert_state_equal(ts, js)
    assert not tnew.numpy().reshape(-1)[layout.n:].any()


def test_elementwise_math_matches():
    rng = np.random.default_rng(1)
    q, p1, p2 = (rng.standard_normal((64, 128), dtype=np.float32) * 0.1
                 for _ in range(3))
    coeff = rng.standard_normal((64, 128), dtype=np.float32)
    jwire, twire = jrd.WirePath(jrd.WireConfig()), trd.WirePath(
        trd.WireConfig())
    jcombine = jax.jit(jwire.combine)
    for t in (1, 2):
        np.testing.assert_array_equal(
            twire.codes(*map(torch.from_numpy, (q, p1, p2)), t).numpy(),
            np.asarray(jwire.codes(q, p1, p2, t)))
        # Under jit XLA:CPU rounds q − coeff·mult once, as fma_f32 does.
        np.testing.assert_array_equal(
            _bits(twire.combine(*map(torch.from_numpy, (q, coeff, p1, p2)),
                                t).numpy()),
            _bits(jcombine(q, coeff, p1, p2, jnp.int32(t))))
        shares = np.array([0.2, 0.5, 0.3], np.float32)
        for betas in (None, np.array([0.1, 0.3, 0.2], np.float32)):
            tw = twire.weights(torch.from_numpy(shares), torch.tensor(1), t,
                               betas=None if betas is None
                               else torch.from_numpy(betas))
            jw = jwire.weights(shares, 1, t, betas=betas)
            np.testing.assert_array_equal(_bits(tw.numpy()), _bits(jw))


def test_round_engine_matches():
    rng = np.random.default_rng(2)
    params = _params(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    je = jrd.RoundEngine(jparams)
    te = trd.RoundEngine(params_from_numpy(params, device="cpu"),
                         device="cpu")
    shares = np.array([0.25, 0.25, 0.5], np.float32)
    for t in (1, 2, 3):
        locals_np = [jax.tree_util.tree_map(
            lambda a: a + rng.standard_normal(a.shape, dtype=np.float32)
            * 0.01, params) for _ in range(N)]
        jb = je.flatten_locals([jax.tree_util.tree_map(jnp.asarray, p)
                                for p in locals_np])
        tb = te.flatten_locals([params_from_numpy(p, device="cpu")
                                for p in locals_np])
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        k = t % N
        je.run_round(jb, k, jnp.asarray(shares), t)
        te.run_round(tb, torch.tensor(k), torch.from_numpy(shares), t)
        np.testing.assert_array_equal(_bits(te.buf_p1.numpy()),
                                      _bits(je.buf_p1))
    assert te.layout.rows == je.layout.rows == tfl.layout_of(
        params_from_numpy(params, device="cpu")).rows


@pytest.mark.parametrize("mask", [(1, 0, 1), (0, 1, 1)])
def test_round_engine_run_round_with_mask_matches(mask):
    # The reference's run_round(..., mask=) zeroes the weights of workers
    # outside the participation mask; the port's takes the same argument.
    rng = np.random.default_rng(5)
    params = _params(rng)
    je = jrd.RoundEngine(jax.tree_util.tree_map(jnp.asarray, params))
    te = trd.RoundEngine(params_from_numpy(params, device="cpu"),
                         device="cpu")
    shares = np.array([0.25, 0.25, 0.5], np.float32)
    m = np.asarray(mask, np.float32)
    for t in (1, 2, 3):
        locals_np = [jax.tree_util.tree_map(
            lambda a: a + rng.standard_normal(a.shape, dtype=np.float32)
            * 0.01, params) for _ in range(N)]
        jb = je.flatten_locals([jax.tree_util.tree_map(jnp.asarray, p)
                                for p in locals_np])
        tb = te.flatten_locals([params_from_numpy(p, device="cpu")
                                for p in locals_np])
        k = int(np.flatnonzero(m)[t % 2])
        jnew = je.run_round(jb, k, jnp.asarray(shares), t,
                            mask=jnp.asarray(m))
        tnew = te.run_round(tb, torch.tensor(k), torch.from_numpy(shares), t,
                            mask=torch.from_numpy(m))
        np.testing.assert_array_equal(_bits(te.buf_p1.numpy()),
                                      _bits(je.buf_p1))
        for a, b in zip(jax.tree_util.tree_leaves(tnew),
                        jax.tree_util.tree_leaves(jnew)):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


@pytest.mark.parametrize("t", [1, 3])
def test_select_pilot_rules(t):
    # Ties go to the lowest index; a worker with no history (+inf) scores
    # by the round-1 rule; a masked-out worker scores -inf.
    costs = np.array([0.5, 0.25, 0.25, 0.8], np.float32)
    prev = np.array([0.9, 0.5, 0.5, np.inf], np.float32)
    sizes = np.array([100.0, 200.0, 200.0, 50.0], np.float32)
    for mask in (None, np.array([1.0, 0.0, 1.0, 1.0], np.float32)):
        jk, js = jselect(costs, prev, sizes, t, mask)
        tk, ts = tselect(
            *map(torch.from_numpy, (costs, prev, sizes)), t,
            None if mask is None else torch.from_numpy(mask))
        assert int(tk) == int(jk)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
