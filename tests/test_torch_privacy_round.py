"""The port's masked FedPC round against ``repro.fed.rounds`` and
``repro.fed.simulator`` with the same ``PrivacySpec``.

``WirePath.round_step`` chained over 4 rounds on identical numpy worker
buffers, costs and sizes is held bitwise: pilot, costs, the new global
buffers and the history, at both moduli, with and without a participation
mask and ``renorm_shares``; the accountant's sums are equal and its
``e·(exp(e) − 1)`` sum agrees within ``rtol=1e-6`` (float32 ``exp``
differs by an ulp between XLA and ATen). The simulator on the quickstart
federation picks the same pilots and books the same bytes; costs and
params agree within the ``rtol=1e-3`` that ``test_torch_sim`` explains.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fedpc import FedPCConfig as JCfg
from repro.core import flat as jfl
from repro.data.pipeline import federated_loaders as j_loaders
from repro.data.synthetic import SyntheticClassification as JData
from repro.data.synthetic import random_share_split as j_split
from repro.fed import rounds as jrd
from repro.fed.simulator import FedSimulator as JSim
from repro.fed.worker import Worker as JWorker
from repro.fed.worker import make_worker_configs as j_cfgs
from repro.models.mlp import init_mlp_classifier as j_init
from repro.models.mlp import mlp_loss_and_grad as j_lag
from repro.privacy.spec import PrivacySpec as JSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core import protocol as proto
from repro_torch.core.fedpc import FedPCConfig as TCfg
from repro_torch.core.privacy import LeakageError
from repro_torch.data.pipeline import federated_loaders as t_loaders
from repro_torch.data.synthetic import SyntheticClassification as TData
from repro_torch.data.synthetic import random_share_split as t_split
from repro_torch.fed import rounds as trd
from repro_torch.fed.simulator import FedSimulator as TSim
from repro_torch.fed.worker import Worker as TWorker
from repro_torch.fed.worker import make_worker_configs as t_cfgs
from repro_torch.models.mlp import mlp_loss_and_grad as t_lag
from repro_torch.privacy.spec import PrivacySpec as TSpec
from repro_torch.utils import tree_leaves

N = 4


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
    if js.accountant is None:
        assert ts.accountant is None
        return
    assert int(ts.accountant.spent_rounds) == int(js.accountant.spent_rounds)
    for name in ("eps_sum", "eps_sq_sum"):
        assert (float(getattr(ts.accountant, name))
                == float(getattr(js.accountant, name)))
    np.testing.assert_allclose(float(ts.accountant.eps_lin_sum),
                               float(js.accountant.eps_lin_sum), rtol=1e-6)


def _chain(spec_kw, *, with_mask, renorm, rounds=4, seed=0):
    """Run both round cores side by side; returns the port's states."""
    rng = np.random.default_rng(seed)
    params = _params(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    layout = jfl.layout_of(jparams)
    jspec, tspec = JSpec(enforce=False, **spec_kw), TSpec(enforce=False,
                                                           **spec_kw)
    jwire = jrd.WirePath(jrd.WireConfig(), privacy=jspec,
                         renorm_shares=renorm)
    twire = trd.WirePath(trd.WireConfig(), privacy=tspec,
                         renorm_shares=renorm)
    js = jrd.init_round_state(jparams, N, layout, privacy=jspec,
                              telemetry=False)
    ts = trd.init_round_state(params_from_numpy(params, device="cpu"), N,
                              privacy=tspec, device="cpu")
    _assert_state_equal(ts, js)
    sizes = np.array([500.0, 300.0, 700.0, 250.0], np.float32)
    step = jax.jit(jwire.round_step)      # as the JAX simulator runs it
    masks = [None, np.array([1, 0, 1, 1], np.float32),
             np.array([1, 1, 0, 1], np.float32),
             np.array([0, 1, 1, 1], np.float32)]
    for i in range(rounds):
        p1 = np.asarray(js.buf_p1)
        bufs = (p1[None] + rng.standard_normal((N,) + p1.shape,
                                               dtype=np.float32) * 0.02)
        bufs.reshape(N, -1)[:, layout.n:] = 0.0  # keep the zero tail
        costs = rng.random(N, dtype=np.float32) + 0.5
        mask = masks[i] if with_mask else None
        kw = {} if mask is None else {"mask": jnp.asarray(mask)}
        js, jnew, jinfo = step(js, jnp.asarray(bufs), jnp.asarray(costs),
                               jnp.asarray(sizes), **kw)
        ts, tnew, tinfo = twire.round_step(
            ts, torch.from_numpy(bufs), torch.from_numpy(costs),
            torch.from_numpy(sizes),
            mask=None if mask is None else torch.from_numpy(mask))
        assert int(tinfo["k_star"]) == int(jinfo["k_star"])
        np.testing.assert_array_equal(_bits(tinfo["costs"].numpy()),
                                      _bits(jinfo["costs"]))
        np.testing.assert_array_equal(_bits(tnew.numpy()), _bits(jnew))
        _assert_state_equal(ts, js)
        assert ("mask" in tinfo) == (mask is not None)
    return ts


@pytest.mark.parametrize("spec_kw", [
    {"dp_epsilon": 2.0},                       # the 16-bit default, RR on
    {"modulus_bits": 32},
    {"modulus_bits": 32, "dp_epsilon": 0.5},
])
@pytest.mark.parametrize("with_mask,renorm", [(False, False), (True, False),
                                              (True, True)])
def test_masked_round_step_chain_bitwise(spec_kw, with_mask, renorm):
    ts = _chain(spec_kw, with_mask=with_mask, renorm=renorm)
    assert (ts.accountant is not None) == ("dp_epsilon" in spec_kw)


@pytest.mark.parametrize("bits", [16, 32])
def test_masked_round_equals_unmasked_round(bits):
    # The pairwise masks cancel exactly: the same round without masks
    # (mask_seed=None) gives the same bits, while its words differ.
    rng = np.random.default_rng(3)
    n, rows = 5, 64
    p1 = rng.standard_normal((rows, 128), dtype=np.float32) * 0.05
    p2 = p1 + rng.standard_normal((rows, 128), dtype=np.float32) * 0.01
    bufs = torch.from_numpy(p1[None] + rng.standard_normal(
        (n, rows, 128), dtype=np.float32) * 0.02)
    w = torch.tensor([0.1, 0.2, 0.0, 0.3, 0.15])
    outs = []
    for seed in (0, None):
        wire = trd.WirePath(privacy=TSpec(modulus_bits=bits, mask_seed=seed,
                                          dp_epsilon=2.0, enforce=False))
        outs.append(wire.round_from_stacked(
            bufs, torch.tensor(2), w, torch.from_numpy(p1),
            torch.from_numpy(p2), t=torch.tensor(3, dtype=torch.int32)))
    (new_m, y_m), (new_u, y_u) = outs
    assert torch.equal(new_m.view(torch.int32), new_u.view(torch.int32))
    assert not torch.equal(y_m, y_u)


def test_dropout_repair_is_refused():
    # A repair needs the Shamir threshold of the recovery dealing.
    wire = trd.WirePath(privacy=TSpec(enforce=False))
    z = torch.zeros((2, 32, 128))
    with pytest.raises(ValueError, match="recovery_threshold"):
        wire.round_from_stacked(z, torch.tensor(0), torch.zeros(2), z[0],
                                z[0], t=1, alive=torch.ones(2))


def _federation(data, split, loaders, cfgs, worker, lag):
    x, y = data(n_samples=1500, n_features=24, n_classes=6, seed=0).generate()
    splits = split(y, n_workers=3, seed=1)
    lds = loaders((x, y), splits, seed=2)
    wcfg = cfgs(3, [len(s) for s in splits], seed=3)
    return [worker(cfg=wcfg[k], loader=lds[k], loss_and_grad=lag)
            for k in range(3)]


def test_quickstart_federation_with_privacy_matches():
    jparams = j_init(jax.random.PRNGKey(0), 24, 6)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    spec_kw = {"dp_epsilon": 2.0, "enforce": False}
    jw = _federation(JData, j_split, j_loaders, j_cfgs, JWorker, j_lag)
    tw = _federation(TData, t_split, t_loaders, t_cfgs, TWorker, t_lag)
    jres = JSim(jw, jparams, JCfg(n_workers=3, privacy=JSpec(**spec_kw))
                ).run_fedpc(rounds=6)
    tsim = TSim(tw, params_from_numpy(params_np, device="cpu"),
                TCfg(n_workers=3, privacy=TSpec(**spec_kw)), device="cpu")
    tres = tsim.run_fedpc(rounds=6)

    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    model_bytes = proto.model_size_bytes(params_from_numpy(params_np,
                                                           device="cpu"))
    assert tres.bytes_per_round[0] == proto.fedpc_masked_bytes_per_round(
        model_bytes, 3, word_bits=16)
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-3)
    assert sorted({k for (_, _, k, _) in tsim.ledger.events}) == [
        "cost", "masked_words", "pilot_params"]
    assert int(tres.round_state.accountant.spent_rounds) == 6
    for a, b in zip(tree_leaves(tres.params),
                    jax.tree_util.tree_leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)


def test_enforce_is_refused(monkeypatch):
    # Under enforce=True (the default) a round program that leaks is
    # refused by the set-up audit before any round runs, in both drivers;
    # with enforce=False the same program runs.
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, j_init(jax.random.PRNGKey(0), 24, 6)), device="cpu")
    round_step = trd.WirePath.round_step

    def leaky(self, state, bufs_q, costs, sizes, **kw):
        new_state, new_buf, info = round_step(self, state, bufs_q, costs,
                                              sizes, **kw)
        return new_state, new_buf, {**info, "trace_payload": bufs_q}

    monkeypatch.setattr(trd.WirePath, "round_step", leaky)
    for driver in ("run_fedpc", "run_fedpc_scan"):
        tw = _federation(TData, t_split, t_loaders, t_cfgs, TWorker, t_lag)
        sim = TSim(tw, params, TCfg(n_workers=3, privacy=TSpec()),
                   device="cpu")
        with pytest.raises(LeakageError, match="per-worker float payload"):
            getattr(sim, driver)(rounds=1)
        assert sim.ledger.events == sim.ledger.audits == []
        assert [w.step for w in tw] == [0, 0, 0]
    tw = _federation(TData, t_split, t_loaders, t_cfgs, TWorker, t_lag)
    sim = TSim(tw, params, TCfg(n_workers=3, privacy=TSpec(enforce=False)),
               device="cpu")
    res = sim.run_fedpc(rounds=1)
    assert len(res.pilot_history) == 1 and sim.ledger.audits == []
