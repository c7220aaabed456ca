"""``PrivacySpec(enforce=True)`` in the port's two FedPC drivers, and the
shipped federation scenarios, against ``repro.fed.simulator`` and
``repro.configs.federation``.

The federation is ``tests/test_torch_scan.py``'s (N = 4 workers, the MLP
16→32→5, 96 samples a worker, batch 32: every shard uniform, so both
drivers run). Held: each driver audits its round program once, before
round 1, and records the JAX simulator's report under its own name; the
enforced run gives the JAX simulator's pilots, bytes and ledger events,
its costs and params within the ``rtol=1e-3`` that ``test_torch_sim``
explains, and the two drivers each other's bits; enforcement changes no
round (the same launches and bits with ``enforce=False``). The shipped
``secure-agg-ldp`` regime (C = 0.5, eps = 4) runs the same way. Every
preset's fields and beta_k draw equal the JAX package's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import federation as jfed
from repro.core.fedpc import FedPCConfig as JCfg
from repro.data.pipeline import federated_loaders as j_loaders
from repro.data.synthetic import SyntheticClassification as JData
from repro.fed.simulator import FedSimulator as JSim
from repro.fed.worker import Worker as JWorker
from repro.fed.worker import make_worker_configs as j_cfgs
from repro.models.mlp import init_mlp_classifier as j_init
from repro.models.mlp import mlp_loss_and_grad as j_lag
from repro.privacy.spec import PrivacySpec as JSpec
from repro_torch import configs as tfed
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedpc import FedPCConfig as TCfg
from repro_torch.data.pipeline import federated_loaders as t_loaders
from repro_torch.data.synthetic import SyntheticClassification as TData
from repro_torch.fed.simulator import FedSimulator as TSim
from repro_torch.fed.worker import Worker as TWorker
from repro_torch.fed.worker import make_worker_configs as t_cfgs
from repro_torch.kernels import seam
from repro_torch.models.mlp import mlp_loss_and_grad as t_lag
from repro_torch.privacy.spec import PrivacySpec as TSpec
from repro_torch.utils import tree_leaves

N = 4
PER = 96
ROUNDS = 4


def _federation(jax_side: bool):
    data, loaders, cfgs, worker, lag = (
        (JData, j_loaders, j_cfgs, JWorker, j_lag) if jax_side
        else (TData, t_loaders, t_cfgs, TWorker, t_lag))
    x, y = data(n_samples=N * PER, n_features=16, n_classes=5,
                seed=0).generate()
    splits = [np.arange(i * PER, (i + 1) * PER) for i in range(N)]
    lds = loaders((x, y), splits, seed=0, batch_menu=(32,))
    wcfg = cfgs(N, [PER] * N, seed=0, batch_menu=(32,))
    return [worker(cfg=wcfg[k], loader=lds[k], loss_and_grad=lag)
            for k in range(N)]


_JPARAMS = j_init(jax.random.PRNGKey(0), 16, 5, hidden=(32,))
_PARAMS_NP = jax.tree_util.tree_map(np.asarray, _JPARAMS)


def _tsim(spec) -> TSim:
    return TSim(_federation(False),
                params_from_numpy(_PARAMS_NP, device="cpu"),
                TCfg(n_workers=N, privacy=spec), device="cpu")


def _jax_run(jspec, participation: float):
    jsim = JSim(_federation(True), _JPARAMS,
                JCfg(n_workers=N, privacy=jspec))
    jres = jsim.run_fedpc(ROUNDS, participation=participation,
                          wire_block_workers=1)
    return jsim, jres


def _assert_same_bits(r1, r2):
    assert r1.pilot_history == r2.pilot_history
    assert r1.costs == r2.costs
    assert r1.bytes_per_round == r2.bytes_per_round
    for a, b in zip(tree_leaves(r1.params), tree_leaves(r2.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("spec_kw,participation", [
    ({"dp_epsilon": 2.0}, 1.0),
    ("secure-agg-ldp", None),
], ids=["dp", "secure-agg-ldp"])
def test_enforced_drivers_audited_and_match_jax(spec_kw, participation):
    if isinstance(spec_kw, str):             # a shipped scenario
        scen = tfed.get_scenario(spec_kw)
        spec, participation = scen.privacy, scen.participation
        jspec = jfed.get_scenario(spec_kw).privacy
    else:
        spec, jspec = TSpec(**spec_kw), JSpec(**spec_kw)
    assert spec.enforce and jspec.enforce
    jsim, jres = _jax_run(jspec, participation)
    runs = {}
    for driver in ("run_fedpc", "run_fedpc_scan"):
        sim = _tsim(spec)
        runs[driver] = getattr(sim, driver)(ROUNDS,
                                            participation=participation,
                                            wire_block_workers=1)
        assert sim.ledger.audits == [{**jsim.ledger.audits[0],
                                      "runtime": driver}]
        assert sim.ledger.events == jsim.ledger.events
    assert [a["runtime"] for a in jsim.ledger.audits] == ["run_fedpc"]
    assert jsim.ledger.audits[0]["masked"]
    _assert_same_bits(runs["run_fedpc"], runs["run_fedpc_scan"])
    tres = runs["run_fedpc"]
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-3)
    for a, b in zip(tree_leaves(tres.params),
                    jax.tree_util.tree_leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)
    assert int(tres.round_state.accountant.spent_rounds) == ROUNDS


@pytest.mark.parametrize("driver", ["run_fedpc", "run_fedpc_scan"])
def test_enforcement_changes_no_round(driver):
    # A recording around the real CPU run sees each launch the run makes;
    # the audit's own meta run records its launches apart, so the run's
    # launches are the same with the audit on and off, and so are its bits.
    runs, launches = [], []
    for enforce in (True, False):
        sim = _tsim(TSpec(dp_epsilon=2.0, enforce=enforce))
        with seam.recording() as rec:
            runs.append(getattr(sim, driver)(3, participation=0.5))
        launches.append([ln.kind for ln in rec.launches])
        assert len(sim.ledger.audits) == int(enforce)
    assert launches[0] == launches[1] == ["uplink_masked",
                                          "master_masked"] * 3
    _assert_same_bits(*runs)


def test_scenarios_equal_the_jax_presets():
    assert tfed.list_scenarios() == jfed.list_scenarios()
    for name in jfed.list_scenarios():
        j, t = jfed.get_scenario(name), tfed.get_scenario(name)
        for f in ("name", "participation", "beta_menu", "description"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert (t.privacy is None) == (j.privacy is None)
        if t.privacy is not None:
            assert dataclasses.asdict(t.privacy) == dataclasses.asdict(
                j.privacy)
        for n, seed in ((1, 0), (5, 0), (10, 3), (33, 7)):
            assert t.betas_for(n, seed) == j.betas_for(n, seed)
    with pytest.raises(KeyError) as jerr:
        jfed.get_scenario("nope")
    with pytest.raises(KeyError) as terr:
        tfed.get_scenario("nope")
    assert str(terr.value) == str(jerr.value)
