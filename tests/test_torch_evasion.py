"""The §4.2 worker-side evasion defence (``evade_streak``) in the port's
``run_fedpc`` against ``repro.fed.simulator``.

The federations are ``test_torch_sim``'s quickstart one (3 workers, MLP
24→64→64→6, the JAX initial weights carried across) and
``tests/test_fed_sim.py``'s evasion one (3 workers, MLP 16→32→5, seed 7).
Held exactly: the pilot history, the bytes per round and the ledger's
events, on the plain wire and on the masked wire (16-bit words, masks
and randomized response at epsilon 2), and a run resumed after 4 rounds
against 8 rounds in one run. Costs (the measured ones; the master acts
on the reported ones) agree within ``rtol=1e-3``, the float32 drift of
local training that ``test_torch_sim`` explains.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.fedpc import FedPCConfig as JCfg
from repro.data.pipeline import federated_loaders as j_loaders
from repro.data.synthetic import SyntheticClassification as JData
from repro.data.synthetic import random_share_split as j_split
from repro.fed.simulator import FedSimulator as JSim
from repro.fed.worker import Worker as JWorker
from repro.fed.worker import make_worker_configs as j_cfgs
from repro.models.mlp import init_mlp_classifier as j_init
from repro.models.mlp import mlp_loss_and_grad as j_lag
from repro.privacy.spec import PrivacySpec as JSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedpc import FedPCConfig as TCfg
from repro_torch.data.pipeline import federated_loaders as t_loaders
from repro_torch.data.synthetic import SyntheticClassification as TData
from repro_torch.data.synthetic import random_share_split as t_split
from repro_torch.fed.simulator import FedSimulator as TSim
from repro_torch.fed.worker import Worker as TWorker
from repro_torch.fed.worker import make_worker_configs as t_cfgs
from repro_torch.models.mlp import init_mlp_classifier as t_init
from repro_torch.models.mlp import mlp_loss_and_grad as t_lag
from repro_torch.privacy.spec import PrivacySpec as TSpec

ROUNDS = 8


def _federation(data, split, loaders, cfgs, worker, lag):
    x, y = data(n_samples=1800, n_features=24, n_classes=6, seed=0).generate()
    splits = split(y[:1500], n_workers=3, seed=1)
    lds = loaders((x[:1500], y[:1500]), splits, seed=2)
    wcfg = cfgs(3, [len(s) for s in splits], seed=3)
    return [worker(cfg=wcfg[k], loader=lds[k], loss_and_grad=lag)
            for k in range(3)]


def _sims(masked: bool, streak: int = 2):
    jparams = j_init(jax.random.PRNGKey(0), 24, 6)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    jcfg = tcfg = None
    if masked:
        jcfg = JCfg(n_workers=3, privacy=JSpec(dp_epsilon=2.0,
                                               enforce=False))
        tcfg = TCfg(n_workers=3, privacy=TSpec(dp_epsilon=2.0,
                                               enforce=False))
    jsim = JSim(_federation(JData, j_split, j_loaders, j_cfgs, JWorker,
                            j_lag), jparams, jcfg, evade_streak=streak)
    tsim = TSim(_federation(TData, t_split, t_loaders, t_cfgs, TWorker,
                            t_lag), params_from_numpy(params_np,
                                                      device="cpu"),
                tcfg, evade_streak=streak, device="cpu")
    return jsim, tsim


def _longest_streak(pilots):
    longest = cur = 1
    for a, b in zip(pilots, pilots[1:]):
        cur = cur + 1 if a == b else 1
        longest = max(longest, cur)
    return longest


def _same(tsim, tres, jsim, jres):
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    assert tres.total_bytes == jres.total_bytes
    assert tsim.ledger.events == jsim.ledger.events
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-3)


@pytest.mark.parametrize("masked", [False, True])
def test_evasion_matches_reference(masked):
    jsim, tsim = _sims(masked)
    jres = jsim.run_fedpc(rounds=ROUNDS)
    tres = tsim.run_fedpc(rounds=ROUNDS)
    _same(tsim, tres, jsim, jres)
    assert _longest_streak(tres.pilot_history) <= 4
    kinds = {k for (_, _, k, _) in tsim.ledger.events}
    assert kinds == {"cost", "pilot_params",
                     "masked_words" if masked else "packed_ternary"}
    assert [r for (r, _, k, _) in tsim.ledger.events
            if k == "pilot_params"] == list(range(1, ROUNDS + 1))
    # the defence changed the pilots: without it the run differs
    _, plain = _sims(masked, streak=0)
    assert plain.run_fedpc(rounds=ROUNDS).pilot_history != \
        tres.pilot_history
    # the master's memory holds the reported costs, the reference's too
    np.testing.assert_allclose(tres.round_state.prev_costs.numpy(),
                               np.asarray(jres.round_state.prev_costs),
                               rtol=1e-3)


@pytest.mark.parametrize("masked", [False, True])
def test_evasion_resume_equals_one_run(masked):
    jsim, tsim = _sims(masked)
    jres = jsim.run_fedpc(rounds=ROUNDS)
    tres = tsim.run_fedpc(rounds=ROUNDS)
    js, ts = _sims(masked)
    j1 = js.run_fedpc(rounds=4)
    j2 = js.run_fedpc(rounds=4, state=j1.round_state)
    t1 = ts.run_fedpc(rounds=4)
    t2 = ts.run_fedpc(rounds=4, state=t1.round_state)
    for a, b, whole in ((j1, j2, jres), (t1, t2, tres)):
        assert a.pilot_history + b.pilot_history == whole.pilot_history
        assert list(a.bytes_per_round) + list(b.bytes_per_round) == \
            list(whole.bytes_per_round)
        assert a.costs + b.costs == whole.costs
    assert ts.ledger.events == tsim.ledger.events == js.ledger.events
    assert torch.equal(t2.round_state.buf_p1, tres.round_state.buf_p1)


def test_evasion_with_participation_raises_as_reference():
    jsim, tsim = _sims(False)
    with pytest.raises(ValueError) as jerr:
        jsim.run_fedpc(rounds=2, participation=0.5, participation_seed=1)
    with pytest.raises(ValueError) as terr:
        tsim.run_fedpc(rounds=2, participation=0.5, participation_seed=1)
    assert str(terr.value) == str(jerr.value) == (
        "evasion defence + partial participation is not supported in one "
        "run")
    assert tsim.ledger.events == []


def test_evasion_defence_rotates_pilot():
    # tests/test_fed_sim.py's case, on the port alone
    x, y = TData(n_samples=1200, n_features=16, n_classes=5,
                 seed=0).generate()
    xtr, ytr = x[:1000], y[:1000]
    splits = t_split(ytr, 3, seed=7)
    loaders = t_loaders((xtr, ytr), splits, seed=7, batch_menu=(64, 32))
    cfgs = t_cfgs(3, [len(s) for s in splits], seed=7, batch_menu=(64, 32))
    workers = [TWorker(cfg=cfgs[k], loader=loaders[k], loss_and_grad=t_lag)
               for k in range(3)]
    params = t_init(torch.Generator().manual_seed(0), 16, 5, hidden=(32,),
                    device="cpu")
    sim = TSim(workers, params, device="cpu")
    sim.evade_streak = 2
    res = sim.run_fedpc(rounds=8)
    assert _longest_streak(res.pilot_history) <= 4
    assert len(res.pilot_history) == 8
