"""The port's simulator against ``repro.fed.simulator`` on the quickstart
federation (3 workers, MLP 24→64→64→6, 10 rounds): the same numpy data,
splits, loaders and worker configs, and the JAX initial weights carried
across by ``repro_torch.convert``.

Pilot history and bytes per round must be equal. Costs agree within
``rtol=1e-3``: XLA and ATen reduce the matmuls, tanh and logsumexp in
different orders, and XLA contracts the optimizers' multiply-adds into
fused ones, so local models drift by float32 ulps that compound over the
rounds (the wire itself is bitwise, see ``test_torch_rounds``).
"""
import jax
import numpy as np
import pytest

from repro.core.fedpc import FedPCConfig as JCfg
from repro.data.pipeline import BatchIterator as JBatchIterator
from repro.data.pipeline import federated_loaders as j_loaders
from repro.data.synthetic import SyntheticClassification as JData
from repro.data.synthetic import random_share_split as j_split
from repro.fed.simulator import FedSimulator as JSim
from repro.fed.worker import Worker as JWorker
from repro.fed.worker import WorkerConfig as JWorkerConfig
from repro.fed.worker import make_worker_configs as j_cfgs
from repro.models.mlp import init_mlp_classifier as j_init
from repro.models.mlp import mlp_loss_and_grad as j_lag
from repro.privacy.spec import PrivacySpec as JSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedpc import FedPCConfig as TCfg
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.pipeline import federated_loaders as t_loaders
from repro_torch.data.synthetic import SyntheticClassification as TData
from repro_torch.data.synthetic import random_share_split as t_split
from repro_torch.fed.simulator import FedSimulator as TSim
from repro_torch.fed.worker import Worker as TWorker
from repro_torch.fed.worker import WorkerConfig as TWorkerConfig
from repro_torch.fed.worker import make_worker_configs as t_cfgs
from repro_torch.models.mlp import mlp_accuracy
from repro_torch.models.mlp import mlp_loss_and_grad as t_lag
from repro_torch.privacy.spec import PrivacySpec as TSpec
from repro_torch.utils import tree_leaves


def _federation(data, split, loaders, cfgs, worker, lag):
    x, y = data(n_samples=1800, n_features=24, n_classes=6, seed=0).generate()
    splits = split(y[:1500], n_workers=3, seed=1)
    lds = loaders((x[:1500], y[:1500]), splits, seed=2)
    wcfg = cfgs(3, [len(s) for s in splits], seed=3)
    return [worker(cfg=wcfg[k], loader=lds[k], loss_and_grad=lag)
            for k in range(3)], (x[1500:], y[1500:])


def _init_np():
    params = j_init(jax.random.PRNGKey(0), 24, 6)
    return params, jax.tree_util.tree_map(np.asarray, params)


def test_data_and_configs_same_draws():
    jx, jy = JData(n_samples=300, n_features=24, n_classes=6,
                   seed=5).generate()
    tx, ty = TData(n_samples=300, n_features=24, n_classes=6,
                   seed=5).generate()
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    for a, b in zip(t_split(ty, 4, seed=1), j_split(jy, 4, seed=1)):
        np.testing.assert_array_equal(a, b)
    assert t_cfgs(5, [100] * 5, seed=3, beta_menu=(0.1, 0.2)) == [
        TWorkerConfig(**vars(c))
        for c in j_cfgs(5, [100] * 5, seed=3, beta_menu=(0.1, 0.2))]
    jl = j_loaders((jx, jy), j_split(jy, 3, seed=1), seed=2)
    tl = t_loaders((tx, ty), t_split(ty, 3, seed=1), seed=2)
    for a, b in zip(tl, jl):
        assert a.batch_size == b.batch_size
        for ta, ja in zip(a.epoch_indices(), b.epoch_indices()):
            np.testing.assert_array_equal(ta, ja)


def test_quickstart_federation_matches():
    jparams, params_np = _init_np()
    jw, _ = _federation(JData, j_split, j_loaders, j_cfgs, JWorker, j_lag)
    tw, (xte, yte) = _federation(TData, t_split, t_loaders, t_cfgs,
                                 TWorker, t_lag)
    jres = JSim(jw, jparams).run_fedpc(rounds=10)
    tsim = TSim(tw, params_from_numpy(params_np, device="cpu"),
                eval_fn=lambda p: mlp_accuracy(p, xte, yte), device="cpu")
    tres = tsim.run_fedpc(rounds=10, eval_every=5)

    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-3)
    assert tres.costs[-1] < tres.costs[0]
    assert [t for t, _ in tres.eval_history] == [5, 10]
    assert sorted({k for (_, _, k, _) in tsim.ledger.events}) == [
        "cost", "packed_ternary", "pilot_params"]
    assert int(tres.round_state.round) == 11
    for a, b in zip(tree_leaves(tres.params),
                    jax.tree_util.tree_leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_train_round_device_matches(optimizer):
    # One worker, one round of local training from the same weights and
    # batches: float32 agreement up to the reduction-order drift above.
    jparams, params_np = _init_np()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((200, 24), dtype=np.float32)
    y = rng.integers(0, 6, 200).astype(np.int32)
    kw = dict(worker_id=0, batch_size=32, lr_decay_every=3, local_epochs=2,
              optimizer=optimizer)
    jwk = JWorker(JWorkerConfig(**kw), JBatchIterator((x, y), 32, seed=9),
                  j_lag)
    twk = TWorker(TWorkerConfig(**kw), BatchIterator((x, y), 32, seed=9),
                  t_lag)
    jq, jc = jwk.train_round_device(jparams)
    tq, tc = twk.train_round_device(params_from_numpy(params_np,
                                                      device="cpu"))
    assert twk.step == jwk.step == 14
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
    for a, b in zip(tree_leaves(tq), jax.tree_util.tree_leaves(jq)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_unported_branches_raise():
    # Partial participation, the audit of enforce=True and the evasion
    # defence are ported: they run as in the JAX simulator (participation
    # books the sampled workers only; the enforced masked round records
    # the JAX simulator's audit before its first round).
    jparams, params_np = _init_np()
    jw, _ = _federation(JData, j_split, j_loaders, j_cfgs, JWorker, j_lag)
    tw, _ = _federation(TData, t_split, t_loaders, t_cfgs, TWorker, t_lag)
    jsim = JSim(jw, jparams)
    jres = jsim.run_fedpc(rounds=2, participation=0.5, participation_seed=4)
    sim = TSim(tw, params_from_numpy(params_np, device="cpu"), device="cpu")
    tres = sim.run_fedpc(rounds=2, participation=0.5, participation_seed=4)
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    sim.fed_cfg = TCfg(n_workers=3, privacy=TSpec())     # enforce=True
    jsim.fed_cfg = JCfg(n_workers=3, privacy=JSpec())
    jres = jsim.run_fedpc(rounds=1, wire_block_workers=1)
    tres = sim.run_fedpc(rounds=1, wire_block_workers=1)
    assert tres.pilot_history == jres.pilot_history
    assert sim.ledger.audits == jsim.ledger.audits == [
        {"runtime": "run_fedpc", "boundary": "round-step", "n_launches": 2,
         "masked": True}]
    sim.fed_cfg = TCfg(n_workers=3)
    jsim.fed_cfg = JCfg(n_workers=3)
    jsim.evade_streak = sim.evade_streak = 2
    jres = jsim.run_fedpc(rounds=3)
    tres = sim.run_fedpc(rounds=3)
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    assert sim.ledger.events == jsim.ledger.events


@pytest.mark.parametrize("frac", [1.5, 0.0, -1.0])
def test_participation_out_of_range_raises_as_reference(frac):
    # Refused before anything runs, with the JAX simulator's message, and
    # before the audit of enforce=True.
    jparams, params_np = _init_np()
    jw, _ = _federation(JData, j_split, j_loaders, j_cfgs, JWorker, j_lag)
    tw, _ = _federation(TData, t_split, t_loaders, t_cfgs, TWorker, t_lag)
    with pytest.raises(ValueError) as jerr:
        JSim(jw, jparams).run_fedpc(rounds=1, participation=frac,
                                    participation_seed=3)
    tsim = TSim(tw, params_from_numpy(params_np, device="cpu"),
                device="cpu")
    with pytest.raises(ValueError) as terr:
        tsim.run_fedpc(rounds=1, participation=frac, participation_seed=3)
    assert str(terr.value) == str(jerr.value)
    assert str(terr.value) == f"participation must be in (0, 1], got {frac}"
    tsim.fed_cfg = TCfg(n_workers=3, privacy=TSpec())    # enforce=True
    with pytest.raises(ValueError, match=r"must be in \(0, 1\]"):
        tsim.run_fedpc(rounds=1, participation=frac)


def test_participation_seed_accepted_at_full_participation():
    jparams, params_np = _init_np()
    jw, _ = _federation(JData, j_split, j_loaders, j_cfgs, JWorker, j_lag)
    tw, _ = _federation(TData, t_split, t_loaders, t_cfgs, TWorker, t_lag)
    jres = JSim(jw, jparams).run_fedpc(rounds=2, participation=1.0,
                                       participation_seed=7)
    tres = TSim(tw, params_from_numpy(params_np, device="cpu"),
                device="cpu").run_fedpc(rounds=2, participation=1.0,
                                        participation_seed=7)
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
