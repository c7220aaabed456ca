"""The port's baselines against ``repro.fed.simulator`` and
``repro.core.baselines``: FedAvg, Phong et al. and the centralized bound.

The federation is ``test_torch_sim``'s quickstart one (3 workers, MLP
24→64→64→6, the same numpy data, splits, loaders and worker configs, the
JAX initial weights carried across). Bytes per round are equal; costs
agree within ``rtol=1e-3`` and final params within ``rtol=1e-3,
atol=1e-5``, the float32 drift of local training that ``test_torch_sim``
explains (XLA and ATen reduce and contract in other orders). The FedAvg
aggregate itself is bitwise: the weights are float32 ``sizes / sum(sizes)``
(the sum of integer sizes is exact) and the sum is ``w_0·t_0`` then
``+ w_k·t_k``, each product and sum rounded on its own in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro.data.pipeline import BatchIterator as JBatchIterator
from repro.data.pipeline import federated_loaders as j_loaders
from repro.data.synthetic import SyntheticClassification as JData
from repro.data.synthetic import random_share_split as j_split
from repro.fed.simulator import FedSimulator as JSim
from repro.fed.worker import Worker as JWorker
from repro.fed.worker import make_worker_configs as j_cfgs
from repro.models.mlp import init_mlp_classifier as j_init
from repro.models.mlp import mlp_loss_and_grad as j_lag
from repro_torch.convert import params_from_numpy
from repro_torch.core import baselines as tbl
from repro_torch.core import protocol as proto
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.pipeline import federated_loaders as t_loaders
from repro_torch.data.synthetic import SyntheticClassification as TData
from repro_torch.data.synthetic import random_share_split as t_split
from repro_torch.fed.simulator import FedSimulator as TSim
from repro_torch.fed.worker import Worker as TWorker
from repro_torch.fed.worker import make_worker_configs as t_cfgs
from repro_torch.models.mlp import init_mlp_classifier as t_init
from repro_torch.models.mlp import mlp_accuracy
from repro_torch.models.mlp import mlp_loss_and_grad as t_lag
from repro_torch.utils import tree_leaves


def _federation(data, split, loaders, cfgs, worker, lag):
    x, y = data(n_samples=1800, n_features=24, n_classes=6, seed=0).generate()
    splits = split(y[:1500], n_workers=3, seed=1)
    lds = loaders((x[:1500], y[:1500]), splits, seed=2)
    wcfg = cfgs(3, [len(s) for s in splits], seed=3)
    return [worker(cfg=wcfg[k], loader=lds[k], loss_and_grad=lag)
            for k in range(3)], (x, y)


def _sims():
    """The same federation in both packages, from the same weights."""
    jparams = j_init(jax.random.PRNGKey(0), 24, 6)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    jw, data = _federation(JData, j_split, j_loaders, j_cfgs, JWorker, j_lag)
    tw, _ = _federation(TData, t_split, t_loaders, t_cfgs, TWorker, t_lag)
    return (JSim(jw, jparams),
            TSim(tw, params_from_numpy(params_np, device="cpu"),
                 device="cpu"), data)


def _same_run(tres, jres):
    assert tres.algorithm == jres.algorithm
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    assert tres.total_bytes == jres.total_bytes
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-3)
    for a, b in zip(tree_leaves(tres.params),
                    jax.tree_util.tree_leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("algorithm", ["run_fedavg", "run_phong"])
def test_baseline_matches_reference(algorithm):
    jsim, tsim, _ = _sims()
    jres = getattr(jsim, algorithm)(rounds=8)
    tres = getattr(tsim, algorithm)(rounds=8)
    _same_run(tres, jres)
    v = proto.model_size_bytes(tsim.init_params)
    assert tres.bytes_per_round == [proto.fedavg_bytes_per_round(v, 3)] * 8
    assert tres.costs[-1] < tres.costs[0]
    assert tsim.ledger.events == []      # baselines book no FedPC uplinks


def test_centralized_matches_reference():
    jsim, tsim, (x, y) = _sims()
    cfg = tsim.workers[0].cfg
    jc = JWorker(cfg=jsim.workers[0].cfg,
                 loader=JBatchIterator((x[:1500], y[:1500]), 64, seed=9),
                 loss_and_grad=j_lag)
    tc = TWorker(cfg=cfg, loader=BatchIterator((x[:1500], y[:1500]), 64,
                                               seed=9),
                 loss_and_grad=t_lag)
    jres = jsim.run_centralized(4, jc)
    tres = tsim.run_centralized(4, tc)
    _same_run(tres, jres)
    assert tres.bytes_per_round == [0.0] * 4
    assert tc.step == jc.step


# -- the port's versions of tests/test_fed_sim.py's comparisons ------------

@pytest.fixture(scope="module")
def task():
    x, y = TData(n_samples=1200, n_features=16, n_classes=5,
                 seed=0).generate()
    return x[:1000], y[:1000], x[1000:], y[1000:]


def _make_sim(task, n=4, seed=0):
    xtr, ytr, xte, yte = task
    splits = t_split(ytr, n, seed=seed)
    loaders = t_loaders((xtr, ytr), splits, seed=seed, batch_menu=(64, 32))
    cfgs = t_cfgs(n, [len(s) for s in splits], seed=seed,
                  batch_menu=(64, 32))
    workers = [TWorker(cfg=cfgs[k], loader=loaders[k], loss_and_grad=t_lag)
               for k in range(n)]
    params = t_init(torch.Generator().manual_seed(0), 16, 5, hidden=(32,),
                    device="cpu")
    return TSim(workers, params, eval_fn=lambda p: mlp_accuracy(p, xte, yte),
                device="cpu")


def test_comm_ordering_matches_eq8(task):
    sim = _make_sim(task)
    r_pc = sim.run_fedpc(rounds=2)
    r_avg = sim.run_fedavg(rounds=2)
    r_ph = sim.run_phong(rounds=2)
    assert r_pc.bytes_per_round[0] < r_avg.bytes_per_round[0]
    assert r_avg.bytes_per_round[0] == r_ph.bytes_per_round[0]


def test_phong_and_fedavg_learn(task):
    sim = _make_sim(task)
    r_avg = sim.run_fedavg(rounds=8, eval_every=8)
    r_ph = sim.run_phong(rounds=8, eval_every=8)
    assert r_avg.costs[-1] < r_avg.costs[0]
    assert r_ph.costs[-1] < r_ph.costs[0]
    assert r_avg.eval_history[-1][1] > 0.3
    assert r_ph.eval_history[-1][1] > 0.3


def test_fedpc_approximates_centralized(task):
    """Table 2's structure: FedPC within a few points of centralized."""
    xtr, ytr, _, _ = task
    sim = _make_sim(task)
    res_pc = sim.run_fedpc(rounds=15, eval_every=15)
    central = TWorker(cfg=sim.workers[0].cfg,
                      loader=BatchIterator((xtr, ytr), 64, seed=9),
                      loss_and_grad=t_lag)
    res_c = sim.run_centralized(15, central, eval_every=15)
    acc_pc = res_pc.eval_history[-1][1]
    acc_c = res_c.eval_history[-1][1]
    assert acc_pc > 0.4                      # actually learned
    assert acc_c - acc_pc < 0.25             # approximation gap bounded


# -- core.baselines against repro.core.baselines ---------------------------

def _locals(n, seed):
    rng = np.random.default_rng(seed)
    trees = [{"w": rng.standard_normal((7, 5), dtype=np.float32),
              "b": rng.standard_normal((5,), dtype=np.float32),
              "deep": {"v": rng.standard_normal((3, 2, 4),
                                                dtype=np.float32)}}
             for _ in range(n)]
    sizes = rng.integers(10, 1000, n).astype(np.float32)
    return trees, sizes


@pytest.mark.parametrize("n", [1, 3, 10])
def test_fedavg_aggregate_bitwise(n):
    trees, sizes = _locals(n, n)
    want = jbl.fedavg_aggregate(
        [jax.tree_util.tree_map(jnp.asarray, t) for t in trees], sizes)
    got = tbl.fedavg_aggregate(
        [params_from_numpy(t, device="cpu") for t in trees], sizes)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [1, 3, 10])
def test_fedavg_aggregate_stacked_bitwise(n):
    trees, sizes = _locals(n, 20 + n)
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)
    want = jbl.fedavg_aggregate_stacked(
        jax.tree_util.tree_map(jnp.asarray, stacked), sizes)
    got = tbl.fedavg_aggregate_stacked(
        params_from_numpy(stacked, device="cpu"), sizes)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the stacked form sums in the list form's order: the same bits
    listed = tbl.fedavg_aggregate(
        [params_from_numpy(t, device="cpu") for t in trees], sizes)
    for a, b in zip(tree_leaves(got), tree_leaves(listed)):
        assert torch.equal(a, b)


def test_phong_sequential_round_matches_reference():
    # Deterministic train functions: worker k scales by (k + 2) and adds
    # k, its cost the mean of the result; the model passes k -> k + 1.
    p0 = {"w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)}

    def fns(xp, mean):
        return [lambda p, k=k: (
            {"w": p["w"] * np.float32(k + 2) + np.float32(k)},
            mean(p["w"] * np.float32(k + 2) + np.float32(k)))
            for k in range(3)]
    jp, jc = jbl.phong_sequential_round(
        {"w": jnp.asarray(p0["w"])}, fns(jnp, lambda a: float(jnp.mean(a))))
    tp, tc = tbl.phong_sequential_round(
        params_from_numpy(p0, device="cpu"),
        fns(torch, lambda a: float(a.mean())))
    np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))
    # the costs are float32 means, reduced in each backend's own order
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-6)
    assert len(tc) == 3
    # the order matters: reversed, the same workers give another model
    rp, _ = tbl.phong_sequential_round(
        params_from_numpy(p0, device="cpu"),
        fns(torch, lambda a: float(a.mean()))[::-1])
    assert not torch.equal(rp["w"], tp["w"])
