"""Device-resident local training, the scan driver and partial
participation, against ``repro.fed.worker``, ``repro.fed.rounds`` and
``repro.fed.simulator``.

The federation is ``tests/test_fed_sim_scan.py``'s: N = 4 workers, the
MLP 16→32→5, 96 samples a worker and a batch menu of (32,), so every
shard is uniform. Held bitwise: the loaders' batching
(``drop_remainder`` too) and ``stack_round_batches``; ``step_decay`` at
the host and the device step; the plain ``round_step`` under a
participation mask over a 5-round chain; ``scan_rounds`` with a
precomputed schedule against in-loop sampling; the port's two drivers
against each other (uniform, with participation and per-worker beta_k,
3 + 3 rounds of continuation); the port's pilots, bytes, recovery bytes
and ledger events against the JAX simulator's under participation, on
the plain wire and on the masked wire under faults. ``scan_train``
against the reference's and the drivers' costs against the JAX
simulator's agree within the float32 drift ``test_torch_sim`` explains
(XLA and ATen reduce and contract in other orders); the cosine schedules
within an ulp of float32 ``cos``, which ``1 + cos`` carries into the lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as jfl
from repro.core.fedpc import FedPCConfig as JCfg
from repro.data.pipeline import BatchIterator as JBatchIterator
from repro.data.pipeline import federated_loaders as j_loaders
from repro.data.synthetic import SyntheticClassification as JData
from repro.fed import rounds as jrd
from repro.fed.faults import FaultPlan as JPlan
from repro.fed.simulator import FedSimulator as JSim
from repro.fed.worker import Worker as JWorker
from repro.fed.worker import WorkerConfig as JWorkerConfig
from repro.fed.worker import make_worker_configs as j_cfgs
from repro.models.mlp import init_mlp_classifier as j_init
from repro.models.mlp import mlp_loss_and_grad as j_lag
from repro.optim import schedules as jsched
from repro.privacy.spec import PrivacySpec as JSpec
from repro_torch import prng
from repro_torch.convert import params_from_numpy
from repro_torch.core import protocol as proto
from repro_torch.core.fedpc import FedPCConfig as TCfg
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.pipeline import federated_loaders as t_loaders
from repro_torch.data.synthetic import SyntheticClassification as TData
from repro_torch.fed import rounds as trd
from repro_torch.fed import worker as tworker
from repro_torch.fed.faults import FaultPlan as TPlan
from repro_torch.fed.simulator import FedSimulator as TSim
from repro_torch.fed.worker import Worker as TWorker
from repro_torch.fed.worker import WorkerConfig as TWorkerConfig
from repro_torch.fed.worker import make_worker_configs as t_cfgs
from repro_torch.models.mlp import mlp_loss_and_grad as t_lag
from repro_torch.optim import schedules as tsched
from repro_torch.privacy.spec import PrivacySpec as TSpec
from repro_torch.utils import tree_leaves

N = 4
PER = 96                 # samples a worker: a multiple of the 32 batch


def _federation(jax_side: bool, n: int = N, seed: int = 0):
    data, loaders, cfgs, worker, lag = (
        (JData, j_loaders, j_cfgs, JWorker, j_lag) if jax_side
        else (TData, t_loaders, t_cfgs, TWorker, t_lag))
    x, y = data(n_samples=n * PER, n_features=16, n_classes=5,
                seed=0).generate()
    splits = [np.arange(i * PER, (i + 1) * PER) for i in range(n)]
    lds = loaders((x, y), splits, seed=seed, batch_menu=(32,))
    wcfg = cfgs(n, [PER] * n, seed=seed, batch_menu=(32,))
    return [worker(cfg=wcfg[k], loader=lds[k], loss_and_grad=lag)
            for k in range(n)]


_JPARAMS = j_init(jax.random.PRNGKey(0), 16, 5, hidden=(32,))
_PARAMS_NP = jax.tree_util.tree_map(np.asarray, _JPARAMS)


def _tsim(cfg=None, n: int = N) -> TSim:
    return TSim(_federation(False, n), params_from_numpy(_PARAMS_NP,
                                                         device="cpu"),
                cfg, device="cpu")


def _jsim(cfg=None, n: int = N) -> JSim:
    return JSim(_federation(True, n), _JPARAMS, cfg)


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _assert_same_result(r1, r2):
    assert r1.pilot_history == r2.pilot_history
    assert r1.costs == r2.costs
    assert r1.bytes_per_round == r2.bytes_per_round
    for a, b in zip(tree_leaves(r1.params), tree_leaves(r2.params)):
        assert torch.equal(a, b)


# -- batching, schedules and the local-training recurrence -------------------

@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("bs", [32, 28, 96, 100])
def test_batching_matches_reference(bs, drop_remainder):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((96, 16), dtype=np.float32)
    y = rng.integers(0, 5, 96).astype(np.int32)
    jb = JBatchIterator((x, y), bs, seed=4, drop_remainder=drop_remainder)
    tb = BatchIterator((x, y), bs, seed=4, drop_remainder=drop_remainder)
    assert tb.steps_per_epoch() == jb.steps_per_epoch()
    for _ in range(2):
        js, ts = list(jb.epoch_indices()), list(tb.epoch_indices())
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a, b)
    kw = dict(worker_id=0, batch_size=bs, local_epochs=2)
    jw = JWorker(JWorkerConfig(**kw), JBatchIterator((x, y), bs, seed=5),
                 j_lag)
    tw = TWorker(TWorkerConfig(**kw), BatchIterator((x, y), bs, seed=5),
                 t_lag)
    assert tw.uniform_batches == jw.uniform_batches == (96 % bs == 0)
    if tw.uniform_batches:
        for a, b in zip(tw.stack_round_batches(), jw.stack_round_batches()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_schedules_match():
    # Up to k = 119 halvings: 0.01 * 2**-k stays a normal float32.
    steps = np.arange(0, 358, 7, dtype=np.int32)
    exact = [(jsched.step_decay(0.01, 0.5, 3), tsched.step_decay(0.01, 0.5,
                                                                 3)),
             (jsched.constant(0.03), tsched.constant(0.03))]
    near = [(jsched.cosine_decay(0.1, 300, 0.001),
             tsched.cosine_decay(0.1, 300, 0.001)),
            (jsched.warmup_cosine(0.1, 20, 300),
             tsched.warmup_cosine(0.1, 20, 300))]
    for pairs, exact_bits in ((exact, True), (near, False)):
        for jf, tf in pairs:
            for s in steps:
                want = np.asarray(jax.jit(jf)(jnp.int32(s)))
                got = tf(torch.tensor(s, dtype=torch.int32))
                assert got.dtype == torch.float32 and got.shape == ()
                if exact_bits:
                    assert _bits(got.numpy()) == _bits(want)
                else:   # one ulp of cos near ±1, times 0.5·(lr0 − floor)
                    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                               atol=0.05 * 2.0 ** -23)
    # Below 2**-126 the lr is subnormal: XLA:CPU flushes it to zero,
    # ATen keeps it. No run decays that far (k = step // every).
    sub = np.asarray(jax.jit(exact[0][0])(jnp.int32(400)))
    assert sub == 0.0
    assert 0.0 < float(exact[0][1](torch.tensor(400))) < 2.0 ** -126
    # The host step gives the device step's bits.
    host = tsched.step_decay(0.01, 0.5, 3)
    for s in steps:
        assert isinstance(host(int(s)), np.float32)
        assert _bits(host(int(s))) == _bits(
            host(torch.tensor(s, dtype=torch.int32)).numpy())


@pytest.mark.parametrize("optimizer", ["momentum", "adam", "sgd"])
def test_scan_train_matches_reference(optimizer):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((96, 16), dtype=np.float32)
    y = rng.integers(0, 5, 96).astype(np.int32)
    kw = dict(worker_id=0, batch_size=32, lr_decay_every=2, local_epochs=2,
              optimizer=optimizer)
    jw = JWorker(JWorkerConfig(**kw), JBatchIterator((x, y), 32, seed=9),
                 j_lag)
    tw = TWorker(TWorkerConfig(**kw), BatchIterator((x, y), 32, seed=9),
                 t_lag)
    jbatches = jw.stack_round_batches()
    tbatches = tw.stack_round_batches()
    for a, b in zip(tbatches, jbatches):
        np.testing.assert_array_equal(a, b)
    tparams = params_from_numpy(_PARAMS_NP, device="cpu")
    jp, jos, js, jc = jax.jit(jw.scan_train)(
        _JPARAMS, jw.opt.init(_JPARAMS), jnp.int32(5), jbatches)
    tp, tos, ts, tc = tw.scan_train(
        tparams, tw.opt.init(tparams), torch.tensor(5, dtype=torch.int32),
        tuple(torch.from_numpy(b) for b in tbatches))
    assert int(ts) == int(js) == 11
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
    for a, b in zip(tree_leaves((tp, tos)),
                    jax.tree_util.tree_leaves((jp, jos))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_train_round_device_is_scan_train_and_eager_loop_agrees():
    # Uniform shards run scan_train over device-gathered batches; the
    # eager per-batch loop from the same state computes the same round.
    a, b = _federation(False)[0], _federation(False)[0]
    params = params_from_numpy(_PARAMS_NP, device="cpu")
    qa, ca = a.train_round_device(params)
    qb, cb = b.train_round_eager(params)
    assert a.step == b.step == a.cfg.local_epochs * 3
    np.testing.assert_allclose(float(ca), float(cb), rtol=1e-6)
    for x, y in zip(tree_leaves((qa, a.opt_state)),
                    tree_leaves((qb, b.opt_state))):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-7)


# -- the round core under participation ---------------------------------------

def _chain_inputs(seed):
    rng = np.random.default_rng(seed)
    dims = [16, 32, 5]
    params = {f"layer{i}": {"w": rng.standard_normal(
        (dims[i], dims[i + 1]), dtype=np.float32) * 0.2,
        "b": np.zeros(dims[i + 1], np.float32)} for i in range(2)}
    layout = jfl.layout_of(jax.tree_util.tree_map(jnp.asarray, params))
    deltas = rng.standard_normal((N, layout.rows, 128),
                                 dtype=np.float32) * 0.02
    deltas.reshape(N, -1)[:, layout.n:] = 0.0       # keep the zero tail
    sizes = np.array([500.0, 300.0, 700.0, 400.0], np.float32)
    return rng, params, layout, deltas, sizes


@pytest.mark.parametrize("betas", [None, (0.1, 0.3, 0.2, 0.25)])
def test_round_step_with_participation_mask_bitwise(betas):
    rng, params, layout, _, sizes = _chain_inputs(0)
    jwire, twire = jrd.WirePath(jrd.WireConfig()), trd.WirePath(
        trd.WireConfig())
    js = jrd.init_round_state(jax.tree_util.tree_map(jnp.asarray, params),
                              N, layout, telemetry=False)
    ts = trd.init_round_state(params_from_numpy(params, device="cpu"), N,
                              device="cpu")
    masks = trd.participation_masks(prng.PRNGKey(1), 5, N, 0.5).numpy()
    jb = None if betas is None else jnp.asarray(betas, jnp.float32)
    tb = None if betas is None else torch.tensor(betas, dtype=torch.float32)
    for i in range(5):
        p1 = np.asarray(js.buf_p1)
        bufs = p1[None] + rng.standard_normal((N,) + p1.shape,
                                              dtype=np.float32) * 0.02
        bufs.reshape(N, -1)[:, layout.n:] = 0.0
        costs = rng.random(N, dtype=np.float32) + 0.5
        js, jnew, jinfo = jwire.round_step(
            js, jnp.asarray(bufs), jnp.asarray(costs), jnp.asarray(sizes),
            betas=jb, mask=jnp.asarray(masks[i]))
        ts, tnew, tinfo = twire.round_step(
            ts, torch.from_numpy(bufs), torch.from_numpy(costs),
            torch.from_numpy(sizes), betas=tb,
            mask=torch.from_numpy(masks[i]))
        assert int(tinfo["k_star"]) == int(jinfo["k_star"])
        assert masks[i][int(tinfo["k_star"])] > 0
        np.testing.assert_array_equal(_bits(tnew.numpy()), _bits(jnew))
        np.testing.assert_array_equal(_bits(tinfo["costs"].numpy()),
                                      _bits(jinfo["costs"]))
        np.testing.assert_array_equal(tinfo["mask"].numpy(), masks[i])
        for name in ("buf_p1", "buf_p2", "prev_costs"):
            np.testing.assert_array_equal(_bits(getattr(ts, name).numpy()),
                                          _bits(getattr(js, name)))


def _assert_same_state(a, b):
    for name in ("buf_p1", "buf_p2", "prev_costs", "round"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _scan_fixture(seed):
    _, params, layout, deltas, sizes = _chain_inputs(seed)
    state = trd.init_round_state(params_from_numpy(params, device="cpu"), N,
                                 device="cpu")
    d = torch.from_numpy(deltas)

    def worker_fn(carry, buf, t):
        bufs = buf[None] + d * t.float()
        return carry + 1, bufs, torch.full((N,), 1.0) / t.float()

    return state, worker_fn, torch.from_numpy(sizes)


def test_scan_rounds_in_loop_sampling_matches_schedule():
    state, worker_fn, sizes = _scan_fixture(4)
    wire = trd.WirePath(trd.WireConfig())
    key = prng.PRNGKey(5)
    masks = trd.participation_masks(key, 6, N, 0.6)
    st_a, carry_a, inf_a = trd.scan_rounds(wire, state, worker_fn, 0, 6,
                                           sizes, masks=masks)
    st_b, carry_b, inf_b = trd.scan_rounds(wire, state, worker_fn, 0, 6,
                                           sizes, participation=0.6,
                                           participation_key=key)
    assert carry_a == carry_b == 6
    _assert_same_state(st_a, st_b)
    assert set(inf_a) == set(inf_b) == {"k_star", "goodness", "costs",
                                        "mask", "telemetry"}
    for k in inf_a:
        a, b = ((inf_a[k], inf_b[k]) if k != "telemetry"
                else (torch.stack(inf_a[k]), torch.stack(inf_b[k])))
        assert a.shape[-1 if k == "telemetry" else 0] == 6
        assert torch.equal(a, b)
    assert torch.equal(inf_b["mask"], masks)
    # Keyed by the absolute round: 3 + 3 resumed rounds == 6.
    st_h, _, inf_h = trd.scan_rounds(wire, state, worker_fn, 0, 3, sizes,
                                     participation=0.6,
                                     participation_key=key)
    st_c, _, inf_c = trd.scan_rounds(wire, st_h, worker_fn, 0, 3, sizes,
                                     participation=0.6,
                                     participation_key=key)
    _assert_same_state(st_c, st_b)
    assert torch.equal(torch.cat([inf_h["k_star"], inf_c["k_star"]]),
                       inf_b["k_star"])


def test_scan_rounds_refusals_match_reference():
    state, worker_fn, sizes = _scan_fixture(0)
    wire = trd.WirePath(trd.WireConfig())
    jstate = jrd.init_round_state({"w": jnp.zeros((4, 4))}, N,
                                  telemetry=False)
    jwire = jrd.WirePath(jrd.WireConfig())
    masks = trd.participation_masks(prng.PRNGKey(0), 2, N, 0.5)
    for kw, jkw in (
            (dict(participation=0.5, participation_key=prng.PRNGKey(0),
                  masks=masks),
             dict(participation=0.5, participation_key=jax.random.PRNGKey(0),
                  masks=jnp.asarray(masks.numpy()))),
            (dict(participation=0.5), dict(participation=0.5)),
            (dict(participation=1.5, participation_key=prng.PRNGKey(0)),
             dict(participation=1.5,
                  participation_key=jax.random.PRNGKey(0)))):
        with pytest.raises(ValueError) as jerr:
            jrd.scan_rounds(jwire, jstate, worker_fn, 0, 2, np.ones(N), **jkw)
        with pytest.raises(ValueError) as terr:
            trd.scan_rounds(wire, state, worker_fn, 0, 2, sizes, **kw)
        assert str(terr.value) == str(jerr.value)


# -- the two drivers -----------------------------------------------------------

def test_scan_driver_bitwise_equals_python_driver():
    r1 = _tsim().run_fedpc(6)
    r2 = _tsim().run_fedpc_scan(6)
    _assert_same_result(r1, r2)
    assert int(r2.round_state.round) == 7


def test_scan_driver_parity_partial_participation_and_betas():
    kw = dict(participation=0.5, betas=[0.1, 0.2, 0.3, 0.25],
              participation_seed=3)
    s1, s2 = _tsim(), _tsim()
    r1 = s1.run_fedpc(6, **kw)
    r2 = s2.run_fedpc_scan(6, **kw)
    _assert_same_result(r1, r2)
    assert s1.ledger.events == s2.ledger.events
    for w1, w2 in zip(s1.workers, s2.workers):   # skipped rounds froze
        assert w1.step == w2.step
        for a, b in zip(tree_leaves(w1.opt_state), tree_leaves(w2.opt_state)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("participation", [None, 0.5])
@pytest.mark.parametrize("driver", ["run_fedpc", "run_fedpc_scan"])
def test_continuation_bitwise(driver, participation):
    kw = {} if participation is None else {"participation": participation}
    full = getattr(_tsim(), driver)(6, **kw)
    sim = _tsim()
    half = getattr(sim, driver)(3, **kw)
    cont = getattr(sim, driver)(3, state=half.round_state, **kw)
    for a, b in zip(tree_leaves(cont.params), tree_leaves(full.params)):
        assert torch.equal(a, b)
    assert half.pilot_history + cont.pilot_history == full.pilot_history
    assert half.costs + cont.costs == full.costs


_SYNCS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
          "__float__", "__index__")


@pytest.fixture
def host_conversions(monkeypatch):
    """Counts every tensor → host conversion (``item``, ``cpu``,
    ``numpy``, ``int``/``float``/``bool`` of a tensor ...) made while a
    driver runs; on the card each is a blocking device→host read."""
    calls = {"n": 0}
    for name in _SYNCS:
        real = getattr(torch.Tensor, name)

        def counting(self, *a, _real=real, **k):
            calls["n"] += 1
            return _real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counting)
    return calls


@pytest.mark.parametrize("participation", [None, 0.5])
@pytest.mark.parametrize("driver", ["run_fedpc", "run_fedpc_scan"])
def test_host_conversions_independent_of_rounds(driver, participation,
                                                host_conversions):
    counts = {}
    for rounds in (2, 5):
        sim = _tsim()
        host_conversions["n"] = 0
        getattr(sim, driver)(rounds, participation=participation)
        counts[rounds] = host_conversions["n"]
    assert counts[2] == counts[5], counts


# -- against the JAX simulator ------------------------------------------------

@pytest.fixture(scope="module")
def jax_participation_run():
    jsim = _jsim()
    res = jsim.run_fedpc(5, participation=0.5, participation_seed=1)
    return jsim, res


@pytest.mark.parametrize("driver", ["run_fedpc", "run_fedpc_scan"])
def test_partial_participation_matches_jax(driver, jax_participation_run):
    jsim, jres = jax_participation_run
    tsim = _tsim()
    tres = getattr(tsim, driver)(5, participation=0.5, participation_seed=1)
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    mb = proto.model_size_bytes(tsim.init_params)
    assert tres.bytes_per_round == [proto.fedpc_bytes_per_round(mb, 2)] * 5
    assert tsim.ledger.events == jsim.ledger.events
    masks = trd.participation_masks(prng.PRNGKey(1), 5, N, 0.5).numpy()
    for i in range(5):      # only sampled workers upload; the pilot too
        senders = {w for (r, w, _, _) in tsim.ledger.events if r == i + 1}
        assert senders == set(np.flatnonzero(masks[i]).tolist())
        assert masks[i][tres.pilot_history[i]] > 0
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-3)
    for a, b in zip(tree_leaves(tres.params),
                    jax.tree_util.tree_leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)


_PLAN = dict(seed=3, drop_before_uplink=0.1, drop_after_uplink=0.25,
             straggler=0.1)


@pytest.fixture(scope="module")
def jax_masked_faults_run():
    cfg = JCfg(n_workers=8, faults=JPlan(**_PLAN),
               privacy=JSpec(dp_epsilon=2.0, recovery_threshold=2,
                             enforce=False))
    jsim = _jsim(cfg, n=8)
    res = jsim.run_fedpc(4, participation=0.5, participation_seed=1,
                         wire_block_workers=1)
    return jsim, res


@pytest.mark.parametrize("driver", ["run_fedpc", "run_fedpc_scan"])
def test_masked_faults_participation_matches_jax(driver,
                                                 jax_masked_faults_run):
    jsim, jres = jax_masked_faults_run
    cfg = TCfg(n_workers=8, faults=TPlan(**_PLAN),
               privacy=TSpec(dp_epsilon=2.0, recovery_threshold=2,
                             enforce=False))
    tsim = _tsim(cfg, n=8)
    tres = getattr(tsim, driver)(4, participation=0.5, participation_seed=1,
                                 wire_block_workers=1)
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    assert tres.recovery_bytes_per_round == list(
        jres.recovery_bytes_per_round)
    assert tsim.ledger.events == jsim.ledger.events
    kinds = {k for (_, _, k, _) in tsim.ledger.events}
    assert {"seed_shares", "mask_recovery", "masked_words"} <= kinds
    dealt = {(r, w) for (r, w, k, _) in tsim.ledger.events
             if k == "seed_shares"}
    assert len(dealt) == 4 * 4          # 4 of 8 sampled, 4 rounds
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-3)


def test_scan_driver_refusals_match_reference():
    jsim, tsim = _jsim(), _tsim()
    jsim.workers[0].loader.batch_size = 28     # 96 % 28 != 0
    tsim.workers[0].loader.batch_size = 28
    with pytest.raises(ValueError, match="ragged") as jerr:
        jsim.run_fedpc_scan(2)
    with pytest.raises(ValueError, match="ragged") as terr:
        tsim.run_fedpc_scan(2)
    assert str(terr.value) == str(jerr.value)
    jsim, tsim = _jsim(), _tsim()
    jsim.evade_streak = tsim.evade_streak = 2
    with pytest.raises(ValueError, match="evade") as jerr:
        jsim.run_fedpc_scan(2)
    with pytest.raises(ValueError, match="evade") as terr:
        tsim.run_fedpc_scan(2)
    assert str(terr.value) == str(jerr.value)


def test_worker_menus_match_reference():
    from repro.fed import worker as jworker
    assert tworker.LR_MENU == jworker.LR_MENU
    assert tworker.BETA_MENU == jworker.BETA_MENU
    assert tworker.EPOCH_MENU == jworker.EPOCH_MENU
    assert tworker.OPT_MENU == jworker.OPT_MENU
