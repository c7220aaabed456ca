"""A transformer federated through the scan driver: the port's
``FedSimulator.run_fedpc_scan`` on LM workers against the JAX package's
``run_fedpc_scan`` and against the port's own ``run_fedpc``.

The federation: reduced ``qwen3-14b``, 2 workers, 48 ``SyntheticLM``
sequences of 32 tokens in two equal contiguous shards of 24, batch 8 (so
every shard is a multiple of its batch and each worker's local training
runs ``Worker.scan_train``), 2 rounds, the JAX package's initial weights
carried across (as ``tests/test_torch_lm_fed.py`` carries them).
Against the JAX driver: pilots and bytes equal, costs within
``rtol=1e-4`` and the final params within ``tests/test_torch_lm_fed.py``'s
``DRIFT`` (XLA and ATen sum a gradient in other orders), but at most
``FLIPS`` entries, each within one code step of Eq. (3). Against the port's ``run_fedpc`` from the same state,
with and without ``participation=``: pilots, costs, bytes and every
leaf bitwise. The Pallas kernels run in interpret mode with
``block_workers=1``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.core import flat as jfl
from repro.data.pipeline import BatchIterator as JBatchIterator
from repro.data.synthetic import SyntheticLM
from repro.fed.simulator import FedSimulator as JSim
from repro.fed.worker import Worker as JWorker
from repro.fed.worker import make_worker_configs as jcfgs
from repro.models import build_model as jbuild
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import flat as tfl
from repro_torch.data.pipeline import BatchIterator as TBatchIterator
from repro_torch.fed.simulator import FedSimulator as TSim
from repro_torch.fed.worker import Worker as TWorker
from repro_torch.fed.worker import make_worker_configs as tcfgs
from repro_torch.models import build_model as tbuild
from repro_torch.utils import tree_leaves

ARCH = "qwen3-14b"
N, ROUNDS, BATCH = 2, 2, 8
SEQUENCES, SEQ_LEN = 48, 32
DRIFT = dict(rtol=1e-4, atol=1e-6)        # tests/test_torch_lm_fed.py's
# An entry within float32 drift of an Eq. (5) threshold in the last round
# takes the neighbouring ternary code in one package, and its new value
# moves by one code step of Eq. (3), 2 w_k |P^1 - P^0| (w_k <= 1; P^1 the
# first round's model, P^0 the initial one), as in
# tests/test_torch_distributed_step.py. With weights drawn by the port
# instead of the JAX package's, one entry flipped here.
FLIPS = 2


@pytest.fixture(scope="module")
def fed():
    """The two models, the JAX initial weights and the equal shards."""
    cfg = jget(ARCH).reduced()
    jm, tm = jbuild(cfg), tbuild(tget(ARCH).reduced())
    toks = SyntheticLM(n_sequences=SEQUENCES, seq_len=SEQ_LEN,
                       vocab=cfg.vocab, seed=0).generate()
    shards = np.array_split(np.arange(SEQUENCES), N)
    jlag = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, {"tokens": jnp.asarray(b[0])}),
        has_aux=True))
    jp = jm.init(jax.random.PRNGKey(0))
    return dict(tm=tm, toks=toks, shards=shards, jlag=jlag, jp=jp,
                np=jax.tree_util.tree_map(np.asarray, jp))


def _workers(fed, port: bool):
    make, loader, worker, lag = (
        (tcfgs, TBatchIterator, TWorker, fed["tm"].loss_and_grad) if port
        else (jcfgs, JBatchIterator, JWorker, fed["jlag"]))
    cfgs = make(N, [len(s) for s in fed["shards"]], seed=2,
                batch_menu=(BATCH,))
    return [worker(cfg=cfgs[k],
                   loader=loader((fed["toks"][fed["shards"][k]],),
                                 cfgs[k].batch_size, seed=k),
                   loss_and_grad=lag)
            for k in range(N)]


def _port_sim(fed):
    return TSim(_workers(fed, True), params_from_numpy(fed["np"],
                                                       device="cpu"),
                device="cpu")


@pytest.fixture(scope="module")
def jax_scan(fed):
    """The JAX package's scan driver on the federation, run once."""
    workers = _workers(fed, False)
    assert all(w.uniform_batches for w in workers)
    return JSim(workers, fed["jp"]).run_fedpc_scan(ROUNDS,
                                                   wire_block_workers=1)


@pytest.fixture(scope="module")
def port_scan(fed):
    sim = _port_sim(fed)
    assert all(w.uniform_batches for w in sim.workers)
    return sim.run_fedpc_scan(ROUNDS, wire_block_workers=1)


def test_lm_scan_matches_the_jax_scan(fed, jax_scan, port_scan):
    assert port_scan.pilot_history == jax_scan.pilot_history
    assert port_scan.bytes_per_round == list(jax_scan.bytes_per_round)
    np.testing.assert_allclose(port_scan.costs, jax_scan.costs, rtol=1e-4)
    # on the flat (rows, 128) buffers, whose layout both packages share
    got = tfl.flatten_tree(port_scan.params,
                           tfl.layout_of(port_scan.params)).numpy()
    want = np.asarray(jax_scan.round_state.buf_p1)      # P^2
    p1 = np.asarray(jax_scan.round_state.buf_p2)
    p0 = np.asarray(jfl.FlatParams.from_tree(fed["jp"]).buf)
    assert np.isfinite(got).all() and not np.array_equal(want, p0)
    np.testing.assert_array_equal(want, np.asarray(jfl.FlatParams.from_tree(
        jax_scan.params).buf))
    far = ~np.isclose(got, want, **DRIFT)
    assert far.sum() <= FLIPS, int(far.sum())
    np.testing.assert_array_less(np.abs(got - want)[far],
                                 2 * np.abs(p1 - p0)[far] + 1e-6
                                 + 1e-4 * np.abs(want[far]))


def _bitwise(a, b):
    assert a.pilot_history == b.pilot_history
    assert a.bytes_per_round == b.bytes_per_round
    np.testing.assert_array_equal(np.asarray(a.costs), np.asarray(b.costs))
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_lm_scan_equals_run_fedpc(fed, port_scan):
    _bitwise(port_scan, _port_sim(fed).run_fedpc(ROUNDS,
                                                 wire_block_workers=1))


def test_lm_scan_equals_run_fedpc_under_participation(fed):
    kw = dict(participation=0.5, participation_seed=1, wire_block_workers=1)
    scan = _port_sim(fed).run_fedpc_scan(ROUNDS, **kw)
    _bitwise(scan, _port_sim(fed).run_fedpc(ROUNDS, **kw))
