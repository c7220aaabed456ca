"""A transformer federated through the port's ``FedSimulator`` against the
JAX package's, as ``examples/federated_llm_training.py`` and
``launch/train.py simulate`` set it up: ``SyntheticLM`` sequences split by
``sequence_split``, workers from ``make_worker_configs(batch_menu=(16,
8))``, each training the model's loss (reduced ``fedpc-paper``, and a
reduced ``deepseek-moe-16b``), from the JAX package's own initial weights
carried across.

The data and splits are numpy in both packages: bitwise equal. Pilots and
the byte ledger of 2 ``run_fedpc`` rounds are equal; costs within
``rtol=1e-4`` and the final params within ``rtol=1e-4, atol=1e-6`` (XLA
and ATen sum a gradient in other orders, float32 drift over a few dozen
optimizer steps). One worker's round under Adam: every entry within
``atol=1e-3``, a tenth of one Adam step at lr 0.01, and 99.9% of them
within the float32 drift above; Adam divides each gradient by its running
root-mean-square, so an entry whose gradient is near Adam's eps = 1e-8
turns a rounding difference into a sizeable part of a step. The wire fed
with the JAX workers' own trained locals
gives the JAX wire's packed bytes and new buffer bit for bit, at both
round branches. The Pallas kernels run in interpret mode with
``block_workers=1``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.pipeline import BatchIterator as JBatchIterator
from repro.data.synthetic import SyntheticLM as JLM
from repro.data.synthetic import sequence_split as jsplit
from repro.fed import rounds as jrd
from repro.fed.simulator import FedSimulator as JSim
from repro.fed.worker import Worker as JWorker
from repro.fed.worker import make_worker_configs as jcfgs
from repro.models import build_model as jbuild
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import BatchIterator as TBatchIterator
from repro_torch.data.synthetic import SyntheticLM as TLM
from repro_torch.data.synthetic import sequence_split as tsplit
from repro_torch.fed import rounds as trd
from repro_torch.fed.simulator import FedSimulator as TSim
from repro_torch.fed.worker import Worker as TWorker
from repro_torch.fed.worker import make_worker_configs as tcfgs
from repro_torch.models import build_model as tbuild
from repro_torch.utils import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
N = 3
ARCH = "fedpc-paper"
DRIFT = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed,iid", [(0, True), (1, True), (2, False)])
def test_lm_data_and_splits_are_the_same_draws(seed, iid):
    kw = dict(n_sequences=40, seq_len=24, vocab=97, seed=seed)
    np.testing.assert_array_equal(TLM(**kw).generate(), JLM(**kw).generate())
    for a, b in zip(tsplit(40, 5, seed=seed, iid=iid),
                    jsplit(40, 5, seed=seed, iid=iid)):
        np.testing.assert_array_equal(a, b)


_FED: dict = {}


def _fed(arch: str = ARCH):
    """The JAX and port models of ``arch``, the JAX initial weights, the
    tokens and splits, made once an arch."""
    if arch not in _FED:
        cfg = jget(arch).reduced()
        jm, tm = jbuild(cfg), tbuild(tget(arch).reduced())
        toks = JLM(n_sequences=48, seq_len=32, vocab=cfg.vocab,
                   seed=0).generate()
        splits = jsplit(len(toks), N, seed=1)
        jlag = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, {"tokens": jnp.asarray(b[0])}),
            has_aux=True))
        jp = jm.init(jax.random.PRNGKey(0))
        _FED[arch] = dict(jm=jm, tm=tm, toks=toks, splits=splits,
                          jlag=jlag, jp=jp,
                          np=jax.tree_util.tree_map(np.asarray, jp))
    return _FED[arch]


def _workers(port: bool, arch: str = ARCH, **cfg_kw):
    """The federation's workers, each config with ``cfg_kw`` replaced."""
    f = _fed(arch)
    make, loader, worker, lag = (
        (tcfgs, TBatchIterator, TWorker, f["tm"].loss_and_grad) if port
        else (jcfgs, JBatchIterator, JWorker, f["jlag"]))
    cfgs = [dataclasses.replace(c, **cfg_kw) for c in make(
        N, [len(s) for s in f["splits"]], seed=2, batch_menu=(16, 8))]
    return [worker(cfg=cfgs[k],
                   loader=loader((f["toks"][f["splits"][k]],),
                                 cfgs[k].batch_size, seed=k),
                   loss_and_grad=lag)
            for k in range(N)]


def test_lm_federation_matches():
    f = _fed()
    jres = JSim(_workers(False), f["jp"]).run_fedpc(rounds=2,
                                                  wire_block_workers=1)
    tres = TSim(_workers(True), params_from_numpy(f["np"], device="cpu"),
                device="cpu").run_fedpc(rounds=2, wire_block_workers=1)
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-4)
    for a, b in zip(tree_leaves(tres.params),
                    jax.tree_util.tree_leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **DRIFT)


def test_moe_lm_federation_matches():
    # The reduced DeepSeekMoE (a dense first layer, then attention + MoE
    # blocks routing top-2 of 4 experts): its loss carries the router's
    # auxiliaries, as the reference's does. Its 2.8M params give an
    # evolution entry within float32 drift of an Eq. (5) threshold a few
    # times: that entry takes the neighbouring ternary code in one package,
    # and its new value moves by w_k |p1 - p2| there (5 entries, at most
    # 1.8e-5, measured; the rest within 7.5e-9). So 99.999% of the entries
    # are held to DRIFT and every one within atol=1e-4.
    arch = "deepseek-moe-16b"
    f = _fed(arch)
    jres = JSim(_workers(False, arch), f["jp"]).run_fedpc(
        rounds=2, wire_block_workers=1)
    tres = TSim(_workers(True, arch), params_from_numpy(f["np"],
                                                        device="cpu"),
                device="cpu").run_fedpc(rounds=2, wire_block_workers=1)
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-4)
    near = []
    for a, b in zip(tree_leaves(tres.params),
                    jax.tree_util.tree_leaves(jres.params)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        near.append(np.isclose(a, b, **DRIFT).ravel())
    assert np.concatenate(near).mean() >= 0.99999


@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_lm_worker_round_matches(optimizer):
    # One worker's round of local training through the model's
    # loss_and_grad, from the same weights and batches.
    f = _fed()
    jw = _workers(False, optimizer=optimizer)[0]
    tw = _workers(True, optimizer=optimizer)[0]
    jq, jc = jw.train_round_device(f["jp"])
    tq, tc = tw.train_round_device(params_from_numpy(f["np"], device="cpu"))
    assert tw.step == jw.step > 0
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
    near = []
    for a, b in zip(tree_leaves(tq), jax.tree_util.tree_leaves(jq)):
        a, b = a.numpy(), np.asarray(b)
        if optimizer == "adam":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
            near.append(np.isclose(a, b, **DRIFT).ravel())
        else:
            np.testing.assert_allclose(a, b, **DRIFT)
    if near:
        assert np.concatenate(near).mean() >= 0.999


def _bits(x):
    return np.asarray(x).view(np.uint32)


def test_wire_on_the_jax_locals_is_bitwise():
    f = _fed()
    jw = _workers(False)
    je = jrd.RoundEngine(f["jp"])
    te = trd.RoundEngine(params_from_numpy(f["np"], device="cpu"),
                         device="cpu")
    sizes = np.array([w.loader.n for w in jw], np.float32)
    shares = sizes / sizes.sum()
    params = f["jp"]
    for t, k in ((1, 2), (2, 0)):
        jlocals = [w.train_round_device(params)[0] for w in jw]
        jb = je.flatten_locals(jlocals)
        tb = te.flatten_locals([params_from_numpy(
            jax.tree_util.tree_map(np.asarray, q), device="cpu")
            for q in jlocals])
        np.testing.assert_array_equal(_bits(tb.numpy()), _bits(jb))
        jwt = je.wire.weights(jnp.asarray(shares), k, t)
        twt = te.wire.weights(torch.from_numpy(shares), torch.tensor(k), t)
        jnew, jpk = je.wire.round_from_stacked(jb, k, jwt, je.buf_p1,
                                               je.buf_p2, t=t)
        tnew, tpk = te.wire.round_from_stacked(tb, torch.tensor(k), twt,
                                               te.buf_p1, te.buf_p2, t=t)
        np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
        np.testing.assert_array_equal(_bits(tnew.numpy()), _bits(jnew))
        params = je.run_round(jb, k, jnp.asarray(shares), t)
        te.run_round(tb, torch.tensor(k), torch.from_numpy(shares), t)
        np.testing.assert_array_equal(_bits(te.buf_p1.numpy()),
                                      _bits(je.buf_p1))


@pytest.mark.parametrize("script,args,want", [
    ("serve_llm_torch.py", ["--arch", "mistral-nemo-12b", "--prompt-len",
                            "80", "--new-tokens", "4"], "[serve] decoded 4"),
    ("federated_llm_training_torch.py", ["--rounds", "2", "--sequences",
                                         "48", "--seq-len", "32"],
     "saved by FedPC")])
def test_torch_lm_examples_run_on_the_cpu(script, args, want):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *args], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert want in proc.stdout
