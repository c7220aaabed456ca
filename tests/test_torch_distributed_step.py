"""The port's ``build_fed_step`` and its CLI (``launch.train``) against the
JAX package's.

Reduced ``fedpc-paper`` (a 2-layer transformer), the same initial weights
and token batches from numpy (``_torch_dist.step_params`` /
``step_tokens``), 2 rounds of 2 local momentum-SGD steps a worker:
``fedpc_packed`` on the (2, 2) mesh, and the masked wire
(``PrivacySpec()``) with a participation mask on (4, 1). The JAX runtime
runs on ``Mesh(devs, ("data", "model"))`` over forced host devices; the
port on gloo ranks on the CPU.

Pass conditions: the same pilot each round; the round's mean cost within
``rtol=1e-4`` and the initial weights bitwise; the final global params
and every worker's optimizer state within ``rtol=1e-4, atol=1e-6`` of
the JAX run's, the float32 drift of XLA's and ATen's other summation
orders over a few local steps (as the federated-LM tests allow; a local
model drifting across a ternarization threshold would flip a code and
fail it); the optimizer state of the worker that sits out stays at its
initial zeros.

The CLI runs in a subprocess with ``--device cpu``: ``simulate`` for 2
rounds and ``distributed`` on an F = 2, M = 1 mesh for 1 round.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_dist as H

DRIFT = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_step")
    oracle = H.start_oracle(H.STEP_ORACLE, str(d / "oracle.npz"))
    port = {}
    for name, (F, M), *_ in H.STEP_CASES:
        port.update(H.run_ranks({"task": "step", "case": name, "F": F,
                                 "M": M}, str(d)))
    return H.oracle_result(oracle), port


@pytest.mark.parametrize("case", H.STEP_CASES, ids=lambda c: c[0])
def test_same_pilots_and_costs(runs, case):
    oracle, port = runs
    name = case[0]
    np.testing.assert_array_equal(port["init"].view(np.uint32),
                                  oracle["init"].view(np.uint32))
    for r in range(H.STEP["rounds"]):
        assert int(port[f"{name}_k{r}"]) == int(oracle[f"{name}_k{r}"])
        np.testing.assert_allclose(port[f"{name}_cost{r}"],
                                   oracle[f"{name}_cost{r}"], rtol=1e-4)


@pytest.mark.parametrize("case", H.STEP_CASES, ids=lambda c: c[0])
def test_params_within_drift(runs, case):
    oracle, port = runs
    name = case[0]
    got, want = port[f"{name}_params"], oracle[f"{name}_params"]
    assert np.isfinite(got).all()
    assert not np.array_equal(want, oracle["init"])   # the rounds moved it
    np.testing.assert_allclose(got, want, **DRIFT)


def test_sitting_out_freezes_the_optimizer(runs):
    oracle, port = runs
    name = "masked"
    F = 4
    for f in range(F):
        np.testing.assert_allclose(port[f"{name}_opt{f}"],
                                   oracle[f"{name}_opt{f}"], **DRIFT)
    assert not port[f"{name}_opt1"].any()      # worker 1 never trained
    assert port[f"{name}_opt0"].any()


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=H.SRC, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=env, capture_output=True, text=True,
                          timeout=240)


def test_cli_simulate_on_the_cpu():
    proc = _cli("simulate", "--device", "cpu", "--rounds", "2",
                "--workers", "3", "--sequences", "48", "--seq-len", "32")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[train] fedpc on fedpc-paper: cost" in proc.stdout


def test_cli_distributed_on_the_cpu():
    proc = _cli("distributed", "--backend", "gloo", "--device", "cpu",
                "--fed-workers", "2", "--model-shards", "1", "--rounds", "1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[train] round 1: cost=" in proc.stdout
