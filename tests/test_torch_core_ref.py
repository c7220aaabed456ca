"""The port's pytree reference round and the small core modules against
the JAX package, on the same numpy inputs.

* ``core.fedpc``: ``worker_ternary`` codes, ``master_round``'s pilot and
  goodness bitwise; its new params within ``rtol=1e-6, atol=1e-7``: the
  Eq. (3) sum ``Σ_k w_k T_k`` is a ``tensordot`` in both packages, whose
  products are exact (T_k ∈ {−1, 0, 1}) but whose float32 sum each
  backend orders its own way, an ulp of the sum at most per term.
* ``core.packing``, ``core.ternary``: bitwise. ``core.goodness.
  rotation_entropy``: within ``rtol=1e-6`` (a float32 sum of N terms).
* ``core.protocol``: every byte model exactly equal for N ∈ 1..64, the
  masked wire at 16- and 32-bit words, and ``CommLedger``'s records.
* ``data.synthetic.dirichlet_split``: the same index arrays.
* ``core.convergence.CostHistory`` and ``core.privacy``'s defences.
* ``examples/communication_comparison_torch.py`` prints what
  ``examples/communication_comparison.py`` prints.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convergence as jconv
from repro.core import fedpc as jfp
from repro.core.goodness import rotation_entropy as j_rotation_entropy
from repro.core import packing as jpack
from repro.core import privacy as jpriv
from repro.core import protocol as jproto
from repro.core import ternary as jtern
from repro.data import synthetic as jsyn
from repro_torch.convert import params_from_numpy
from repro_torch.core import convergence as tconv
from repro_torch.core import fedpc as tfp
from repro_torch.core import goodness as tgood
from repro_torch.core import packing as tpack
from repro_torch.core import privacy as tpriv
from repro_torch.core import protocol as tproto
from repro_torch.core import ternary as tterm
from repro_torch.data import synthetic as tsyn
from repro_torch.utils import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]


def _t(tree):
    return params_from_numpy(tree, device="cpu")


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _same_bits(got, want):
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _round_inputs(n: int, t: int, seed: int):
    """A global model and its history, N local models near it, costs and
    sizes; round 1 has no history (zeros) and +inf costs."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5), dtype=np.float32) * 0.1,
              "b": rng.standard_normal((5,), dtype=np.float32) * 0.1,
              "deep": {"v": rng.standard_normal((3, 4), dtype=np.float32)}}
    prev = (tree_map(np.zeros_like, params) if t == 1 else
            tree_map(lambda x: x + rng.standard_normal(x.shape).astype(
                np.float32) * 0.02, params))
    stacked = tree_map(lambda x: x[None] + rng.standard_normal(
        (n,) + x.shape).astype(np.float32) * 0.02, params)
    prev_costs = (np.full(n, np.inf, np.float32) if t == 1 else
                  rng.uniform(0.5, 2.0, n).astype(np.float32))
    costs = rng.uniform(0.4, 1.8, n).astype(np.float32)
    sizes = rng.integers(10, 500, n).astype(np.float32)
    return params, prev, stacked, prev_costs, costs, sizes


def _states(params, prev, prev_costs, t):
    js = jfp.FedPCState(_j(params), _j(prev), jnp.asarray(prev_costs),
                        jnp.asarray(t, jnp.int32))
    ts = tfp.FedPCState(_t(params), _t(prev), torch.from_numpy(prev_costs),
                        torch.tensor(t, dtype=torch.int32))
    return js, ts


@pytest.mark.parametrize("betas", [False, True])
@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_master_round_matches_reference(n, t, betas):
    params, prev, stacked, prev_costs, costs, sizes = _round_inputs(
        n, t, seed=100 * n + 10 * t + betas)
    bv = (tuple(float(b) for b in np.random.default_rng(n).choice(
        [0.1, 0.2, 0.3], n)) if betas else None)
    jcfg = jfp.FedPCConfig(n_workers=n, betas=bv)
    tcfg = tfp.FedPCConfig(n_workers=n, betas=bv)
    js, ts = _states(params, prev, prev_costs, t)
    for k in range(n):
        local = tree_map(lambda x: x[k], stacked)
        jb = None if bv is None else jcfg.beta_vector[k]
        tb = None if bv is None else tcfg.beta_vector("cpu")[k]
        _same_bits(tfp.worker_ternary(tcfg, _t(local), ts, tb),
                   jfp.worker_ternary(jcfg, _j(local), js, jb))
    jnew, jaux = jfp.master_round(jcfg, js, _j(stacked), jnp.asarray(costs),
                                  jnp.asarray(sizes))
    tnew, taux = tfp.fedpc_round(tcfg)(ts, _t(stacked),
                                       torch.from_numpy(costs),
                                       torch.from_numpy(sizes))
    assert int(taux["k_star"]) == int(jaux["k_star"])
    np.testing.assert_array_equal(taux["goodness"].numpy(),
                                  np.asarray(jaux["goodness"]))
    assert float(taux["ternary_density"]) == pytest.approx(
        float(jaux["ternary_density"]), rel=1e-6)
    for a, b in zip(tree_leaves(tnew.params),
                    jax.tree_util.tree_leaves(jnew.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    _same_bits(tnew.params_prev, js.params)
    np.testing.assert_array_equal(tnew.prev_costs.numpy(), costs)
    assert int(tnew.round) == int(jnew.round) == t + 1


@pytest.mark.parametrize("n,seed", [(2, 0), (3, 17), (4, 5), (6, 999)])
def test_master_round_consistency(n, seed):
    """Every worker reports the global model itself, past round 1 with
    P^{t-2} = P^{t-1}: the new global model is the same (fixed point)."""
    rng = np.random.default_rng(seed)
    params = {"w": torch.from_numpy(rng.normal(size=(4, 4)).astype(
        np.float32))}
    state = tfp.init_state(params, n)
    state = state._replace(round=torch.tensor(3, dtype=torch.int32),
                           params_prev=params)
    assert torch.equal(tfp.init_state(params, n).prev_costs,
                       torch.full((n,), float("inf")))
    stacked = tree_map(lambda x: torch.stack([x] * n), params)
    costs = torch.from_numpy(rng.uniform(0.1, 1.0, n).astype(np.float32))
    sizes = torch.from_numpy(rng.integers(10, 100, n).astype(np.float32))
    new_state, _ = tfp.master_round(tfp.FedPCConfig(n_workers=n), state,
                                    stacked, costs, sizes)
    torch.testing.assert_close(new_state.params["w"], params["w"], rtol=0,
                               atol=1e-6)


def test_worker_result_fields():
    r = tfp.WorkerResult(params={"w": torch.zeros(2)}, cost=torch.ones(()))
    assert r._fields == jfp.WorkerResult._fields
    assert tfp.FedPCState._fields == jfp.FedPCState._fields


# -- packing, ternary, goodness --------------------------------------------

def test_pack_tree_roundtrip_matches_reference():
    rng = np.random.default_rng(0)
    codes = {"a": rng.integers(-1, 2, (7, 3)).astype(np.int8),
             "b": [rng.integers(-1, 2, (5,)).astype(np.int8),
                   rng.integers(-1, 2, (2, 2, 2)).astype(np.int8)]}
    tbuf, tlayout = tpack.pack_tree(_t(codes))
    jbuf, _ = jpack.pack_tree(_j(codes))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    assert tbuf.numel() == tpack.packed_size(21 + 5 + 8) == \
        jpack.packed_size(34)
    _same_bits(tpack.unpack_tree(tbuf, tlayout), codes)
    for n in range(0, 40):
        assert tpack.packed_size(n) == jpack.packed_size(n)


@pytest.mark.parametrize("beta", [0.1, 0.5])
def test_ternarize_tree_matches_reference(beta):
    rng = np.random.default_rng(3)

    def tree():
        return {"w": rng.standard_normal((9, 4), dtype=np.float32) * 0.05,
                "b": rng.standard_normal((4,), dtype=np.float32) * 0.05}
    q, p1, p2 = tree(), tree(), tree()
    p2["w"][0] = p1["w"][0]                      # step == 0
    _same_bits(tterm.ternarize_tree(_t(q), _t(p1), _t(p2), beta),
               jtern.ternarize_tree(_j(q), _j(p1), _j(p2), beta))
    r1 = tterm.ternarize_tree_round1(_t(q), _t(p1), 0.01)
    _same_bits(r1, jtern.ternarize_tree_round1(_j(q), _j(p1), 0.01))
    assert float(tterm.ternary_density(r1["w"])) == pytest.approx(
        float(jtern.ternary_density(jnp.asarray(r1["w"].numpy()))),
        rel=1e-7)


@pytest.mark.parametrize("n", [1, 3, 10])
def test_rotation_entropy_matches_reference(n):
    rng = np.random.default_rng(n)
    for hist in (rng.integers(0, n, 40), np.zeros(12, np.int64),
                 np.arange(n)):
        got = float(tgood.rotation_entropy(torch.from_numpy(hist), n))
        want = float(j_rotation_entropy(jnp.asarray(hist), n))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert float(tgood.rotation_entropy(torch.arange(n), n)) == \
        pytest.approx(np.log(n), rel=1e-6)


# -- protocol ---------------------------------------------------------------

@pytest.mark.parametrize("word_bits", [16, 32])
def test_protocol_matches_reference(word_bits):
    for v in (1.0, 35e6, 83_992_616.0, 119e6):
        for n in range(1, 65):
            assert tproto.fedpc_bytes_per_round(v, n) == \
                jproto.fedpc_bytes_per_round(v, n)
            assert tproto._fedpc_wire_bytes(v, n, 2.0) == \
                jproto._fedpc_wire_bytes(v, n, 2.0)
            assert tproto.reduction_vs_fedavg(v, n) == \
                jproto.reduction_vs_fedavg(v, n)
            assert tproto.fedavg_bytes_per_round(v, n) == \
                jproto.fedavg_bytes_per_round(v, n)
            assert tproto.phong_bytes_per_round(v, n) == \
                jproto.phong_bytes_per_round(v, n)
            assert tproto.fedpc_masked_bytes_per_round(v, n, word_bits) \
                == jproto.fedpc_masked_bytes_per_round(v, n, word_bits)
    assert tproto.reduction_vs_fedavg(35e6, 10) == 0.421875
    assert tproto.fedpc_bytes_per_round(35e6, 10) == \
        35e6 * 11 + 35e6 * 9 / 16


def test_model_size_bytes_matches_reference():
    tree = {"w": np.zeros((3, 5), np.float32),
            "h": np.zeros((4,), np.float16)}
    assert tproto.model_size_bytes(_t(tree)) == \
        jproto.model_size_bytes(_j(tree)) == 19 * 4


def test_comm_ledger_matches_reference():
    tl, jl = tproto.CommLedger(), jproto.CommLedger()
    for mb, n, p in ((4000, 5, 1000), (4, 1, 1), (84, 10, 21), (0, 3, 0)):
        assert tl.record_round(mb, n, p) == jl.record_round(mb, n, p)
    assert (tl.downlink, tl.uplink_model, tl.uplink_ternary) == \
        (jl.downlink, jl.uplink_model, jl.uplink_ternary)
    assert tl.total() == jl.total()
    rec = tproto.CommLedger().record_round(4000, 5, 1000)
    assert rec["uplink_ternary"] == 250 * 4
    assert tproto.Command.SEND_MODEL.value == \
        jproto.Command.SEND_MODEL.value
    up = tproto.TernaryUpload(worker_id=1, round=2, packed=None, layout=None)
    assert up.round == 2
    assert tproto.CostReport(0, 1, 0.5).cost == 0.5
    assert tproto.ModelUpload(0, 1, {}).params == {}


# -- data, convergence, privacy -------------------------------------------

@pytest.mark.parametrize("alpha", [0.05, 0.3, 1.0, 10.0])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_dirichlet_split_matches_reference(alpha, seed):
    y = np.random.default_rng(seed).integers(0, 10, 800).astype(np.int64)
    for n in (2, 6, 12):
        got = tsyn.dirichlet_split(y, n, alpha=alpha, seed=seed)
        want = jsyn.dirichlet_split(y, n, alpha=alpha, seed=seed)
        assert len(got) == len(want) == n
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert len(a) >= 2


def test_cost_history_matches_reference():
    for costs in ([], [1.0], [3.0, 2.0, 2.5, 1.0, 0.999, 1.0, 1.0005, 1.0],
                  list(np.linspace(2, 1, 9)) + [1.0] * 6):
        th, jh = tconv.CostHistory(), jconv.CostHistory()
        for c in costs:
            th.append(np.float32(c))
            jh.append(np.float32(c))
        assert th.costs == jh.costs
        for kw in ({}, {"window": 3, "tol": 1e-2}):
            assert th.converged(**kw) == jh.converged(**kw)
        assert th.monotone_fraction() == jh.monotone_fraction()
        assert th.total_reduction() == jh.total_reduction()


def test_defences_match_reference():
    for s in range(6):
        for m in (1, 3):
            assert tpriv.should_evade(s, m) == jpriv.should_evade(s, m)
    assert tpriv.evade_cost(0.25) == jpriv.evade_cost(0.25)
    c = torch.tensor(0.7)
    assert tpriv.evade_cost(c) is c
    for nb in (1, 10):
        for lr in (True, False):
            assert tpriv.gradient_inversion_hardness(nb, lr) == \
                jpriv.gradient_inversion_hardness(nb, lr)
    led, jled = tpriv.LeakageLedger(), jpriv.LeakageLedger()
    for t in (1, 2, 3, 5, 6):
        led.record(0, t, "pilot_params", True)
        jled.record(0, t, "pilot_params", True)
    # the longest streak ever (rounds 1-3), not the current one (5-6)
    assert led.consecutive_pilot_streak(0) == \
        jled.consecutive_pilot_streak(0) == 3
    assert led.pilot_rounds(0) == jled.pilot_rounds(0) == [1, 2, 3, 5, 6]
    assert led.consecutive_pilot_streak(1) == 0


def test_dp_noise_tree():
    params = {"w": torch.ones((400, 250)), "b": torch.zeros(4)}
    gen = torch.Generator().manual_seed(0)
    clean = tpriv.dp_noise_tree(params, gen, sigma=0.0)
    assert torch.equal(clean["w"], params["w"])
    assert torch.equal(clean["b"], params["b"])
    sigma = 0.1
    noisy = tpriv.dp_noise_tree(params, gen, sigma=sigma)
    assert noisy.keys() == params.keys()
    assert noisy["w"].dtype == torch.float32
    std = float((noisy["w"] - 1.0).std())
    assert abs(std - sigma) < 0.05 * sigma
    again = tpriv.dp_noise_tree(params, torch.Generator().manual_seed(0),
                                sigma=sigma)
    assert not torch.equal(again["w"], noisy["w"])   # the draws advanced


# -- the example twin -------------------------------------------------------

def _main(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_communication_comparison_twin_prints_the_same(capsys):
    _main(ROOT / "examples" / "communication_comparison.py")()
    want = capsys.readouterr().out
    _main(ROOT / "examples" / "communication_comparison_torch.py")()
    got = capsys.readouterr().out
    assert got == want
    assert "42.19% (N=10)" in got
