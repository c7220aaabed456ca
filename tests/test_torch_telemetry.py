"""The port's telemetry layer against ``repro.telemetry`` and the trace
assembly of ``repro.fed.simulator``.

The federation is the JAX package's telemetry smoke's: N = 4 workers,
the MLP 16→32→5 (JAX initial weights carried across), 64 samples a
worker and a batch menu of (32,), so every shard is uniform. Six
scenarios: the plain wire, the masked wire with DP, the plain tree, the
masked tree under faults, participation 0.5, and the evasion defence.

Held exactly: ``round_step``'s record and carry against the JAX
package's, field by field (counts exactly, the float sums bit for bit on
the CPU), over 3-round chains; the simulators' trace events (meta,
counts, pilots, bytes, worker and edge events exactly; a round's cost
within ``build_trace``'s 1e-4 relative, as local training drifts in
float32 between XLA and ATen); the two drivers' traces against each
other; a port trace through the JAX package's ``validate_trace`` and
``summarize``; each package's report CLI on the other's trace file. A
tampered trace or a diverging host ledger raises ``TelemetryMismatch``;
malformed events are refused; a state without a telemetry carry builds
no record and books the host's bytes; a run resumed from a checkpoint
continues the record stream and the carry. The Pallas kernels of the
JAX side run in interpret mode with ``block_workers=1``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fedpc import FedPCConfig as JCfg
from repro.core.tree import TreeSpec as JTree
from repro.data.pipeline import federated_loaders as j_loaders
from repro.data.synthetic import SyntheticClassification as JData
from repro.fed import rounds as jrd
from repro.fed.faults import FaultPlan as JPlan
from repro.fed.simulator import FedSimulator as JSim
from repro.fed.worker import Worker as JWorker
from repro.fed.worker import make_worker_configs as j_cfgs
from repro.models.mlp import init_mlp_classifier as j_init
from repro.models.mlp import mlp_loss_and_grad as j_lag
from repro.privacy.spec import PrivacySpec as JSpec
from repro.telemetry import profile as jprof
from repro.telemetry import report as jreport
from repro.telemetry import smoke as jsmoke
from repro.telemetry import trace as jtrace
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedpc import FedPCConfig as TCfg
from repro_torch.core.tree import TreeSpec as TTree
from repro_torch.data.pipeline import federated_loaders as t_loaders
from repro_torch.data.synthetic import SyntheticClassification as TData
from repro_torch.fed import faults as tft
from repro_torch.fed import rounds as trd
from repro_torch.fed.simulator import FedSimulator as TSim
from repro_torch.fed.worker import Worker as TWorker
from repro_torch.fed.worker import make_worker_configs as t_cfgs
from repro_torch.models.mlp import mlp_loss_and_grad as t_lag
from repro_torch.privacy.spec import PrivacySpec as TSpec
from repro_torch.telemetry import profile as tprof
from repro_torch.telemetry import record as tmr
from repro_torch.telemetry import report as treport
from repro_torch.telemetry import smoke as tsmoke
from repro_torch.telemetry import trace as tmt

ROOT = Path(__file__).resolve().parents[1]
N = 4
PER = 64
ROUNDS = 3
ROWS = 32                    # (rows, 128) buffers of the round-level chains

_JPARAMS = j_init(jax.random.PRNGKey(0), 16, 5, hidden=(32,))
_PARAMS_NP = jax.tree_util.tree_map(np.asarray, _JPARAMS)
_PLAN = dict(seed=5, drop_before_uplink=0.1, drop_after_uplink=0.15,
             straggler=0.05)


def _cfgs(name: str):
    """(JAX config, port config, run kwargs, simulator kwargs) of a
    scenario."""
    kw, sim_kw = {}, {}
    both = []
    for cfg_cls, spec, tree, plan in ((JCfg, JSpec, JTree, JPlan),
                                      (TCfg, TSpec, TTree, tft.FaultPlan)):
        if name == "masked_dp":
            cfg = cfg_cls(n_workers=N, privacy=spec(dp_epsilon=2.0,
                                                    enforce=False))
        elif name == "plain_tree":
            cfg = cfg_cls(n_workers=N, tree=tree(fanout=2))
        elif name == "masked_tree_faults":
            cfg = cfg_cls(n_workers=N,
                          privacy=spec(mask_seed=5, modulus_bits=16,
                                       recovery_threshold=2, enforce=False),
                          tree=tree(fanout=2), faults=plan(**_PLAN))
        else:
            cfg = cfg_cls(n_workers=N)
        both.append(cfg)
    if name == "participation":
        kw = dict(participation=0.5, participation_seed=1)
    if name == "evasion":
        sim_kw = dict(evade_streak=2)
    return both[0], both[1], kw, sim_kw


SCENARIOS = ["plain", "masked_dp", "plain_tree", "masked_tree_faults",
             "participation", "evasion"]


def _federation(jax_side: bool):
    data, loaders, cfgs, worker, lag = (
        (JData, j_loaders, j_cfgs, JWorker, j_lag) if jax_side
        else (TData, t_loaders, t_cfgs, TWorker, t_lag))
    x, y = data(n_samples=N * PER, n_features=16, n_classes=5,
                seed=0).generate()
    splits = [np.arange(k * PER, (k + 1) * PER) for k in range(N)]
    lds = loaders((x, y), splits, seed=0, batch_menu=(32,))
    wcfg = cfgs(N, [PER] * N, seed=0, batch_menu=(32,))
    return [worker(cfg=wcfg[k], loader=lds[k], loss_and_grad=lag)
            for k in range(N)]


def _tsim(cfg, **sim_kw) -> TSim:
    return TSim(_federation(False),
                params_from_numpy(_PARAMS_NP, device="cpu"), cfg,
                device="cpu", **sim_kw)


def _jsim(cfg, **sim_kw) -> JSim:
    return JSim(_federation(True), _JPARAMS, cfg, **sim_kw)


def _same_events(got: list, want: list) -> None:
    """Port events against JAX events: meta, counts, pilots, bytes,
    worker and edge events exactly; a round's cost within 1e-4."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "cost":
                assert g[k] == pytest.approx(w[k], rel=1e-4)
            else:
                assert g[k] == w[k] and type(g[k]) is type(w[k]), (k, g, w)


def test_fault_constants_pinned_to_faults_module():
    assert tmr.FAULT_NONE == tft.FAULT_NONE
    assert tmr.DROP_BEFORE == tft.DROP_BEFORE


# -- round_step's record and carry -------------------------------------------

def _wires(name: str):
    jcfg, tcfg, _, _ = _cfgs(name)
    jw = jrd.WirePath(jrd.WireConfig(), interpret=True, block_workers=1,
                      privacy=jcfg.privacy, tree=jcfg.tree,
                      faults=jcfg.faults)
    tw = trd.WirePath(trd.WireConfig(), block_workers=1,
                      privacy=tcfg.privacy, tree=tcfg.tree,
                      faults=tcfg.faults)
    return jw, tw


def _u32(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("name", SCENARIOS)
def test_round_step_record_matches_reference(name):
    # Under the evasion defence the round gets the reported costs: an
    # evading worker repeats its previous cost.
    jw, tw = _wires(name)
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal((ROWS, 128), dtype=np.float32) * 0.05
    js = jrd.init_round_state({"w": jnp.asarray(p0)}, N, privacy=jw.privacy)
    ts = trd.init_round_state({"w": torch.from_numpy(p0)}, N,
                              privacy=tw.privacy, device="cpu")
    sizes = rng.integers(50, 90, N).astype(np.float32)
    masks = [None, np.array([1, 0, 1, 1], np.float32),
             np.array([0, 1, 1, 0], np.float32)]
    for i in range(ROUNDS):
        mask = masks[i] if name == "participation" else None
        bufs = (np.asarray(js.buf_p1)[None]
                + rng.standard_normal((N, ROWS, 128), dtype=np.float32) * .02)
        costs = (rng.random(N, dtype=np.float32) + 0.5) * np.float32(
            1.0 + 1e-3 * i)
        if name == "evasion" and i:
            costs[1] = np.asarray(js.prev_costs)[1]
        kw = {} if mask is None else {"mask": jnp.asarray(mask)}
        js, _, jinfo = jw.round_step(js, jnp.asarray(bufs),
                                     jnp.asarray(costs), jnp.asarray(sizes),
                                     **kw)
        ts, _, tinfo = tw.round_step(
            ts, torch.from_numpy(bufs), torch.from_numpy(costs),
            torch.from_numpy(sizes),
            mask=None if mask is None else torch.from_numpy(mask))
        jrec, trec = jinfo["telemetry"], tinfo["telemetry"]
        for field in tmr.RoundTelemetry._fields:
            got, want = getattr(trec, field), np.asarray(getattr(jrec, field))
            assert got.dtype == {"cost_sum": torch.float32,
                                 "weight_sum": torch.float32}.get(
                                     field, torch.int32), field
            np.testing.assert_array_equal(_u32(got.numpy()), _u32(want),
                                          err_msg=field)
        for got, want in zip(ts.telemetry, js.telemetry):
            np.testing.assert_array_equal(_u32(got.numpy()),
                                          _u32(np.asarray(want)))
    assert int(ts.telemetry.rounds) == ROUNDS
    if name == "masked_tree_faults":
        assert int(ts.telemetry.dead) > 0


def test_record_folds_costs_in_worker_order():
    # At N = 10 the in-order fold differs from Tensor.sum on these costs;
    # the record follows the order XLA:CPU sums a short vector in.
    rng = np.random.default_rng(3)
    n = 10
    found = False
    for _ in range(50):
        costs = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
                 ).astype(np.float32)
        sizes = np.ones(n, np.float32)
        rec = tmr.build_round_record(
            t=torch.tensor(1, dtype=torch.int32), k_star=torch.tensor(0),
            n=n, costs=torch.from_numpy(costs), sizes=torch.from_numpy(sizes))
        want = np.asarray(jax.jit(jnp.sum)(jnp.asarray(costs * sizes)))
        assert _u32(rec.cost_sum.numpy()) == _u32(want)
        found |= bool(torch.from_numpy(costs).sum() != rec.cost_sum)
    assert found


def test_telemetry_off_builds_no_record():
    jw, tw = _wires("masked_dp")
    st = trd.init_round_state({"w": torch.zeros(ROWS * 128)}, N,
                              privacy=tw.privacy, telemetry=False,
                              device="cpu")
    assert st.telemetry is None
    deltas = torch.linspace(-0.05, 0.05, N * ROWS * 128).view(N, ROWS, 128)

    def worker_fn(wc, buf, t):
        return wc, buf[None] + deltas * t.float(), torch.arange(
            1.0, N + 1.0) / t.float()

    st2, _, infos = trd.scan_rounds(tw, st, worker_fn, None, 3,
                                    torch.full((N,), 64.0))
    assert st2.telemetry is None and "telemetry" not in infos
    assert int(st2.round) == 4
    st3, _, infos = trd.scan_rounds(
        tw, trd.init_round_state({"w": torch.zeros(ROWS * 128)}, N,
                                 privacy=tw.privacy, device="cpu"),
        worker_fn, None, 3, torch.full((N,), 64.0))
    assert infos["telemetry"].n_sampled.tolist() == [N] * 3
    for a, b in zip(st2[:4], st3[:4]):
        assert torch.equal(a, b)


# -- the simulators' traces ----------------------------------------------------

@pytest.mark.parametrize("name", SCENARIOS)
def test_sim_trace_matches_reference(name):
    jcfg, tcfg, kw, sim_kw = _cfgs(name)
    jres = _jsim(jcfg, **sim_kw).run_fedpc(rounds=ROUNDS,
                                           wire_block_workers=1, **kw)
    tres = _tsim(tcfg, **sim_kw).run_fedpc(rounds=ROUNDS,
                                           wire_block_workers=1, **kw)
    assert tres.telemetry is not None
    _same_events(tres.telemetry.events(), jres.telemetry.events())
    assert tres.bytes_per_round == jres.bytes_per_round
    assert tres.recovery_bytes_per_round == jres.recovery_bytes_per_round
    assert tres.pilot_history == jres.pilot_history
    # The port's trace passes the JAX package's schema and byte check.
    events = tres.telemetry.events()
    assert jtrace.validate_trace(events) == len(events)
    summary = jtrace.summarize(events)
    assert summary.bytes_per_round == tres.bytes_per_round
    carry = tres.round_state.telemetry
    assert int(carry.rounds) == ROUNDS
    assert int(carry.sampled) == sum(r["n_sampled"]
                                     for r in tres.telemetry.rounds)
    assert int(carry.dead) == sum(r["n_dead"] for r in tres.telemetry.rounds)


@pytest.mark.parametrize("name", ["masked_tree_faults", "participation"])
def test_drivers_give_the_same_trace(name):
    _, tcfg, kw, _ = _cfgs(name)
    r1 = _tsim(tcfg).run_fedpc(rounds=ROUNDS, **kw)
    r2 = _tsim(tcfg).run_fedpc_scan(rounds=ROUNDS, **kw)
    assert r1.telemetry.meta["driver"] == "run_fedpc"
    assert r2.telemetry.meta["driver"] == "run_fedpc_scan"
    assert ({**r1.telemetry.meta, "driver": None}
            == {**r2.telemetry.meta, "driver": None})
    assert r1.telemetry.rounds == r2.telemetry.rounds
    assert r1.telemetry.workers == r2.telemetry.workers
    assert r1.telemetry.edges == r2.telemetry.edges
    for a, b in zip(r1.round_state.telemetry, r2.round_state.telemetry):
        assert torch.equal(a, b)


def test_host_ledger_divergence_raises(monkeypatch):
    _, tcfg, _, _ = _cfgs("masked_tree_faults")
    sim = _tsim(tcfg)
    inner = sim._round_bytes
    monkeypatch.setattr(sim, "_round_bytes",
                        lambda *a: (inner(*a)[0] + 1.0, inner(*a)[1]))
    with pytest.raises(tmt.TelemetryMismatch, match="wire bytes"):
        sim.run_fedpc(rounds=1)


def test_summarize_rejects_tampered_bytes():
    _, tcfg, _, _ = _cfgs("masked_tree_faults")
    events = [dict(e) for e in
              _tsim(tcfg).run_fedpc_scan(rounds=2).telemetry.events()]
    tmt.summarize(events)
    for e in events:
        if e["ev"] == "round":
            e["recovery_bytes"] += 1.0
            break
    with pytest.raises(tmt.TelemetryMismatch,
                       match="stored recovery bytes"):
        tmt.summarize(events)
    with pytest.raises(jtrace.TelemetryMismatch,
                       match="stored recovery bytes"):
        jtrace.summarize(events)


def test_schema_rejects_malformed_events():
    meta = {"ev": "meta", "schema": tmt.SCHEMA_VERSION, "source": "t"}
    ok_round = {"ev": "round", "t": 1, "pilot": 0, "n_sampled": 4,
                "n_used": 4, "n_dead": 0, "n_pre_uplink": 0,
                "n_recovered": 0, "n_degraded": 0, "cost": 1.0,
                "wire_bytes": 10.0, "recovery_bytes": 0.0}
    tmt.validate_trace([meta, ok_round])
    with pytest.raises(ValueError, match="unknown trace event kind"):
        tmt.validate_event({"ev": "nope"})
    with pytest.raises(ValueError, match="missing field"):
        tmt.validate_event({k: v for k, v in ok_round.items()
                            if k != "pilot"})
    with pytest.raises(ValueError, match="unknown fields"):
        tmt.validate_event({**ok_round, "extra": 1})
    with pytest.raises(ValueError, match="bool"):
        tmt.validate_event({**ok_round, "n_dead": True})
    with pytest.raises(ValueError, match="is not of"):
        tmt.validate_event({**ok_round, "n_dead": np.int64(0)})
    with pytest.raises(ValueError, match="must start with a meta"):
        tmt.validate_trace([ok_round])
    with pytest.raises(ValueError, match="schema"):
        tmt.validate_trace([{**meta, "schema": 99}])
    with pytest.raises(ValueError, match="empty trace"):
        tmt.validate_trace([])
    with pytest.raises(ValueError, match="sent"):
        tmt.validate_event({"ev": "worker", "t": 1, "worker": 0,
                            "sampled": True, "fault": 0, "pilot": False,
                            "sent": "gradients"})


def test_jsonl_round_trip_and_cross_package_reports(tmp_path, capsys):
    jcfg, tcfg, _, _ = _cfgs("masked_tree_faults")
    tres = _tsim(tcfg).run_fedpc_scan(rounds=2, wire_block_workers=1)
    jres = _jsim(jcfg).run_fedpc_scan(rounds=2, wire_block_workers=1)
    tpath, jpath = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    n = tres.telemetry.write(tpath)
    jres.telemetry.write(jpath)
    events = tmt.read_trace(tpath)
    assert len(events) == n
    summary = tmt.summarize(events)
    assert summary.meta == tres.telemetry.meta
    assert summary.bytes_per_round == tres.telemetry.bytes_per_round
    assert summary.pilots == tres.telemetry.pilots
    for main, path in ((treport.main, jpath), (jreport.main, tpath),
                       (treport.main, tpath)):
        assert main([path]) == 0
        out = capsys.readouterr().out
        assert out.strip().endswith("trace bytes == core/protocol models")
        assert "uplink events:" in out and "tree-edge bytes: L1=" in out


def test_telemetry_off_books_host_bytes_and_baselines_keep_lists():
    _, tcfg, _, _ = _cfgs("masked_tree_faults")
    on = _tsim(tcfg).run_fedpc(rounds=2)
    sim = _tsim(tcfg)
    from repro_torch.core import flat as fl
    state = trd.init_round_state(sim.init_params, N,
                                 fl.layout_of(sim.init_params),
                                 privacy=tcfg.privacy, telemetry=False,
                                 device="cpu")
    off = sim.run_fedpc(rounds=2, state=state)
    assert off.telemetry is None and off.round_state.telemetry is None
    assert off._bytes == on.bytes_per_round and off._bytes
    assert off.recovery_bytes_per_round == on.recovery_bytes_per_round
    assert off.pilot_history == on.pilot_history
    assert off.costs == on.costs
    fedavg = _tsim(TCfg(n_workers=N)).run_fedavg(rounds=2)
    assert fedavg.telemetry is None
    assert fedavg.bytes_per_round == fedavg._bytes
    assert len(set(fedavg.bytes_per_round)) == 1 and len(
        fedavg.bytes_per_round) == 2
    assert fedavg.total_bytes == pytest.approx(sum(fedavg.bytes_per_round))


@pytest.mark.parametrize("driver", ["run_fedpc", "run_fedpc_scan"])
def test_trace_continues_across_save_and_load(tmp_path, driver):
    _, tcfg, _, _ = _cfgs("masked_tree_faults")
    full = getattr(_tsim(tcfg), driver)(rounds=ROUNDS)
    sim = _tsim(tcfg)
    first = getattr(sim, driver)(rounds=ROUNDS - 1)
    trd.save_round_state(str(tmp_path), first.round_state)
    like = trd.init_round_state(sim.init_params, N, privacy=tcfg.privacy,
                                device="cpu")
    loaded, manifest = trd.load_round_state(str(tmp_path), like)
    assert manifest["step"] == ROUNDS
    rest = getattr(sim, driver)(rounds=1, state=loaded)
    assert rest.telemetry.meta["t0"] == ROUNDS
    assert (first.telemetry.rounds + rest.telemetry.rounds
            == full.telemetry.rounds)
    assert (first.telemetry.workers + rest.telemetry.workers
            == full.telemetry.workers)
    assert (first.telemetry.edges + rest.telemetry.edges
            == full.telemetry.edges)
    for a, b in zip(rest.round_state.telemetry, full.round_state.telemetry):
        assert torch.equal(a, b)


# -- profiler scopes -------------------------------------------------------------

def test_scope_names_follow_the_tune_keys():
    assert tprof.scope_name("uplink_stacked", 8, 4, "cuda") == \
        "wire/uplink_stacked/r8n4/cuda"
    assert tprof.scope_name("mask_repair16", 8, 0, "cpu") == \
        "wire/mask_repair16/r8n1/cpu-plain"
    assert tprof.scope_name("master", 8, 4) == "wire/master/r8n4/cuda"
    jname = jprof.scope_name("uplink_stacked", 8, 4, interpret=True)
    assert jname.rsplit("/", 1)[0] == \
        tprof.scope_name("uplink_stacked", 8, 4).rsplit("/", 1)[0]
    # No profiler recording: the scope is a no-op context.
    assert not torch._C._autograd._profiler_enabled()
    assert not isinstance(tprof.kernel_scope("master", 8, 4, "cpu"),
                          torch.profiler.record_function)


@pytest.mark.parametrize("name,want", [
    ("plain", {"uplink_stacked": 1, "master": 1}),
    ("masked_tree_faults", {"uplink_masked16": 1, "partial_sum_masked16": 1,
                            "mask_repair16": 1, "master_masked16": 1})])
def test_profile_session_holds_one_scope_a_launch(tmp_path, name, want):
    _, tw = _wires(name)
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((ROWS, 128), dtype=np.float32) * 0.05
    st = trd.init_round_state({"w": torch.from_numpy(p0)}, N,
                              privacy=tw.privacy, device="cpu")
    # Round 1 of the plan has a death, so the round repairs its masks.
    bufs = torch.from_numpy(p0)[None] + torch.from_numpy(
        rng.standard_normal((N, ROWS, 128), dtype=np.float32)) * 0.02
    with tprof.profile_session(str(tmp_path)) as prof:
        tw.round_step(st, bufs, torch.ones(N), torch.full((N,), 64.0))
    names = [e.name for e in prof.events() if e.name.startswith("wire/")]
    r = ROWS // 4
    n_of = {"uplink_stacked": N, "master": N, "uplink_masked16": N,
            "partial_sum_masked16": 2, "mask_repair16": 1,
            "master_masked16": 2}
    assert sorted(names) == sorted(
        f"wire/{k}/r{r}n{n_of[k]}/cpu-plain" for k in want
        for _ in range(want[k]))
    assert (tmp_path / "trace.json").exists()


def test_smoke_cli_exits_zero(tmp_path):
    out = tmp_path / "trace.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry.smoke", "--device",
         "cpu", "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "byte cross-check OK: 3 rounds" in proc.stdout
    assert jtrace.summarize(jtrace.read_trace(str(out))).rounds


def test_smoke_federation_records_the_reference_audit():
    # The smoke runs the masked tree under faults with the default
    # PrivacySpec(enforce=True): the scan driver audits the round program
    # once before round 1, as the JAX smoke's simulator does.
    tsim, jsim = tsmoke.make_sim(device="cpu"), jsmoke.make_sim()
    tsim.run_fedpc_scan(rounds=1)
    jsim.run_fedpc_scan(rounds=1)
    assert tsim.fed_cfg.privacy.enforce
    assert tsim.ledger.audits == jsim.ledger.audits == [
        {"runtime": "run_fedpc_scan", "boundary": "round-step",
         "n_launches": 4, "masked": True}]
