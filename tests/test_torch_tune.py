"""The port's launch-plan tuner (``repro_torch.kernels.tune``) against the
JAX package's (``repro.kernels.tune``), on the CPU.

Held equal: the snapping rules ``fit_block_rows``/``fit_block_workers``,
``KINDS``, ``MASKED_FALLBACK``, the interpreter's and the TPU's default
plans, the ``ops`` plan resolution on the CPU backend, ``set_plan`` /
``lookup`` down the fallback chain with its one line a key, tables saved
by either package loaded by the other, the sweeps' ``plan`` events
through ``telemetry.trace``, and the TPU master's VMEM model. The
``"cuda"`` rules are pure Python and checked here too: the default plan
is the kernels' one geometry from before plans, every sweep candidate is
a plan its kernel honours, and on the card the fallback chain never
lends one kernel's plan to another. The knobs: the round chain, ``run_fedpc`` and
``run_fedpc_scan`` with a pinned plan equal the JAX package's given the
same knobs. The JAX side runs its cheapest plans only (interpret mode,
one rep, at most 64 rows).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as jfl
from repro.core.fedpc import FedPCConfig as JCfg
from repro.data.pipeline import federated_loaders as j_loaders
from repro.data.synthetic import SyntheticClassification as JData
from repro.fed import rounds as jrd
from repro.fed.simulator import FedSimulator as JSim
from repro.fed.worker import Worker as JWorker
from repro.fed.worker import make_worker_configs as j_cfgs
from repro.kernels import ops as jops
from repro.kernels import tune as jtune
from repro.models.mlp import init_mlp_classifier as j_init
from repro.models.mlp import mlp_loss_and_grad as j_lag
from repro.telemetry import trace as jtrace
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedpc import FedPCConfig as TCfg
from repro_torch.data.pipeline import federated_loaders as t_loaders
from repro_torch.data.synthetic import SyntheticClassification as TData
from repro_torch.fed import rounds as trd
from repro_torch.fed.simulator import FedSimulator as TSim
from repro_torch.fed.worker import Worker as TWorker
from repro_torch.fed.worker import make_worker_configs as t_cfgs
from repro_torch.kernels import masked_wire as tmw
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tune
from repro_torch.models.mlp import mlp_loss_and_grad as t_lag
from repro_torch.telemetry import report as treport
from repro_torch.telemetry import trace as ttrace
from repro_torch.utils import tree_leaves

CPU = torch.device("cpu")


@pytest.fixture
def tables(monkeypatch):
    """Fresh tables and fallback logs in both packages for one test."""
    for mod in (tune, jtune):
        monkeypatch.setattr(mod, "_TABLE", {})
        monkeypatch.setattr(mod, "_FALLBACK_LOGGED", set())
    yield


# -- the rules and constants -------------------------------------------------

@pytest.mark.parametrize("rows", [1, 8, 24, 48, 64, 100, 8400, 41016])
@pytest.mark.parametrize("want", [1, 2, 3, 8, 64, 256, 1 << 30])
def test_fit_rules_match(rows, want):
    assert tune.fit_block_rows(rows, want) == jtune.fit_block_rows(rows, want)
    assert (tune.fit_block_workers(rows, want)
            == jtune.fit_block_workers(rows, want))


def test_kinds_and_fallback_chain_match():
    assert tune.KINDS == jtune.KINDS
    assert tune.MASKED_FALLBACK == jtune.MASKED_FALLBACK
    assert (tune.BLOCK_ROWS, tune.BLOCK_WORKERS) == (jtune.BLOCK_ROWS,
                                                     jtune.BLOCK_WORKERS)
    assert tune.backend_tag() == "cuda"
    assert tune.backend_tag("cpu") == "cpu-plain"
    assert tune.backend_tag(torch.device("meta")) == "cpu-plain"


@pytest.mark.parametrize("kind", jtune.KINDS)
@pytest.mark.parametrize("rows,n", [(32, 4), (48, 6), (8400, 33)])
def test_default_plans_match_the_reference_backends(kind, rows, n):
    for backend in ("cpu-interpret", "tpu"):
        assert (tune.default_plan(kind, rows, n, backend)
                == jtune.default_plan(kind, rows, n, backend))
    # the plain twin's heuristic is the interpreter's: one step
    assert (tune.default_plan(kind, rows, n, "cpu-plain")
            == jtune.default_plan(kind, rows, n, "cpu-interpret"))


@pytest.mark.parametrize("kind,rows,n,br,bw", [
    ("uplink_stacked", 48, 6, None, None), ("uplink_stacked", 48, 6, 16, 4),
    ("uplink_stacked", 8400, 33, 64, 8), ("master", 48, 6, 24, 2),
    ("master", 100, 10, None, 3), ("uplink_masked16", 48, 6, 12, 5),
    ("master_masked", 64, 17, 8, 8), ("uplink_masked", 64, 17, None, None)])
def test_ops_plan_resolution_matches_on_the_cpu(tables, kind, rows, n, br,
                                                bw):
    want = jops._stacked_plan(kind, rows, n, br, bw, interpret=True)
    assert tops._stacked_plan(kind, rows, n, br, bw, CPU) == want
    # a pinned table entry resolves the same way in both
    jtune.set_plan(kind, rows, n, {"block_rows": 8, "block_workers": 3},
                   backend="cpu-interpret")
    tune.set_plan(kind, rows, n, {"block_rows": 8, "block_workers": 3},
                  backend="cpu-plain")
    want = jops._stacked_plan(kind, rows, n, br, bw, interpret=True)
    assert tops._stacked_plan(kind, rows, n, br, bw, CPU) == want


def test_cuda_defaults_are_the_one_geometry_of_before():
    """2 rows (256 threads, one position a thread) a CTA; the uplinks a
    CTA over all N workers, the masters one worker's bytes a fold step,
    the partial sums one group a CTA, the repair 4 chunks a thread."""
    for kind in ("uplink_stacked", "uplink_masked", "uplink_masked16"):
        assert tune.lookup(kind, 41016, 10) == (2, 10)
    for kind in ("uplink", "master", "master_masked", "master_masked16",
                 "partial_sum", "partial_sum_masked16"):
        assert tune.lookup(kind, 41016, 10)[0] == 2
        assert tune.lookup(kind, 41016, 10)[1] == 1
    assert tune.lookup("mask_repair16", 41016) == (16, 1)
    assert tune.lookup("mask_repair", 41016) == (8, 1)
    assert tune.repair_rows("mask_repair16") == (4, 8, 16)
    assert tune.repair_rows("mask_repair") == (2, 4, 8)


@pytest.mark.parametrize("kind", tune.KINDS)
@pytest.mark.parametrize("rows,n", [(1, 1), (37, 3), (41016, 10),
                                    (41016, 17)])
def test_cuda_candidates_are_honoured_plans(kind, rows, n):
    pairs = kind.startswith("uplink_masked") and tmw.uses_pair_kernel(n, n)
    ext = -(-10 // n) if kind.startswith("partial_sum") else n
    cands = tune._candidate_plans(kind, rows, n, "cuda", extent=ext,
                                  pairs=pairs)
    assert 1 <= len(cands) <= 6
    assert len({(c["block_rows"], c["block_workers"]) for c in cands}) == \
        len(cands)
    default = tune.default_plan(kind, rows, n if not kind.startswith(
        "partial_sum") else ext, "cuda")
    first = cands[0]
    assert (first["block_rows"], first["block_workers"]) == tune.fit_cuda_plan(
        kind, rows, ext, default["block_rows"], default["block_workers"],
        pairs=pairs)
    for c in cands:       # every candidate is one its kernel launches as is
        tune.check_cuda_plan(kind, rows, ext, c["block_rows"],
                             c["block_workers"], pairs=pairs)


def test_cuda_snapping_rules():
    fit = tune.fit_cuda_plan
    assert fit("uplink_stacked", 37, 10, 100, 4) == (37, 4)
    assert fit("uplink_stacked", 37, 10, 3, 99) == (3, 10)
    assert fit("uplink_masked16", 37, 10, 5, 3, pairs=True) == (2, 10)
    assert fit("uplink_masked", 37, 10, 8, 10, pairs=True) == (2, 10)
    assert fit("uplink_stacked", 1, 3, 2, 3) == (2, 3)   # a ragged CTA
    assert fit("uplink_stacked", 1, 3, 8, 3) == (2, 3)
    assert fit("uplink_masked16", 37, 17, 5, 3) == (5, 3)
    assert fit("master", 37, 10, 2, 7) == (2, 4)
    assert fit("master_masked", 37, 3, 2, 8) == (2, 2)
    assert fit("master_masked16", 37, 1, 2, 8) == (2, 1)
    assert fit("partial_sum", 37, 5, 2, 9) == (2, 1)
    assert fit("partial_sum", 37, 5, 8, 1) == (2, 1)
    assert fit("partial_sum_masked", 37, 5, 8, 9) == (8, 5)
    assert fit("uplink", 37, 1, 8, 4) == (8, 1)
    assert fit("mask_repair16", 37, 1, 12, 3) == (8, 1)
    assert fit("mask_repair16", 37, 1, 1, 1) == (4, 1)
    assert fit("mask_repair", 37, 1, 64, 1) == (8, 1)
    with pytest.raises(ValueError, match="nearest plan it honours"):
        tune.cuda_plan("master", 37, 10, 2, 3)
    with pytest.raises(ValueError, match="nearest plan it honours"):
        tune.cuda_plan("uplink_masked", 37, 10, 2, 5, pairs=True)
    with pytest.raises(ValueError, match="nearest plan it honours"):
        tune.cuda_plan("mask_repair16", 37, 1, 5, None)
    assert tune.cuda_plan("uplink_masked", 37, 17, None, None) == (2, 17)
    with pytest.raises(ValueError, match="nearest plan it honours"):
        tune.cuda_plan("uplink_masked", 37, 10, 8, None, pairs=True)
    with pytest.raises(ValueError, match="nearest plan it honours"):
        tune.cuda_plan("partial_sum", 37, 5, None, 5)
    assert tune.cuda_plan("partial_sum_masked", 37, 5, None, 5) == (2, 5)
    assert tune.cuda_plan("uplink_stacked", 1, 3, None, None) == (2, 3)


@pytest.mark.parametrize("kind,pairs", [
    ("uplink_masked16", True), ("uplink_masked16", False),
    ("uplink_masked", True), ("uplink_masked", False)])
def test_cuda_masked_uplink_borrows_no_plain_uplink_plan(tables, kind, pairs):
    # On the card a step of the fallback chain that leaves the kernel ends
    # the walk at the heuristic: the plain uplink's tuned plan says
    # nothing of the masked uplink's kernels. The row fold takes a square
    # cohort past the tile kernel's cap.
    n = 10 if pairs else tmw.COHORT_MAX_WORKERS + 1
    assert tmw.uses_pair_kernel(n, n) == pairs
    want = tops._stacked_plan(kind, 41016, n, None, None, "cuda",
                              pairs=pairs)
    assert want == (2, n)
    tune.set_plan("uplink_stacked", 41016, n,
                  {"block_rows": 8, "block_workers": 2}, backend="cuda")
    assert tune.lookup(kind, 41016, n, backend="cuda") == (2, n)
    assert tops._stacked_plan(kind, 41016, n, None, None, "cuda",
                              pairs=pairs) == want
    # a 16-bit kind still borrows its 32-bit twin's plan (one kernel)
    tune.set_plan("uplink_masked", 41016, n,
                  {"block_rows": 8, "block_workers": 2}, backend="cuda")
    got = tops._stacked_plan("uplink_masked16", 41016, n, None, None,
                             "cuda", pairs=pairs)
    assert got == ((2, n) if pairs else (8, 2))


@pytest.mark.parametrize("kind,borrowed,default", [
    ("mask_repair16", "uplink", (16, 1)), ("mask_repair", "uplink", (8, 1)),
    ("mask_repair16", "mask_repair", (16, 1)),
    ("master_masked", "master", (2, 1)),
    ("partial_sum_masked", "partial_sum", (2, 1))])
def test_cuda_chain_ends_where_the_kernel_changes(tables, kind, borrowed,
                                                   default):
    tune.set_plan(borrowed, 4096, 1 if "repair" in kind else 10,
                  {"block_rows": 4, "block_workers": 2}, backend="cuda")
    n = 1 if "repair" in kind else 10
    assert tune.lookup(kind, 4096, n, backend="cuda") == default
    # the plain twin's backend walks the JAX package's whole chain
    tune.set_plan(borrowed, 4096, n, {"block_rows": 4, "block_workers": 2},
                  backend="cpu-plain")
    assert tune.lookup(kind, 4096, n, backend="cpu-plain") == (4, 2)


# -- the table and its fallback chain ---------------------------------------

def test_lookup_falls_back_down_the_chain_as_the_reference(tables):
    r4, n = 48, 6
    for mod, backend in ((tune, "cpu-plain"), (jtune, "cpu-interpret")):
        mod.set_plan("uplink_stacked", r4, n,
                     {"block_rows": 24, "block_workers": 2}, backend=backend)
        mod.set_plan("master", r4, n, {"block_rows": 16, "block_workers": 3},
                     backend=backend)

    def both(kind):
        got = tune.lookup(kind, r4, n, backend="cpu-plain")
        assert got == jtune.lookup(kind, r4, n, interpret=True)
        return got

    for kind in ("uplink_masked", "uplink_masked16"):
        assert both(kind) == (24, 2)
    for kind in ("master_masked", "master_masked16"):
        assert both(kind) == (16, 3)
    for mod, backend in ((tune, "cpu-plain"), (jtune, "cpu-interpret")):
        mod.set_plan("uplink_masked", r4, n,
                     {"block_rows": 48, "block_workers": 1}, backend=backend)
    assert both("uplink_masked16") == (48, 1)
    for mod, backend in ((tune, "cpu-plain"), (jtune, "cpu-interpret")):
        mod.set_plan("uplink_masked16", r4, n,
                     {"block_rows": 12, "block_workers": 6}, backend=backend)
    assert both("uplink_masked16") == (12, 6)
    # the device's backend keys apart from the plain twin's
    assert tune.lookup("uplink_masked16", r4, n, backend="cpu-plain") == (12, 6)
    assert tune.lookup("uplink_masked16", r4, n) == (2, n)


def test_every_kind_resolves_on_an_empty_table(tables):
    r4, n = 32, 4
    for kind in tune.KINDS:
        br, bw = tune.lookup(kind, r4, n, backend="cpu-plain")
        assert (br, bw) == jtune.lookup(kind, r4, n, interpret=True)
        if kind.startswith("partial_sum"):
            bw = tune.fit_block_workers(n, bw)
        assert r4 % br == 0 and n % bw == 0, (kind, br, bw)


def _fallback_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("[tune] no plan")]


def test_fallback_line_printed_once_a_key_as_the_reference(tables, capsys):
    calls = [("mask_repair16", 4096, 1), ("uplink_masked16", 4096, 1),
             ("mask_repair16", 4096, 1), ("mask_repair16", 8192, 1),
             ("partial_sum_masked16", 4096, 2),
             ("partial_sum_masked16", 4096, 2), ("uplink_stacked", 64, 4)]
    for kind, rows, n in calls:
        jtune.lookup(kind, rows, n, interpret=True)
    want = _fallback_lines(capsys.readouterr().out)
    for kind, rows, n in calls:
        tune.lookup(kind, rows, n, backend="cpu-interpret")
    got = _fallback_lines(capsys.readouterr().out)
    assert got == want and len(got) == 4
    assert ("partial_sum_masked16 -> partial_sum_masked -> partial_sum"
            in got[3])
    # the port's own backend: the same walk, reported once a key
    for kind, rows, n in calls:
        tune.lookup(kind, rows, n, backend="cpu-plain")
    mine = _fallback_lines(capsys.readouterr().out)
    assert mine == [ln.replace("cpu-interpret", "cpu-plain") for ln in want]
    tune.lookup("mask_repair16", 4096, 1, backend="cpu-plain")
    assert not _fallback_lines(capsys.readouterr().out)


def test_tables_saved_by_either_package_load_in_the_other(tables, tmp_path):
    jtune.set_plan("uplink_stacked", 48, 6,
                   {"block_rows": 24, "block_workers": 2},
                   backend="cpu-interpret")
    jtune.set_plan("mask_repair16", 64, 1,
                   {"block_rows": 64, "block_workers": 1}, backend="tpu")
    tune.set_plan("uplink_stacked", 48, 6,
                  {"block_rows": 8, "block_workers": 3})
    tune.set_plan("master_masked16", 41016, 10,
                  {"block_rows": 2, "block_workers": 4}, backend="cuda")
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    jtune.save_table(jpath)
    tune.save_table(tpath)
    assert tune.load_table(jpath) == 2
    assert jtune.load_table(tpath) == 2
    for kind, rows, n, backend in [("uplink_stacked", 48, 6, "cpu-interpret"),
                                   ("mask_repair16", 64, 1, "tpu"),
                                   ("uplink_stacked", 48, 6, "cuda"),
                                   ("master_masked16", 41016, 10, "cuda")]:
        assert tune._TABLE[(kind, rows, n, backend)] == \
            jtune._TABLE[(kind, rows, n, backend)]
    assert tune.lookup("uplink_stacked", 48, 6,
                       backend="cpu-interpret") == (24, 2)
    assert tune.lookup("uplink_stacked", 48, 6) == (8, 3)
    # one file holds both: the backend keys differ
    merged = str(tmp_path / "both.json")
    tune.save_table(merged)
    with open(merged) as f:
        keys = set(json.load(f))
    assert {"uplink_stacked|48|6|cpu-interpret",
            "uplink_stacked|48|6|cuda"} <= keys
    tune.clear_table()
    assert tune.load_table(merged, replace=True) == 4
    assert tune.lookup("master_masked16", 41016, 10) == (2, 4)


def test_env_table_loads_at_import(tmp_path):
    path = tmp_path / "table.json"
    path.write_text(json.dumps({"master|41016|10|cuda":
                                {"block_rows": 8, "block_workers": 4}}))
    env = {**os.environ, "REPRO_TUNE_TABLE": str(path),
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(os.path.dirname(__file__), "..", "src"),
                os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.kernels import tune; "
         "print(tune.lookup('master', 41016, 10))"],
        env=env, capture_output=True, text=True, check=True).stdout
    assert out.strip() == "(8, 4)"


# -- the sweeps -------------------------------------------------------------

@pytest.mark.parametrize("sweep,args", [
    ("autotune_stacked", (32, 4)), ("autotune_master", (32, 4)),
    ("autotune_mask_repair", (32, 4)),
    ("autotune_partial_sum", (32, 2, 4))])
def test_cpu_sweeps_try_the_reference_candidates(tables, sweep, args):
    theirs = getattr(jtune, sweep)(*args, interpret=True, reps=1)
    mine = getattr(tune, sweep)(*args, device="cpu", reps=1, verify=True)
    assert [(t["block_rows"], t["block_workers"]) for t in mine["timings"]] \
        == [(t["block_rows"], t["block_workers"]) for t in theirs["timings"]]
    for key in set(theirs) - {"backend", "best", "timings"}:
        assert mine[key] == theirs[key], key
    assert mine["backend"] == "cpu-plain" and mine["verified"]
    assert (mine["kind"], mine["rows"], mine["n_workers"], "cpu-plain") in \
        tune._TABLE


@pytest.mark.parametrize("bits", [16, 32])
def test_masked_sweeps_store_winners(tables, bits):
    suffix = "16" if bits == 16 else ""
    rec = tune.autotune_masked_uplink(16, 4, device="cpu", reps=1,
                                      word_bits=bits, verify=True)
    assert rec["kind"] == f"uplink_masked{suffix}"
    assert rec["timings"] and all(r["us"] > 0 for r in rec["timings"])
    rec_m = tune.autotune_masked_master(16, 4, device="cpu", reps=1,
                                        word_bits=bits, verify=True)
    assert rec_m["best"]["block_rows"] <= 16
    rec_p = tune.autotune_partial_sum(16, 2, 5, device="cpu", reps=1,
                                      word_bits=bits, masked=True,
                                      verify=True)
    assert rec_p["n_children"] == 5
    for kind, n in ((f"uplink_masked{suffix}", 4),
                    (f"master_masked{suffix}", 4),
                    (f"partial_sum_masked{suffix}", 2)):
        assert (kind, 16, n, "cpu-plain") in tune._TABLE


def test_sweep_verify_catches_a_plan_that_changes_bits(tables, monkeypatch):
    from repro_torch.kernels import fused_wire as tfw
    real = tfw.ternary_pack_stacked

    def broken(*a, block_rows=None, block_workers=None, **kw):
        out = real(*a, **kw)
        if block_workers == 1:
            out = out.clone()
            out[0, 0, 0] ^= 1
        return out

    monkeypatch.setattr(tfw, "ternary_pack_stacked", broken)
    with pytest.raises(RuntimeError, match="does not give the"):
        tune.autotune_stacked(32, 4, device="cpu", reps=1, verify=True)


def test_sweeps_emit_plan_events(tables):
    events = []

    def sink(event):
        ttrace.validate_event(event)
        jtrace.validate_event(event)
        events.append(event)

    tune.set_trace_writer(ttrace.plan_emitter(sink))
    try:
        out1 = tune.autotune_stacked(32, 4, device="cpu", reps=1)
        out2 = tune.autotune_mask_repair(32, 4, device="cpu", reps=1)
        out3 = tune.autotune_partial_sum(32, 2, 4, device="cpu", reps=1)
    finally:
        tune.set_trace_writer(None)
    assert len(events) == sum(len(o["timings"]) for o in (out1, out2, out3))
    for out in (out1, out2, out3):
        kind_evs = [e for e in events if e["kind"] == out["kind"]]
        bests = [e for e in kind_evs if e["best"]]
        assert len(bests) == 1
        assert bests[0]["block_rows"] == out["best"]["block_rows"]
        assert {(e["block_rows"], e["block_workers"]) for e in kind_evs} \
            == {(t["block_rows"], t["block_workers"])
                for t in out["timings"]}
    n = len(events)
    tune.autotune_stacked(32, 4, device="cpu", reps=1)
    assert len(events) == n


def test_plan_trace_writer_roundtrip_and_report(tables, tmp_path):
    path = str(tmp_path / "plans.jsonl")
    with ttrace.TraceWriter(path, source="test_tune") as w:
        tune.set_trace_writer(ttrace.plan_emitter(w.emit))
        try:
            tune.autotune_mask_repair(32, 4, device="cpu", reps=1)
        finally:
            tune.set_trace_writer(None)
    events = ttrace.read_trace(path)
    assert events[0]["source"] == "test_tune"
    summary = ttrace.summarize(events)
    assert summary.plans and not summary.rounds
    assert sum(e["best"] for e in summary.plans) == 1
    jsummary = jtrace.summarize(jtrace.read_trace(path))
    assert jsummary.plans == summary.plans
    text = treport.render(summary)
    assert "tuner sweeps:" in text and "mask_repair" in text


def test_master_vmem_models_match():
    for br in (8, 64, 256):
        for bw in (1, 2, 8):
            assert (tune.master_vmem_tile_bytes(br, bw)
                    == jtune.master_vmem_tile_bytes(br, bw))
        for n in (8, 32, 64, 256):
            assert (tune.master_vmem_tile_bytes_preaccum(br, n)
                    == jtune.master_vmem_tile_bytes_preaccum(br, n))
            assert (tune.master_vmem_tile_bytes_preaccum(br, n)
                    - tune.master_vmem_tile_bytes(br, 1)
                    == (n - 1) * br * 128)


# -- the knobs ---------------------------------------------------------------

def _params(rng):
    dims = [24, 64, 64, 6]
    return {f"layer{i}": {"w": rng.standard_normal((dims[i], dims[i + 1]),
                                                   dtype=np.float32) * 0.2,
                          "b": np.zeros(dims[i + 1], np.float32)}
            for i in range(3)}


@pytest.mark.parametrize("block_rows,block_workers", [(4, 1), (8, 3),
                                                      (None, 2)])
def test_round_chain_with_a_pinned_plan_matches(block_rows, block_workers):
    n = 3
    rng = np.random.default_rng(1)
    params = _params(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    layout = jfl.layout_of(jparams)
    jwire = jrd.WirePath(jrd.WireConfig(), interpret=True,
                         block_rows=block_rows, block_workers=block_workers)
    twire = trd.WirePath(trd.WireConfig(), block_rows=block_rows,
                         block_workers=block_workers)
    js = jrd.init_round_state(jparams, n, layout, telemetry=False)
    ts = trd.init_round_state(params_from_numpy(params, device="cpu"), n,
                              device="cpu")
    sizes = np.array([500.0, 300.0, 700.0], np.float32)
    for _ in range(3):
        p1 = np.asarray(js.buf_p1)
        bufs = (p1[None] + rng.standard_normal((n,) + p1.shape,
                                               dtype=np.float32) * 0.05)
        bufs.reshape(n, -1)[:, layout.n:] = 0.0
        costs = rng.random(n, dtype=np.float32) + 0.5
        packed = twire.uplink_stacked(torch.from_numpy(bufs), ts.buf_p1,
                                      ts.buf_p2, t=ts.round)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(
            jwire.uplink_stacked(jnp.asarray(bufs), js.buf_p1, js.buf_p2,
                                 t=js.round)))
        js, jnew, jinfo = jwire.round_step(js, jnp.asarray(bufs),
                                           jnp.asarray(costs),
                                           jnp.asarray(sizes))
        ts, tnew, tinfo = twire.round_step(ts, torch.from_numpy(bufs),
                                           torch.from_numpy(costs),
                                           torch.from_numpy(sizes))
        assert int(tinfo["k_star"]) == int(jinfo["k_star"])
        np.testing.assert_array_equal(tnew.numpy().view(np.uint32),
                                      np.asarray(jnew).view(np.uint32))
        for name in ("buf_p1", "buf_p2"):
            np.testing.assert_array_equal(
                getattr(ts, name).numpy().view(np.uint32),
                np.asarray(getattr(js, name)).view(np.uint32))


N_SIM, PER = 4, 96


def _federation(jax_side: bool):
    data, loaders, cfgs, worker, lag = (
        (JData, j_loaders, j_cfgs, JWorker, j_lag) if jax_side
        else (TData, t_loaders, t_cfgs, TWorker, t_lag))
    x, y = data(n_samples=N_SIM * PER, n_features=16, n_classes=5,
                seed=0).generate()
    splits = [np.arange(i * PER, (i + 1) * PER) for i in range(N_SIM)]
    lds = loaders((x, y), splits, seed=0, batch_menu=(32,))
    wcfg = cfgs(N_SIM, [PER] * N_SIM, seed=0, batch_menu=(32,))
    return [worker(cfg=wcfg[k], loader=lds[k], loss_and_grad=lag)
            for k in range(N_SIM)]


@pytest.fixture(scope="module")
def knob_runs():
    jparams = j_init(jax.random.PRNGKey(0), 16, 5, hidden=(32,))
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    knobs = dict(wire_block_rows=2, wire_block_workers=2)
    jres = JSim(_federation(True), jparams,
                JCfg(n_workers=N_SIM)).run_fedpc(3, **knobs)
    out = {}
    for driver in ("run_fedpc", "run_fedpc_scan"):
        tsim = TSim(_federation(False),
                    params_from_numpy(params_np, device="cpu"),
                    TCfg(n_workers=N_SIM), device="cpu")
        out[driver] = getattr(tsim, driver)(3, **knobs)
    return jres, out


@pytest.mark.parametrize("driver", ["run_fedpc", "run_fedpc_scan"])
def test_drivers_with_pinned_knobs_match_the_reference(knob_runs, driver):
    jres, out = knob_runs
    tres = out[driver]
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-3)
    for a, b in zip(tree_leaves(tres.params),
                    jax.tree_util.tree_leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)
    # the two drivers of the port: the same bits under the same plan
    other = out["run_fedpc" if driver == "run_fedpc_scan"
                else "run_fedpc_scan"]
    assert tres.costs == other.costs
    for a, b in zip(tree_leaves(tres.params), tree_leaves(other.params)):
        assert torch.equal(a, b)
