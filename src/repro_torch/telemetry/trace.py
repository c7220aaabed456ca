"""Structured JSONL traces of a federation: export, schema, cross-check.

The JAX package's ``repro.telemetry.trace`` in the port, event for event,
so a trace written by either package passes the other's validator and
report. A trace is a JSON-Lines file whose first event is a ``meta``
record and whose other events are flat dicts, one a round, worker, tree
edge or tuner-timed plan, each tagged with its kind under ``"ev"``. The
schema is checked field by field (:func:`validate_trace`), so downstream
tools (``telemetry/report.py``, dashboards, regression diffs) can rely on
it.

Bytes flow one way: the device records exact participation, fault and
recovery counts (``repro_torch.telemetry.record``), and :func:`round_bytes`
derives the byte totals from those counts through the
``repro_torch.core.protocol`` models. The simulator computes its ledger
bytes on its own from its host-side schedules; :func:`build_trace`
compares the two, count by count and byte by byte, and any divergence
raises :class:`TelemetryMismatch` instead of exporting a wrong ledger.
:func:`summarize` derives the bytes again from a trace read back from
disk, so a stored trace proves its own accounting.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core import protocol as proto
from repro_torch.core.tree import TreeSpec

SCHEMA_VERSION = 1

#: ``sent`` values of a worker event — what crossed the uplink this round.
SENT_KINDS = ("pilot_params", "masked_words", "packed_ternary", "none")


class TelemetryMismatch(RuntimeError):
    """Device-recorded telemetry disagrees with the host byte/ledger model.

    This is a loud failure on purpose: the trace is the system's account of
    its own wire traffic, and a divergence means either the protocol byte
    model or the round program drifted — never something to average away.
    """


_NUM = (int, float)

#: Event schemas: ev -> {field: allowed python types}. Every field is
#: required; unknown fields reject (meta excepted — its run-config tail is
#: source-specific and carried verbatim).
_SCHEMAS: dict[str, dict[str, tuple]] = {
    "meta": {"ev": (str,), "schema": (int,), "source": (str,)},
    "round": {"ev": (str,), "t": (int,), "pilot": (int,),
              "n_sampled": (int,), "n_used": (int,), "n_dead": (int,),
              "n_pre_uplink": (int,), "n_recovered": (int,),
              "n_degraded": (int,), "cost": _NUM,
              "wire_bytes": _NUM, "recovery_bytes": _NUM},
    "worker": {"ev": (str,), "t": (int,), "worker": (int,),
               "sampled": (bool,), "fault": (int,), "pilot": (bool,),
               "sent": (str,)},
    "edge": {"ev": (str,), "t": (int,), "level": (int,), "width": (int,),
             "word_bits": (int,), "bytes": _NUM},
    "plan": {"ev": (str,), "kind": (str,), "rows": (int,), "n": (int,),
             "backend": (str,), "block_rows": (int,),
             "block_workers": (int,), "us": _NUM, "best": (bool,)},
}


def validate_event(event: dict) -> None:
    """Raise ``ValueError`` unless ``event`` matches its kind's schema."""
    ev = event.get("ev")
    if ev not in _SCHEMAS:
        raise ValueError(f"unknown trace event kind: {ev!r}")
    schema = _SCHEMAS[ev]
    for name, types in schema.items():
        if name not in event:
            raise ValueError(f"{ev} event missing field {name!r}: {event}")
        val = event[name]
        # bool is an int subclass; only fields typed bool accept it.
        if isinstance(val, bool) and bool not in types:
            raise ValueError(
                f"{ev} event field {name!r} has bool where "
                f"{types} expected: {event}")
        if not isinstance(val, types):
            raise ValueError(
                f"{ev} event field {name!r} = {val!r} is not of "
                f"{types}: {event}")
    if ev != "meta":
        extra = set(event) - set(schema)
        if extra:
            raise ValueError(f"{ev} event has unknown fields {extra}")
    if ev == "worker" and event["sent"] not in SENT_KINDS:
        raise ValueError(f"worker event sent={event['sent']!r} not in "
                         f"{SENT_KINDS}")


def validate_trace(events: Iterable[dict]) -> int:
    """Validate a whole event stream (first event must be ``meta`` at the
    current schema version); returns the number of events."""
    n = 0
    for i, event in enumerate(events):
        if i == 0:
            if event.get("ev") != "meta":
                raise ValueError("trace must start with a meta event")
            if event.get("schema") != SCHEMA_VERSION:
                raise ValueError(
                    f"trace schema {event.get('schema')!r} != "
                    f"{SCHEMA_VERSION}")
        validate_event(event)
        n += 1
    if n == 0:
        raise ValueError("empty trace")
    return n


def write_trace(path: str, events: Iterable[dict]) -> int:
    """Write events as JSONL (validated); returns the event count."""
    events = list(events)
    validate_trace(events)
    with open(path, "w") as f:
        for event in events:
            f.write(json.dumps(event) + "\n")
    return len(events)


def read_trace(path: str) -> list[dict]:
    """Read + validate a JSONL trace."""
    with open(path) as f:
        events = [json.loads(line) for line in f if line.strip()]
    validate_trace(events)
    return events


class TraceWriter:
    """Streaming JSONL writer (tuner sweeps, long benches): validates and
    flushes each event as it is emitted, so a crashed run keeps its trace
    prefix. Usable as a context manager; ``emit`` is a plain callable
    sink, for example for :func:`plan_emitter`."""

    def __init__(self, path: str, *, source: str, meta: dict | None = None):
        self._f = open(path, "w")
        self.path = path
        self.count = 0
        self.emit({"ev": "meta", "schema": SCHEMA_VERSION,
                   "source": source, **(meta or {})})

    def emit(self, event: dict) -> None:
        validate_event(event)
        self._f.write(json.dumps(event) + "\n")
        self._f.flush()
        self.count += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Byte derivation from device counts (the protocol models are the oracle)
# ---------------------------------------------------------------------------

def trace_meta(*, source: str, algorithm: str, driver: str, n_workers: int,
               t0: int, rounds: int, model_bytes: int, wire: str,
               masking: bool, modulus_bits: int, fanout: int, levels: int,
               recovery_threshold: int, faults_active: bool) -> dict:
    """The federation meta event — everything :func:`round_bytes` needs to
    turn a round event's counts into exact byte totals."""
    return {"ev": "meta", "schema": SCHEMA_VERSION, "source": source,
            "algorithm": algorithm, "driver": driver,
            "n_workers": int(n_workers), "t0": int(t0),
            "rounds": int(rounds), "model_bytes": int(model_bytes),
            "wire": wire, "masking": bool(masking),
            "modulus_bits": int(modulus_bits), "fanout": int(fanout),
            "levels": int(levels),
            "recovery_threshold": int(recovery_threshold),
            "faults_active": bool(faults_active)}


def round_bytes(meta: dict, rec: dict) -> tuple[float, float]:
    """(wire_bytes, recovery_bytes) of one round, derived from the round's
    device counts through the ``core.protocol`` models — the single byte
    path every consumer (SimResult views, report CLI, CI greps) reads."""
    masked = meta["wire"] == "masked"
    mb = meta["model_bytes"]
    n_part = rec["n_sampled"]
    if meta["fanout"]:
        wire = proto.fedpc_tree_bytes_per_round(
            mb, n_part, meta["fanout"], levels=meta["levels"] or None,
            word_bits=meta["modulus_bits"] if masked else None)
    elif masked:
        wire = proto.fedpc_masked_bytes_per_round(
            mb, n_part, word_bits=meta["modulus_bits"])
    else:
        wire = proto.fedpc_bytes_per_round(mb, n_part)
    rec_bytes = 0.0
    if meta["faults_active"]:
        # Pre-uplink deaths never spent their uplink bytes.
        leaf_bits = float(meta["modulus_bits"]) if masked else 2.0
        wire -= mb * rec["n_pre_uplink"] * leaf_bits / 32.0
        if meta["masking"] and meta["recovery_threshold"]:
            g = meta["fanout"] or None
            rec_bytes = (
                proto.recovery_dealing_bytes_per_round(meta["n_workers"], g)
                + proto.recovery_reconstruction_bytes(
                    rec["n_recovered"], meta["recovery_threshold"], g,
                    n_workers=meta["n_workers"]))
    return float(wire), float(rec_bytes)


# ---------------------------------------------------------------------------
# Trace assembly + cross-check
# ---------------------------------------------------------------------------

@dataclass
class TraceSummary:
    """A parsed/assembled trace: the meta event plus events grouped by
    kind, with the derived per-round views ``SimResult`` exposes."""
    meta: dict
    rounds: list = field(default_factory=list)
    workers: list = field(default_factory=list)
    edges: list = field(default_factory=list)
    plans: list = field(default_factory=list)

    @property
    def bytes_per_round(self) -> list:
        return [float(r["wire_bytes"]) for r in self.rounds]

    @property
    def recovery_bytes_per_round(self) -> list:
        return [float(r["recovery_bytes"]) for r in self.rounds]

    @property
    def total_bytes(self) -> float:
        return float(np.sum(self.bytes_per_round)
                     + np.sum(self.recovery_bytes_per_round))

    @property
    def costs(self) -> list:
        return [float(r["cost"]) for r in self.rounds]

    @property
    def pilots(self) -> list:
        return [int(r["pilot"]) for r in self.rounds]

    def events(self) -> list[dict]:
        return [self.meta] + self.rounds + self.workers + self.edges \
            + self.plans

    def write(self, path: str) -> int:
        return write_trace(path, self.events())

    def crosscheck_line(self) -> str:
        """The one-line attestation CI greps for."""
        return (f"byte cross-check OK: {len(self.rounds)} rounds, "
                f"{self.total_bytes:.0f} trace bytes == core/protocol "
                f"models")


def _require(ok: bool, what: str, t: int, device, host) -> None:
    if not ok:
        raise TelemetryMismatch(
            f"TELEMETRY MISMATCH at round {t}: {what} — device-recorded "
            f"{device!r} vs host ledger model {host!r}. The trace would "
            f"not match core/protocol byte accounting; refusing to "
            f"export it.")


def build_trace(meta: dict, records, host_rounds: list[dict], *,
                check_costs: bool = True) -> TraceSummary:
    """Assemble the federation trace from the stacked device records and
    cross-check every round against the host's independent ledger math.

    ``records`` is a ``RoundTelemetry`` of (R,)-stacked arrays or tensors
    (device tensors are fetched here, once after the run); ``host_rounds[i]`` carries what the simulator
    computed from its own host-side schedules: ``row`` (participation
    bools), ``codes`` (fault codes or None), ``used`` (effective-report
    bools), ``n_recoverable``, ``pilot``, ``cost``, ``wire_bytes``,
    ``recovery_bytes``. Counts must match exactly, derived bytes must
    equal the host bytes exactly; costs compare within float32 tolerance
    (``check_costs=False`` for the evasion defence, where the device
    averages the *reported* costs and the host ledger the measured ones).
    """
    recs = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in records._asdict().items()}
    n_rounds = len(host_rounds)
    validate_event(meta)
    rounds_ev: list[dict] = []
    workers_ev: list[dict] = []
    edges_ev: list[dict] = []
    prev_cost = float("inf")
    for i, host in enumerate(host_rounds):
        t = int(recs["round"][i])
        _require(t == int(meta["t0"]) + i, "round index", t,
                 t, int(meta["t0"]) + i)
        rec = {k: int(recs[k][i]) for k in
               ("pilot", "n_sampled", "n_used", "n_dead", "n_pre_uplink",
                "n_recovered", "n_degraded")}
        row = np.asarray(host["row"]) > 0
        used = np.asarray(host["used"]) > 0
        codes = host.get("codes")
        _require(rec["pilot"] == int(host["pilot"]), "pilot id", t,
                 rec["pilot"], int(host["pilot"]))
        _require(rec["n_sampled"] == int(row.sum()), "sampled count", t,
                 rec["n_sampled"], int(row.sum()))
        _require(rec["n_used"] == int(used.sum()), "used-report count", t,
                 rec["n_used"], int(used.sum()))
        if codes is None:
            host_dead = host_pre = 0
        else:
            codes = np.asarray(codes)
            host_dead = int((row & (codes != 0)).sum())
            host_pre = int((row & (codes == 1)).sum())
        _require(rec["n_dead"] == host_dead, "fault count", t,
                 rec["n_dead"], host_dead)
        _require(rec["n_pre_uplink"] == host_pre, "pre-uplink-death count",
                 t, rec["n_pre_uplink"], host_pre)
        _require(rec["n_recovered"] == int(host["n_recoverable"]),
                 "recoverable-death count", t, rec["n_recovered"],
                 int(host["n_recoverable"]))
        wire_b, rec_b = round_bytes(meta, rec)
        _require(wire_b == float(host["wire_bytes"]), "wire bytes", t,
                 wire_b, float(host["wire_bytes"]))
        _require(rec_b == float(host["recovery_bytes"]), "recovery bytes",
                 t, rec_b, float(host["recovery_bytes"]))
        ws = float(recs["weight_sum"][i])
        cost = (float(recs["cost_sum"][i]) / ws if ws > 0 else prev_cost)
        prev_cost = cost
        if check_costs:
            hc = float(host["cost"])
            close = (cost == hc or (np.isinf(cost) and np.isinf(hc))
                     or abs(cost - hc) <= 1e-4 * max(abs(hc), 1e-6))
            _require(close, "round cost", t, cost, hc)
        rounds_ev.append({"ev": "round", "t": t, **rec, "cost": cost,
                          "wire_bytes": wire_b, "recovery_bytes": rec_b})
        for k in range(meta["n_workers"]):
            sampled = bool(row[k])
            fault = 0 if codes is None else int(codes[k])
            if not sampled or fault == 1:
                sent = "none"
            elif k == rec["pilot"]:
                sent = "pilot_params"
            elif meta["wire"] == "masked":
                sent = "masked_words"
            else:
                sent = "packed_ternary"
            workers_ev.append({"ev": "worker", "t": t, "worker": k,
                               "sampled": sampled, "fault": fault,
                               "pilot": k == rec["pilot"], "sent": sent})
        if meta["fanout"]:
            ts = TreeSpec(fanout=meta["fanout"],
                          levels=meta["levels"] or None)
            word_bits = (meta["modulus_bits"] if meta["wire"] == "masked"
                         else 32)
            n_part = rec["n_sampled"]
            for lvl, w_l in enumerate(ts.level_widths(n_part)[1:], 1):
                edges_ev.append({
                    "ev": "edge", "t": t, "level": lvl, "width": int(w_l),
                    "word_bits": int(word_bits),
                    "bytes": meta["model_bytes"] * w_l * word_bits / 32.0})
    _require(n_rounds == len(rounds_ev), "round count", -1,
             len(rounds_ev), n_rounds)
    return TraceSummary(meta=meta, rounds=rounds_ev, workers=workers_ev,
                        edges=edges_ev)


def summarize(events: list[dict]) -> TraceSummary:
    """Group a (validated) event stream and re-verify its byte accounting.

    For federation traces every round event's recorded bytes are re-derived
    from its counts through :func:`round_bytes`; divergence raises
    :class:`TelemetryMismatch` — a stored trace re-proves itself on read.
    """
    validate_trace(events)
    meta = events[0]
    summary = TraceSummary(meta=meta)
    buckets = {"round": summary.rounds, "worker": summary.workers,
               "edge": summary.edges, "plan": summary.plans}
    for event in events[1:]:
        buckets[event["ev"]].append(event)
    if "model_bytes" in meta:
        for r in summary.rounds:
            wire_b, rec_b = round_bytes(meta, r)
            _require(wire_b == float(r["wire_bytes"]),
                     "stored wire bytes", r["t"], wire_b, r["wire_bytes"])
            _require(rec_b == float(r["recovery_bytes"]),
                     "stored recovery bytes", r["t"], rec_b,
                     r["recovery_bytes"])
    return summary


def plan_emitter(emit: Callable[[dict], None]) -> Callable[..., None]:
    """Adapt a raw event sink into the hook ``kernels.tune.
    set_trace_writer`` takes (the JAX package's signature): one plan event
    per timed candidate."""
    def hook(kind: str, rows: int, n: int, backend: str,
             timings: list[dict], best: dict) -> None:
        for tm in timings:
            emit({"ev": "plan", "kind": kind, "rows": int(rows),
                  "n": int(n), "backend": backend,
                  "block_rows": int(tm["block_rows"]),
                  "block_workers": int(tm["block_workers"]),
                  "us": float(tm["us"]),
                  "best": (tm["block_rows"] == best["block_rows"]
                           and tm["block_workers"] == best["block_workers"])
                  })
    return hook


def events_of(obj: "TraceSummary | list[dict] | Any") -> list[dict]:
    """Events of a TraceSummary, an event list, or a trace file path."""
    if isinstance(obj, TraceSummary):
        return obj.events()
    if isinstance(obj, str):
        return read_trace(obj)
    return list(obj)
