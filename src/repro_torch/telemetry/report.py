"""Render a telemetry trace: round table, rollups, byte cross-check.

``python -m repro_torch.telemetry.report trace.jsonl`` reads a JSONL trace
(federation or tuner-sweep), re-verifies its byte accounting against the
``core.protocol`` models (:func:`repro_torch.telemetry.trace.summarize` raises
:class:`~repro_torch.telemetry.trace.TelemetryMismatch` on any divergence),
and prints a round-by-round table plus per-kind rollups. CI greps the
final ``byte cross-check OK`` line. A trace of either package renders.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.telemetry import trace as tmt


def _fmt_bytes(b: float) -> str:
    if b >= 1e9:
        return f"{b / 1e9:.2f}GB"
    if b >= 1e6:
        return f"{b / 1e6:.2f}MB"
    if b >= 1e3:
        return f"{b / 1e3:.1f}kB"
    return f"{b:.0f}B"


def _table(rows: list[list[str]], header: list[str]) -> str:
    widths = [max(len(str(c)) for c in col)
              for col in zip(*([header] + rows))]
    def line(cells):
        return "  ".join(str(c).rjust(w) for c, w in zip(cells, widths))
    return "\n".join([line(header), line(["-" * w for w in widths])]
                     + [line(r) for r in rows])


def _meta_lines(meta: dict) -> list[str]:
    skip = {"ev", "schema"}
    return [f"  {k}: {meta[k]}" for k in meta if k not in skip]


def _round_table(summary: tmt.TraceSummary) -> str:
    header = ["t", "pilot", "sampled", "used", "dead", "pre", "recov",
              "degr", "cost", "wire", "recovery"]
    rows = [[r["t"], r["pilot"], r["n_sampled"], r["n_used"], r["n_dead"],
             r["n_pre_uplink"], r["n_recovered"], r["n_degraded"],
             f"{r['cost']:.4f}", _fmt_bytes(r["wire_bytes"]),
             _fmt_bytes(r["recovery_bytes"])]
            for r in summary.rounds]
    return _table(rows, header)


def _worker_rollup(summary: tmt.TraceSummary) -> str:
    counts: dict[str, int] = {}
    for w in summary.workers:
        counts[w["sent"]] = counts.get(w["sent"], 0) + 1
    parts = [f"{k}={counts[k]}" for k in tmt.SENT_KINDS if k in counts]
    return "uplink events: " + ", ".join(parts)


def _edge_rollup(summary: tmt.TraceSummary) -> str:
    per_level: dict[int, float] = {}
    for e in summary.edges:
        per_level[e["level"]] = per_level.get(e["level"], 0.0) + e["bytes"]
    parts = [f"L{lvl}={_fmt_bytes(b)}"
             for lvl, b in sorted(per_level.items())]
    return "interior tree-edge bytes: " + ", ".join(parts)


def _plan_table(summary: tmt.TraceSummary) -> str:
    by_key: dict[tuple, list[dict]] = {}
    for p in summary.plans:
        by_key.setdefault(
            (p["kind"], p["rows"], p["n"], p["backend"]), []).append(p)
    header = ["kind", "rows", "n", "backend", "plans", "best plan",
              "best us", "worst us"]
    rows = []
    for (kind, r, n, backend), plans in sorted(by_key.items()):
        best = min(plans, key=lambda p: p["us"])
        rows.append([kind, r, n, backend, len(plans),
                     f"{best['block_rows']}x{best['block_workers']}",
                     f"{best['us']:.1f}",
                     f"{max(p['us'] for p in plans):.1f}"])
    return _table(rows, header)


def render(summary: tmt.TraceSummary) -> str:
    out = [f"trace: {summary.meta.get('source', '?')} "
           f"(schema v{summary.meta['schema']})"]
    out += _meta_lines(summary.meta)
    if summary.rounds:
        out += ["", _round_table(summary)]
        out += ["", f"total wire bytes: "
                    f"{sum(summary.bytes_per_round):.0f}  "
                    f"recovery: {sum(summary.recovery_bytes_per_round):.0f}"]
    if summary.workers:
        out += ["", _worker_rollup(summary)]
    if summary.edges:
        out += [_edge_rollup(summary)]
    if summary.plans:
        out += ["", "tuner sweeps:", _plan_table(summary)]
    if summary.rounds:
        out += ["", summary.crosscheck_line()]
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render a FedPC telemetry JSONL trace.")
    ap.add_argument("trace", help="path to a trace .jsonl file")
    args = ap.parse_args(argv)
    try:
        summary = tmt.summarize(tmt.read_trace(args.trace))
    except tmt.TelemetryMismatch as e:
        print(e, file=sys.stderr)
        return 1
    print(render(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
