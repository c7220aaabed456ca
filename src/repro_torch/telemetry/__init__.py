"""Observability: device-resident round records, JSONL traces
cross-checked against the byte models, and profiler scopes.

* ``telemetry.record`` — :class:`RoundTelemetry` / :class:`TelemetryCarry`
  of 0-d device tensors, in ``round_step``'s info and the round state (no
  host sync; one fetch after the run).
* ``telemetry.trace`` — the JAX package's JSONL event schema,
  :func:`build_trace` with a :class:`TelemetryMismatch` on any divergence
  from the ``core.protocol`` byte models, :func:`summarize` rollups, the
  streaming :class:`TraceWriter`.
* ``telemetry.profile`` — ``torch.profiler.record_function`` scopes on
  the kernel launches, named like the tune table, and a
  ``torch.profiler`` session helper.
* ``telemetry.report`` — a CLI rendering round tables and per-kind
  rollups from a trace file (``python -m repro_torch.telemetry.report
  trace.jsonl``).
* ``telemetry.smoke`` — a tiny traced federation written, validated and
  cross-checked end to end.
"""
from repro_torch.telemetry.record import (  # noqa: F401
    RoundTelemetry, TelemetryCarry, build_round_record,
)
from repro_torch.telemetry.trace import (  # noqa: F401
    SCHEMA_VERSION, TelemetryMismatch, TraceSummary, TraceWriter,
    build_trace, read_trace, round_bytes, summarize, trace_meta,
    validate_event, validate_trace, write_trace,
)
from repro_torch.telemetry.profile import (  # noqa: F401
    kernel_scope, profile_session, scope_name,
)
