"""Launch plans for the wire kernels: the table, its heuristics, the rules
that snap a plan to one a kernel honours, and the timed sweeps.

A plan is ``(block_rows, block_workers)``, keyed like the JAX package's
tuner by ``(kind, rows, n_workers, backend)``. Every plan computes the
same bits: the uplinks are elementwise, the masters fold the workers
strictly in order k = 0..N−1 under every plan, and the integer kernels
sum words mod 2**bits, which is order-free. So a sweep picks on time
alone.

On the card (backend ``"cuda"``) a plan is a launch geometry of the
CUDA kernels of ``csrc/`` (their header comments say how each honours
it). A CTA is always ``CTA_THREADS`` = 256 threads; a kernel-view row is
128 positions (a float4 of every float operand, a byte of every packed
one, four words of every word operand):

- ``block_rows``: the rows one CTA covers, its threads looping over
  them 256 positions at a time. 2 is one position a thread, the
  geometry every kernel launched before plans existed. The repair
  (``mask_repair*``) keeps its persistent grid and reads it as the rows
  a CTA covers in one pass of that grid, its 16-byte chunks a thread.
- ``block_workers``: on the uplinks (``uplink_stacked``, the masked
  uplink's row fold) the workers one CTA handles, ``grid.y = ceil(N /
  block_workers)``, each worker block reading the history again; on the
  masters (``master``, ``master_masked*``) the workers whose bytes or
  words a thread loads ahead of each step of its fold; on the partial
  sums (``partial_sum*``, whose key holds the fanout as ``n_workers``)
  the output groups one CTA folds.

The plain PyTorch twin a CPU tensor takes (backend ``"cpu-plain"``) has
no grid: a plan there is snapped by the JAX package's rules and
recorded, and changes nothing.

``lookup`` never times anything: the tuned entry, else the backend's
heuristic, so the ``ops`` wrappers that call it whenever the caller
leaves ``block_rows``/``block_workers`` as None pay a dict probe.
``autotune_*`` run the timed sweep and fill the table.
``save_table``/``load_table`` keep it as JSON; ``REPRO_TUNE_TABLE``
naming such a file loads it at import. A file holding the JAX
package's entries too loads as it is: their backends (``"tpu"``,
``"cpu-interpret"``) are never looked up here.

The kernel modules are imported inside the ``autotune_*`` functions: the
kernel wrappers import ``telemetry.profile``, which imports this module.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Callable

import torch

from repro_torch.utils import cdiv, resolve_device

# The JAX package's TPU-shaped fallbacks (its default plan off the
# interpreter), kept so ``default_plan`` answers for its backends too.
BLOCK_ROWS = 64
BLOCK_WORKERS = 1

#: Threads of every CTA of the tuned CUDA kernels (``wire::kThreads``).
CTA_THREADS = 256
#: Positions of one kernel-view row.
ROW_POSITIONS = 128
#: The rows a CTA covers with one position a thread.
CUDA_BLOCK_ROWS = CTA_THREADS // ROW_POSITIONS
#: Workers a master's thread may load ahead of its fold (instantiated in
#: ``csrc/fused_wire.cu`` and ``csrc/masked_wire.cu``).
MASTER_AHEAD = (1, 2, 4, 8)
#: 16-byte chunks a repair thread may own in one pass (``csrc/masked_wire.cu``).
REPAIR_CHUNKS = (1, 2, 4)
#: Streaming multiprocessors of an H100 SXM, where no card can be asked.
H100_SMS = 132

KINDS = ("uplink", "uplink_stacked", "master", "uplink_masked",
         "master_masked", "uplink_masked16", "master_masked16",
         "partial_sum", "partial_sum_masked", "partial_sum_masked16",
         "mask_repair", "mask_repair16")

# An untuned kind borrows down a chain of geometry twins, as in the JAX
# package: 16-bit kinds the 32-bit masked plans, those the unmasked kinds,
# those the backend heuristic. On "cuda" the walk takes only the steps of
# ``_CUDA_TWINS`` (see :func:`lookup`).
MASKED_FALLBACK = {"uplink_masked16": "uplink_masked",
                   "master_masked16": "master_masked",
                   "uplink_masked": "uplink_stacked",
                   "master_masked": "master",
                   "partial_sum_masked16": "partial_sum_masked",
                   "partial_sum_masked": "partial_sum",
                   "mask_repair16": "mask_repair",
                   "mask_repair": "uplink"}

# The steps of MASKED_FALLBACK that stay within one CUDA kernel: the
# 16-bit kind and its 32-bit twin launch the same code, which reads a plan
# the same way. Every other step crosses to another kernel (the masked
# uplink to the plain one, the repair to the one-worker uplink), whose
# best plan says nothing of the borrower's; the repair's block_rows counts
# different chunks at each width.
_CUDA_TWINS = frozenset({"uplink_masked16", "master_masked16",
                         "partial_sum_masked16"})

# (kind, rows, n_workers, backend) -> {"block_rows": int, "block_workers": int}
_TABLE: dict[tuple[str, int, int, str], dict] = {}

# Fallback-chain resolutions already reported, one line per key.
_FALLBACK_LOGGED: set[tuple[str, int, int, str]] = set()

# A "cpu-plain" sweep tries the JAX package's interpret-mode candidates,
# capped as it caps them.
_MAX_SWEEP_STEPS_INTERPRET = 16

# Optional sweep hook: hook(kind, rows, n, backend, timings, best), called
# once a sweep (``telemetry.trace.plan_emitter`` adapts an event sink).
_TRACE_HOOK = None


def set_trace_writer(hook) -> None:
    """Install (or clear, with None) the hook every sweep reports through:
    one call a sweep with its full timing list."""
    global _TRACE_HOOK
    _TRACE_HOOK = hook


def _emit_sweep(kind, rows, n, backend, timings, best) -> None:
    if _TRACE_HOOK is not None:
        _TRACE_HOOK(kind, rows, n, backend, timings, best)


def backend_tag(device=None) -> str:
    """The table's backend key: ``"cuda"`` for the CUDA kernel (the
    default device, as the entry points'), ``"cpu-plain"`` for the plain
    PyTorch version any other tensor takes."""
    if device is None:
        return "cuda"
    return "cuda" if torch.device(device).type == "cuda" else "cpu-plain"


def fit_block_rows(rows: int, want: int) -> int:
    """Largest multiple of gcd(rows, want) ≤ ``want`` that divides
    ``rows`` (the JAX package's rule: a Pallas grid tiles the rows
    exactly, and the gcd keeps 8-row alignment)."""
    if rows <= want:
        return rows
    g = math.gcd(rows, want)
    b = (want // g) * g
    while rows % b:
        b -= g
    return b


def fit_block_workers(n: int, want: int) -> int:
    """Largest divisor of ``n`` that is ≤ ``want`` (the JAX package's
    rule: worker blocks tile the worker axis exactly)."""
    want = max(1, min(n, want))
    for b in range(want, 0, -1):
        if n % b == 0:
            return b
    return 1


# Group-axis "all of them" sentinel of the interpreter's partial-sum plan.
_ALL_GROUPS = 1 << 30


def _family(kind: str) -> str:
    """The plan rules a kind follows: ``uplink`` (one worker), ``stacked``
    (a worker axis a CTA may split), ``master`` (loads ahead), ``groups``
    (partial sums), ``repair``."""
    if kind == "uplink":
        return "uplink"
    if kind in ("uplink_stacked", "uplink_masked", "uplink_masked16"):
        return "stacked"
    if kind.startswith("master"):
        return "master"
    if kind.startswith("partial_sum"):
        return "groups"
    if kind.startswith("mask_repair"):
        return "repair"
    raise ValueError(f"unknown kernel kind {kind!r}")


def repair_rows(kind: str) -> tuple[int, ...]:
    """The ``block_rows`` the repair honours: the rows a pass of its
    persistent grid covers with ``REPAIR_CHUNKS`` 16-byte chunks a
    thread (a row is 1,024 bytes at 16 bits, 2,048 at 32)."""
    per_chunk = 4 if kind.endswith("16") else 2
    return tuple(per_chunk * c for c in REPAIR_CHUNKS)


def _cuda_default(kind: str, n_workers: int) -> dict:
    """The launch geometry of every CUDA kernel before plans: one
    position a thread, 256 threads a CTA; an uplink CTA loops over all
    N workers, a master loads one worker's bytes a step of its fold, a
    partial-sum CTA folds one group; the repair owns 4 chunks a thread."""
    family = _family(kind)
    if family == "repair":
        return {"block_rows": repair_rows(kind)[-1], "block_workers": 1}
    bw = max(1, n_workers) if family == "stacked" else 1
    return {"block_rows": CUDA_BLOCK_ROWS, "block_workers": bw}


def default_plan(kind: str, rows: int, n_workers: int = 1,
                 backend: str | None = None) -> dict:
    """The untimed heuristic. ``"cuda"``: the kernels' one geometry from
    before plans (:func:`_cuda_default`), so a caller who passes nothing
    launches it. ``"cpu-plain"`` (and the JAX package's
    ``"cpu-interpret"``): one step over the whole operand, as the JAX
    package's interpreter wants; the plain twin has no grid. Any other
    backend: the JAX package's TPU tiles. For the partial-sum kinds
    ``n_workers`` holds the fanout and ``block_workers`` means output
    groups."""
    backend = backend or backend_tag()
    if backend == "cuda":
        return _cuda_default(kind, n_workers)
    if backend in ("cpu-plain", "cpu-interpret"):
        if kind.startswith("partial_sum"):
            return {"block_rows": rows, "block_workers": _ALL_GROUPS}
        return {"block_rows": rows, "block_workers": max(1, n_workers)}
    if kind.startswith("partial_sum"):
        return {"block_rows": fit_block_rows(rows, BLOCK_ROWS),
                "block_workers": 1}
    return {"block_rows": fit_block_rows(rows, BLOCK_ROWS),
            "block_workers": fit_block_workers(max(1, n_workers),
                                               BLOCK_WORKERS)}


def fit_cuda_plan(kind: str, rows: int, extent: int, block_rows: int,
                  block_workers: int, *, pairs: bool = False
                  ) -> tuple[int, int]:
    """Snap a plan to the nearest one the CUDA kernel of ``kind`` honours,
    over ``rows`` kernel-view rows and a worker axis of ``extent`` (the
    workers of an uplink, the byte or word rows a master folds, the
    groups a partial sum writes). The rules:

    - ``block_rows``: any value in [1, max(rows, 2)] (a ragged last CTA
      is guarded, so the default's 2 holds at one row), clamped into it;
      the repair's: the largest of
      :func:`repair_rows` ≤ the request, else the smallest.
    - ``block_workers``: 1 on the one-worker uplink and the repair; the
      uplinks' worker blocks any value in [1, N]; the masters' loads
      ahead the largest of ``MASTER_AHEAD`` ≤ the request and ≤ the rows
      they fold; the masked partial sum's groups any value in [1, G].
    - Three kernels honour only their default, so every request snaps to
      it: the masked uplink's pair and tile kernels (``pairs``:
      ``masked_wire.uses_pair_kernel``), which hold all N workers, and
      the leaf partial sum (``partial_sum``). The pair kernel's and the
      leaf partial sum's loop over a longer span was slower at every plan
      tried on an H100; the tile kernel sets its own geometry by N.
    """
    family = _family(kind)
    rows, extent = max(1, int(rows)), max(1, int(extent))
    if kind == "partial_sum" or (family == "stacked" and pairs):
        return CUDA_BLOCK_ROWS, 1 if kind == "partial_sum" else extent
    br, bw = max(1, int(block_rows)), max(1, int(block_workers))
    if family == "repair":
        legal = repair_rows(kind)
        br = max((r for r in legal if r <= br), default=legal[0])
    else:
        br = min(br, max(rows, CUDA_BLOCK_ROWS))
    if family in ("uplink", "repair"):
        bw = 1
    elif family == "stacked":
        bw = min(bw, extent)
    elif family == "master":
        bw = max(a for a in MASTER_AHEAD if a <= min(bw, extent))
    else:
        bw = min(bw, extent)
    return br, bw


def fit_plan(kind: str, rows: int, extent: int, block_rows: int,
             block_workers: int, backend: str, *, pairs: bool = False
             ) -> tuple[int, int]:
    """Snap a requested plan for ``backend``: :func:`fit_cuda_plan` on
    the card; elsewhere the JAX package's ``ops`` rules
    (:func:`fit_block_rows`, :func:`fit_block_workers` over ``extent``;
    ``block_workers`` 1 where its wrapper has no worker axis)."""
    if backend == "cuda":
        return fit_cuda_plan(kind, rows, extent, block_rows, block_workers,
                             pairs=pairs)
    br = fit_block_rows(rows, block_rows)
    if _family(kind) in ("uplink", "repair"):
        return br, 1
    return br, fit_block_workers(extent, block_workers)


def check_cuda_plan(kind: str, rows: int, extent: int, block_rows: int,
                    block_workers: int, *, pairs: bool = False) -> None:
    """Raise unless the kernel of ``kind`` honours the plan as it is: a
    kernel wrapper launches no plan it would have to change."""
    fit = fit_cuda_plan(kind, rows, extent, block_rows, block_workers,
                        pairs=pairs)
    if fit != (block_rows, block_workers):
        raise ValueError(
            f"{kind} does not launch block_rows={block_rows}, block_"
            f"workers={block_workers} over rows={rows}, extent={extent}; "
            f"the nearest plan it honours is {fit} (ops snaps requests)")


def cuda_plan(kind: str, rows: int, extent: int, block_rows, block_workers,
              *, pairs: bool = False) -> tuple[int, int]:
    """A kernel wrapper's plan on the card: the one given, checked, each
    axis left None taken from the launch of before plans
    (:func:`_cuda_default` over ``extent``)."""
    default = _cuda_default(kind, extent)
    br = default["block_rows"] if block_rows is None else int(block_rows)
    bw = (default["block_workers"] if block_workers is None
          else int(block_workers))
    check_cuda_plan(kind, rows, extent, br, bw, pairs=pairs)
    return br, bw


def lookup(kind: str, rows: int, n_workers: int = 1, *,
           backend: str | None = None) -> tuple[int, int]:
    """(block_rows, block_workers) for a shape: the tuned entry, else the
    heuristic of ``backend`` (default ``"cuda"``; ``backend_tag(device)``
    names a tensor's).

    Never times anything. When the kind has no entry and resolution walks
    the ``MASKED_FALLBACK`` chain, the walk is reported once per (kind,
    rows, n, backend), as in the JAX package. On ``"cuda"`` the walk
    ends where a step would leave the borrower's kernel (``_CUDA_TWINS``)
    and lands on the heuristic.
    """
    backend = backend or backend_tag()
    n = max(1, n_workers)
    probe = kind
    chain = [kind]
    plan = _TABLE.get((probe, rows, n, backend))
    while plan is None and probe in MASKED_FALLBACK and (
            backend != "cuda" or probe in _CUDA_TWINS):
        probe = MASKED_FALLBACK[probe]
        chain.append(probe)
        plan = _TABLE.get((probe, rows, n, backend))
    if len(chain) > 1:
        key = (kind, rows, n, backend)
        if key not in _FALLBACK_LOGGED:
            _FALLBACK_LOGGED.add(key)
            landed = (f"tuned '{probe}' plan" if plan is not None
                      else f"'{backend}' heuristic")
            print(f"[tune] no plan for {kind}@(rows={rows}, n={n}, "
                  f"{backend}); fell back {' -> '.join(chain)} to the "
                  f"{landed}")
    if plan is None:
        plan = default_plan(kind, rows, n_workers, backend)
    return plan["block_rows"], plan["block_workers"]


def set_plan(kind: str, rows: int, n_workers: int, plan: dict, *,
             backend: str | None = None) -> None:
    """Pin a plan (tests, tables tuned elsewhere)."""
    _TABLE[(kind, rows, max(1, n_workers), backend or backend_tag())] = {
        "block_rows": int(plan["block_rows"]),
        "block_workers": int(plan["block_workers"])}


def clear_table() -> None:
    _TABLE.clear()


def master_vmem_tile_bytes(block_rows: int, block_workers: int) -> int:
    """The JAX package's model of the TPU master kernel's VMEM a grid
    step: four resident (block_rows, 512) float32 blocks (q, p1, p2 and
    the output accumulator) plus the (block_workers, block_rows, 128)
    packed uint8 sub-block, independent of N at a fixed block_workers.
    It models the TPU kernel's VMEM, not anything of the card's."""
    float_block = block_rows * 512 * 4
    return 4 * float_block + block_workers * block_rows * 128


def master_vmem_tile_bytes_preaccum(block_rows: int, n_workers: int) -> int:
    """The same TPU model for the JAX package's older master tile, which
    blocked the whole worker axis: linear in N."""
    float_block = block_rows * 512 * 4
    return 4 * float_block + n_workers * block_rows * 128


def _time_us(fn: Callable, reps: int, device=None) -> float:
    """Best of ``reps`` timings of ``fn`` in µs after a warm call: CUDA
    events on the current stream on the card (refused inside a captured
    graph), ``perf_counter`` elsewhere."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        fn()
        best = float("inf")
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e6)
        return best
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a sweep cannot be timed inside a captured graph")
    fn()
    best = float("inf")
    for _ in range(max(1, reps)):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) * 1e3)
    return best


def _sm_count(device) -> int:
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return H100_SMS


def _candidate_plans(kind: str, rows: int, n: int, backend: str, *,
                     extent: int | None = None, pairs: bool = False,
                     sms: int = H100_SMS) -> list[dict]:
    """A small sweep, deduplicated after snapping, the default plan first.

    ``"cuda"``, by family, with the Hopper reason for each candidate:

    - the uplinks: the default (2 rows, all N workers a CTA: the
      history read once, ceil(R/2) = 20,508 CTAs at R = 41,016, some
      twenty waves on 132 SMs); 8 rows a CTA (a quarter of the CTAs, each
      thread 4 positions: fewer block starts and key stagings on the
      masked row fold); enough rows that the grid is one wave of 8 CTAs
      an SM (every CTA resident at once, no tail wave); worker blocks of
      ceil(N/2) and of 1 (twice and N times the CTAs in flight for the
      same positions, each worker block reading p1/p2 again: the JAX
      package's rows-major, worker-minor trade). The pair and tile kernels
      honour their default alone (:func:`fit_cuda_plan`): a sweep of
      either is that plan.
    - the one-worker uplink: 2, 8 rows and one wave of 8 CTAs an SM.
    - the masters: 1, 2, 4 and 8 workers' bytes loaded ahead of each
      step of the fold (more loads in flight a thread against the
      latency of device memory, same fold order), and 8 rows a CTA with
      4 ahead.
    - the masked partial sum: 1 group a CTA at 2 and 8 rows, and all G
      groups a CTA (G times fewer CTAs, each walking its positions G
      times). The leaf partial sum honours its default alone.
    - the repair: 4, 2 and 1 chunks a thread a pass (64, 32, 16 bytes in
      flight a thread before its hashing).

    ``"cpu-plain"``: the JAX package's interpret-mode candidates, which
    change nothing here (the plain twin has no grid).
    """
    family = _family(kind)
    ext = n if extent is None else extent
    if backend == "cuda":
        def one_wave(per_sm: int) -> int:
            return cdiv(rows, sms * per_sm)
        if kind == "partial_sum" or (family == "stacked" and pairs):
            raw = []
        elif family == "stacked":
            raw = [(2, ext), (8, ext), (one_wave(8), ext),
                   (2, cdiv(ext, 2)), (2, 1)]
        elif family == "uplink":
            raw = [(2, 1), (8, 1), (one_wave(8), 1)]
        elif family == "master":
            raw = [(2, 1), (2, 2), (2, 4), (2, 8), (8, 4)]
        elif family == "groups":
            raw = [(2, 1), (8, 1), (2, ext), (8, ext)]
        else:
            legal = repair_rows(kind)
            raw = [(r, 1) for r in reversed(legal)]
        default = _cuda_default(kind, n)
        raw.insert(0, (default["block_rows"], default["block_workers"]))
        cands = [fit_cuda_plan(kind, rows, ext, br, bw, pairs=pairs)
                 for br, bw in raw]
    else:
        cands = _interpret_candidates(family, rows, ext)
    seen, out = set(), []
    for br, bw in cands:
        if (br, bw) in seen:
            continue
        seen.add((br, bw))
        out.append({"block_rows": br, "block_workers": bw})
    return out


def _interpret_candidates(family: str, rows: int, ext: int
                          ) -> list[tuple[int, int]]:
    """The JAX package's interpret-mode candidate lists, by family, with
    its cap on grid steps."""
    if family == "groups":
        raw = [(rows, ext), (rows, 1), (fit_block_rows(rows, BLOCK_ROWS), 1)]
        ext_steps = ext
    elif family == "repair":
        raw = [(rows, 1), (fit_block_rows(rows, 256), 1),
               (fit_block_rows(rows, BLOCK_ROWS), 1)]
        ext_steps = 1
    else:
        raw = [(rows, ext), (rows, 1), (fit_block_rows(rows, BLOCK_ROWS), 1),
               (fit_block_rows(rows, 256), fit_block_workers(ext, 8))]
        ext_steps = ext
    out = []
    for br, bw in raw:
        steps = (rows // br) * (ext_steps // bw if family != "repair"
                                else 1)
        if steps <= _MAX_SWEEP_STEPS_INTERPRET:
            out.append((br, bw))
    return out


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` viewed as signed integers of its width, for a bitwise test."""
    signed = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[x.element_size()]
    return x.view(signed)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(torch.equal(_bits(a), _bits(b))))


def _sweep(kind: str, rows: int, n: int, run_plan: Callable,
           plain: Callable, device, *, reps: int, timer, verify: bool,
           extent: int | None = None, pairs: bool = False,
           record: dict | None = None) -> dict:
    """Time every candidate, store the winner under (kind, rows, n,
    backend) and report the sweep. ``timer(fn) -> µs`` replaces the
    default :func:`_time_us`. ``verify`` checks each candidate's output
    bitwise against the default plan's and the plain twin's, and raises
    on a difference."""
    backend = backend_tag(device)
    cands = _candidate_plans(kind, rows, n, backend, extent=extent,
                             pairs=pairs, sms=_sm_count(device))
    want = plain() if verify else None
    default_out = None
    timings = []
    for plan in cands:
        def fn(p=plan):
            return run_plan(p)
        if verify:
            got = fn()
            for other, what in ((want, "plain twin"),
                                (default_out, "default plan")):
                if other is not None and not _same_bits(got, other):
                    raise RuntimeError(
                        f"{kind} at rows={rows}, n={n}: plan {plan} does "
                        f"not give the {what}'s bits")
            if default_out is None:
                default_out = got
        us = timer(fn) if timer is not None else _time_us(fn, reps, device)
        timings.append({**plan, "us": float(us)})
    best = min(timings, key=lambda r: r["us"])
    _TABLE[(kind, rows, max(1, n), backend)] = {
        "block_rows": best["block_rows"],
        "block_workers": best["block_workers"]}
    _emit_sweep(kind, rows, n, backend, timings, best)
    return {"kind": kind, "rows": rows, "n_workers": n, "backend": backend,
            **(record or {}),
            "default": dict(cands[0]), "verified": bool(verify),
            "best": {k: best[k] for k in ("block_rows", "block_workers")},
            "timings": timings}


def _history(rows: int, n: int, gen: torch.Generator, dev) -> tuple:
    """q (N, rows, 512) and p1/p2 (rows, 512) float32 near one history."""
    q = torch.randn((n, rows, 512), generator=gen, device=dev)
    p1 = torch.randn((rows, 512), generator=gen, device=dev)
    p2 = p1 + 0.5 * torch.randn((rows, 512), generator=gen, device=dev)
    return q, p1, p2


def _scalars(dev, n: int) -> tuple:
    """The round index 2, N thresholds and the pilot index 0 on ``dev``."""
    t = torch.tensor(2, dtype=torch.int32, device=dev)
    beta = torch.full((n,), 0.2, dtype=torch.float32, device=dev)
    return t, beta, torch.tensor(0, dtype=torch.int64, device=dev)


def autotune_stacked(rows: int, n_workers: int, *, device=None,
                     reps: int = 2, seed: int = 0, timer=None,
                     verify: bool = False) -> dict:
    """Timed sweep of the batched uplink's plans for (rows, N); stores the
    winner in the table and returns the sweep's record. ``rows`` is the
    kernel-view row count (flat rows / 4)."""
    from repro_torch.kernels import fused_wire as fw
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, p1, p2 = _history(rows, n_workers, gen, dev)
    t, beta, _ = _scalars(dev, n_workers)

    def run_plan(plan):
        return fw.ternary_pack_stacked(
            q, p1, p2, t, beta, 0.01, block_rows=plan["block_rows"],
            block_workers=plan["block_workers"])

    return _sweep("uplink_stacked", rows, n_workers, run_plan,
                  lambda: fw.ternary_pack_stacked_plain(q, p1, p2, t, beta,
                                                        0.01),
                  dev, reps=reps, timer=timer, verify=verify)


def autotune_master(rows: int, n_workers: int, *, device=None,
                    reps: int = 2, seed: int = 0, timer=None,
                    verify: bool = False) -> dict:
    """Timed sweep of the fused master's plans for (rows, N)."""
    from repro_torch.kernels import fused_wire as fw
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, p1, p2 = _history(rows, n_workers, gen, dev)
    t, _, k = _scalars(dev, n_workers)
    packed = torch.randint(0, 256, (n_workers, rows, 128), generator=gen,
                           device=dev, dtype=torch.uint8)
    w = torch.full((n_workers,), 0.02, dtype=torch.float32, device=dev)

    def run_plan(plan):
        return fw.packed_master_update(
            q, k, packed, w, p1, p2, t, 0.01, block_rows=plan["block_rows"],
            block_workers=plan["block_workers"])

    return _sweep("master", rows, n_workers, run_plan,
                  lambda: fw.packed_master_update_plain(q, k, packed, w, p1,
                                                        p2, t, 0.01),
                  dev, reps=reps, timer=timer, verify=verify)


def _masked_inputs(rows: int, n_workers: int, seed: int, word_bits: int,
                   dev) -> tuple:
    """The masked sweeps' operands: a random history, the round's square
    pair keys and signs and RR keys (so the sweep times the in-kernel
    mask generation), and equal fixed-point weights."""
    from repro_torch.privacy import dp as pdp
    from repro_torch.privacy import masking as pvm
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, p1, p2 = _history(rows, n_workers, gen, dev)
    t, beta, k = _scalars(dev, n_workers)
    keys = pvm.pair_stream_keys(seed, n_workers, 3, device=dev)
    signs = pvm.pair_signs(n_workers, device=dev)
    rrk = pdp.rr_stream_keys(seed + 1, 3, n_workers, device=dev)
    fb = 14 if word_bits == 16 else 24
    wq = torch.full((n_workers,), (1 << fb) // max(n_workers, 1),
                    dtype=torch.int64, device=dev).to(torch.uint32)
    return q, p1, p2, t, beta, k, keys, signs, rrk, wq, gen


def autotune_masked_uplink(rows: int, n_workers: int, *, device=None,
                           reps: int = 2, seed: int = 0,
                           word_bits: int = 32, timer=None,
                           verify: bool = False) -> dict:
    """Timed sweep of the masked uplink's plans for (rows, N) at one wire
    modulus (kind ``uplink_masked16``/``uplink_masked``): the pair kernel
    up to ``PAIR_MAX_WORKERS`` workers and the tile kernel up to
    ``COHORT_MAX_WORKERS`` (one plan each), the row fold beyond."""
    from repro_torch.kernels import masked_wire as mw
    dev = resolve_device(device)
    q, p1, p2, t, beta, _, keys, signs, rrk, wq, _ = _masked_inputs(
        rows, n_workers, seed, word_bits, dev)

    def run_plan(plan):
        return mw.ternary_pack_masked(
            q, p1, p2, t, beta, 0.01, wq, keys, signs, rrk,
            word_bits=word_bits, block_rows=plan["block_rows"],
            block_workers=plan["block_workers"])

    def plain():
        return mw.ternary_pack_masked_plain(q, p1, p2, t, beta, 0.01, wq,
                                            keys, signs, rrk,
                                            word_bits=word_bits)

    kind = "uplink_masked16" if word_bits == 16 else "uplink_masked"
    return _sweep(kind, rows, n_workers, run_plan, plain, dev, reps=reps,
                  timer=timer, verify=verify,
                  pairs=mw.uses_pair_kernel(n_workers, n_workers))


def autotune_masked_master(rows: int, n_workers: int, *, device=None,
                           reps: int = 2, seed: int = 0,
                           word_bits: int = 32, timer=None,
                           verify: bool = False) -> dict:
    """Timed sweep of the sum-then-unmask master's plans for (rows, N) at
    one wire modulus."""
    from repro_torch.kernels import masked_wire as mw
    dev = resolve_device(device)
    q, p1, p2, t, _, k, _, _, _, wq, gen = _masked_inputs(
        rows, n_workers, seed, word_bits, dev)
    word = torch.int16 if word_bits == 16 else torch.int32
    unsigned = torch.uint16 if word_bits == 16 else torch.uint32
    masked = torch.randint(-(1 << (word_bits - 1)), 1 << (word_bits - 1),
                           (n_workers, rows, 512), generator=gen,
                           device=dev, dtype=torch.int64
                           ).to(word).view(unsigned)
    sum_wq = wq.to(torch.int64).sum().to(torch.uint32)
    scale = 2.0 ** -(14 if word_bits == 16 else 24)

    def run_plan(plan):
        return mw.masked_master_update(
            q, k, masked, sum_wq, p1, p2, t, 0.01, scale,
            block_rows=plan["block_rows"],
            block_workers=plan["block_workers"])

    kind = "master_masked16" if word_bits == 16 else "master_masked"
    return _sweep(kind, rows, n_workers, run_plan,
                  lambda: mw.masked_master_update_plain(
                      q, k, masked, sum_wq, p1, p2, t, 0.01, scale),
                  dev, reps=reps, timer=timer, verify=verify)


def autotune_partial_sum(rows: int, fanout: int, n_children: int, *,
                         device=None, reps: int = 2, seed: int = 0,
                         word_bits: int = 32, masked: bool = False,
                         timer=None, verify: bool = False) -> dict:
    """Timed sweep of the tree sub-aggregate's plans for (rows, fanout)
    over one level of ``n_children`` children (a ragged last group
    included); fills the ``partial_sum*`` kind picked by
    ``masked``/``word_bits``. The key holds the fanout in the n_workers
    slot, and ``block_workers`` means output groups a CTA."""
    from repro_torch.kernels import partial_sum as psk
    from repro_torch.privacy import masking as pvm
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = cdiv(n_children, fanout)
    if masked:
        kind = ("partial_sum_masked16" if word_bits == 16
                else "partial_sum_masked")
        word = torch.int16 if word_bits == 16 else torch.int32
        unsigned = torch.uint16 if word_bits == 16 else torch.uint32
        y = torch.randint(-(1 << (word_bits - 1)), 1 << (word_bits - 1),
                          (n_children, rows, 512), generator=gen,
                          device=dev, dtype=torch.int64
                          ).to(word).view(unsigned)
        keys = pvm.pair_stream_keys(seed, g, 3, device=dev)
        sib = max(1, min(g, fanout))
        signs = pvm.tree_pair_signs(g, sib, device=dev)

        def run_plan(plan):
            return psk.masked_partial_sum(
                y, keys, signs, fanout=fanout, sibling=sib,
                block_rows=plan["block_rows"],
                block_groups=plan["block_workers"])

        def plain():
            return psk.masked_partial_sum_plain(y, keys, signs,
                                                fanout=fanout, sibling=sib)
    else:
        kind = "partial_sum"
        packed = torch.randint(0, 256, (n_children, rows, 128),
                               generator=gen, device=dev,
                               dtype=torch.uint8)
        fb = 14 if word_bits == 16 else 24
        wq = torch.full((n_children,), (1 << fb) // n_children,
                        dtype=torch.int64, device=dev).to(torch.uint32)

        def run_plan(plan):
            return psk.partial_sum(packed, wq, fanout=fanout,
                                   word_bits=word_bits,
                                   block_rows=plan["block_rows"],
                                   block_groups=plan["block_workers"])

        def plain():
            return psk.partial_sum_plain(packed, wq, fanout=fanout,
                                         word_bits=word_bits)

    return _sweep(kind, rows, fanout, run_plan, plain, dev, reps=reps,
                  timer=timer, verify=verify, extent=g,
                  record={"n_children": n_children})


def autotune_mask_repair(rows: int, n_pairs: int, *, device=None,
                         reps: int = 2, seed: int = 0, word_bits: int = 32,
                         timer=None, verify: bool = False) -> dict:
    """Timed sweep of the dropout repair's plans for (rows, P pairs) at
    one wire modulus, keyed with n_workers=1 (it has no worker axis).
    Every other coefficient is zero, so the sweep times the in-kernel
    skip of dead pairs a faulted round takes."""
    from repro_torch.kernels import masked_wire as mw
    from repro_torch.privacy import masking as pvm
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    word = torch.int16 if word_bits == 16 else torch.int32
    unsigned = torch.uint16 if word_bits == 16 else torch.uint32
    y = torch.randint(-(1 << (word_bits - 1)), 1 << (word_bits - 1),
                      (rows, 512), generator=gen, device=dev,
                      dtype=torch.int64).to(word).view(unsigned)
    p = max(1, n_pairs)
    keys = pvm.stream_key(seed, torch.arange(p, device=dev), 3)
    coeff = (torch.arange(p, device=dev) % 2 == 0).to(torch.int32)

    def run_plan(plan):
        return mw.mask_repair(y, keys, coeff, block_rows=plan["block_rows"])

    kind = "mask_repair16" if word_bits == 16 else "mask_repair"
    return _sweep(kind, rows, 1, run_plan,
                  lambda: mw.mask_repair_plain(y, keys, coeff), dev,
                  reps=reps, timer=timer, verify=verify,
                  record={"n_pairs": n_pairs})


def save_table(path: str) -> None:
    """Write the table as JSON ({'kind|rows|n|backend': plan})."""
    data = {"|".join(map(str, k)): v for k, v in sorted(_TABLE.items())}
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)


def load_table(path: str, *, replace: bool = False) -> int:
    """Merge (or replace) the table from a ``save_table`` JSON; returns
    the number of entries loaded."""
    with open(path) as f:
        data = json.load(f)
    if replace:
        _TABLE.clear()
    for key, plan in data.items():
        kind, rows, n, backend = key.split("|")
        _TABLE[(kind, int(rows), int(n), backend)] = {
            "block_rows": int(plan["block_rows"]),
            "block_workers": int(plan["block_workers"])}
    return len(data)


_env_table = os.environ.get("REPRO_TUNE_TABLE")
if _env_table and os.path.exists(_env_table):
    load_table(_env_table)
