#!/usr/bin/env python3
"""Run the distributed runtime's (4, 1) mesh under each
``torch.distributed`` backend, one card a rank, and check that the
backends agree; with ``--arch``, train that config's fed workers
tensor-parallel on an (F, M) mesh under each backend.

    python3 bench_torch/mesh_backends.py [--backends nccl gloo] [--cpu]
    python3 bench_torch/mesh_backends.py --mesh 2 2 --arch qwen3-14b \
        --layers 2 [--backends nccl gloo] [--cpu]

It builds the kernels first (``chip_smoke.phase_build``), then runs
``chip_smoke.py``'s distributed slice on the (4, 1) mesh once a backend
(``chip_smoke._dist_run``: four spawned ranks, rank r on card r, every
sync of ``_dist_cases(4, 1)`` at rounds 1 and 3 under sync-debug
"error", the checks one rank makes). Under NCCL nothing in a round may
make the host wait, collectives included (each sync runs once first,
unchecked, to make the communicators); under gloo the staged calls lift
the check for their own duration. Prints, a backend and a sync, the
round and transport times with the transport's calls, staged calls and
bytes, then whether the backends' new models agree: bitwise for every
sync but ``fedpc_reduce`` and ``fedavg`` (float sums in the backend's
order), which are only reported. Prints the card's name and power limit,
and exits non-zero if a rank fails or an exact sync differs. ``--cpu``
rehearses it with gloo ranks on the CPU at a small width.

With ``--arch`` (the model axis): the config at its published widths in
bfloat16 (momentum in bfloat16), cut to ``--layers`` layers (the only
cut), through ``build_fed_step`` on the (F, M) mesh, one card a rank
(``chip_smoke._axis_run``): ``--strategies`` (by default
``fedpc_packed``, ``fedpc``, ``fedpc_reduce`` and ``fedavg``; at the
published widths of ``qwen3-14b`` the last three's plain-PyTorch wire
does not fit beside the model), 2 rounds of one local step each, every
round under sync-debug "error" (under gloo the staged calls lift it for
their own duration; under NCCL an unchecked round first makes the
communicators). Prints, a backend and a strategy, each round's ms, each
rank's peak allocated bytes beside the fed dry run's peak for the same
config and mesh (``launch.dryrun --fed fedpc_packed --mesh FxM``), and
the model axis's ring bytes a round beside the dry run's count; then
whether the backends' new models agree: bitwise for the exact wire
strategies, ``fedpc_reduce`` within the f16 bound of ``fedpc`` that
``chip_smoke._dist_checks`` holds a sync to, in each run, ``fedavg``
reported. ``--cpu --reduced`` rehearses it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

F, M = 4, 1
SUMMED = ("fedpc_reduce", "fedavg")
AXIS_STRATEGIES = ("fedpc_packed", "fedpc", "fedpc_reduce", "fedavg")
AXIS_TIMEOUT = 1200               # seconds a backend's ranks may take
AXIS_BATCH = 2                    # sequences a local step, a worker


def _model_axis(args, devices: tuple, card: str) -> int:
    """The ``--arch`` run (the module docstring's second part)."""
    F, M = args.mesh
    job = dict(cs.AXIS_JOB, archs=(args.arch,), full=not args.reduced,
               layers=args.layers, dtype="bfloat16",
               strategies=tuple(args.strategies), rounds=2, local_steps=1,
               batch=AXIS_BATCH, seq_len=args.seq, lr=0.01, save=False,
               count=False)
    digests, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        counting = cs._axis_counts(tmp, job, (F, M))
        try:
            for i, backend in enumerate(args.backends):
                out = f"{tmp}/{i}"
                Path(out).mkdir()
                t0 = time.perf_counter()
                reports = cs._axis_run(F, M, out, backend, devices, job,
                                       timeout=AXIS_TIMEOUT)
                print(f"{backend}: {F}x{M} mesh, {args.arch} in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                for strategy in args.strategies:
                    key = f"{args.arch}/{strategy}"
                    rounds = [rep[key]["rounds"] for rep in reports]
                    first = rounds[0]
                    peaks = [max(rr["peak"] for rr in rs) for rs in rounds]
                    print(f"{backend} {strategy}: round ms rank 0 "
                          f"{' / '.join(f'{rr['ms']:.1f}' for rr in first)}"
                          f"; peak bytes a rank {peaks}; model axis "
                          f"{first[-1]['moved'].get('model', 0):,.0f} B a "
                          f"rank ({first[-1]['dtensor']['calls']} DTensor "
                          f"calls {first[-1]['dtensor']['kinds']}, "
                          f"{first[-1]['dtensor']['seconds'] * 1e3:.1f} ms "
                          f"on the host); fed axis "
                          f"{first[-1]['moved'].get('data', 0):,.0f} B; "
                          f"pilots {[rr['k_star'] for rr in first]}; costs "
                          f"{[round(rr['cost'], 5) for rr in first]}; "
                          f"launches {first[-1]['launches']}", flush=True)
                    digests.setdefault(strategy, {})[backend] = [
                        rr["digest"] for rr in first]
                    for same_round in zip(*rounds):   # every rank's
                        ok &= len({rr["digest"] for rr in same_round}) == 1
                worst = reports[0].get(f"{args.arch}/reduce_off")
                if worst:
                    print(f"{backend} fedpc_reduce off fedpc by "
                          f"{worst[0]:.3g}, within its f16 bound "
                          f"{worst[1]:.3g}", flush=True)
                first = reports[0][f"{args.arch}/{args.strategies[0]}"]
                print(f"{backend} local bytes a rank: params "
                      f"{first['params_bytes']}, optimizer state "
                      f"{first['opt_bytes']} (local, param_specs', whole)",
                      flush=True)
        except cs.SmokeError as exc:
            print(f"FAIL: {exc}", file=sys.stderr)
            return 1
        rec = cs._axis_counted(tmp, counting)[args.arch]
    by_axis = rec["collectives"]["bytes_by_axis"]
    print(f"fed dry run, the same config and mesh (fedpc_packed, one local "
          f"step): peak {rec['memory']['peak_size_in_bytes']:,} B a device, "
          f"model axis {by_axis.get('model', 0):,.0f} B, fed axis "
          f"{by_axis.get('data', 0):,.0f} B", flush=True)
    for strategy, by in digests.items():
        same = len({tuple(d) for d in by.values()}) == 1
        exact = strategy not in SUMMED
        print(f"agree {strategy}: {'bitwise' if same else 'differ'}"
              f"{'' if exact else ' (float sums in the backend order)'}",
              flush=True)
        ok &= same or not exact
    print(json.dumps({"card": card, "mesh": [F, M], "arch": args.arch,
                      "layers": args.layers, "agree": ok}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backends", nargs="+", default=["nccl", "gloo"],
                    choices=("nccl", "gloo"))
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU at a small width")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("F", "M"), help="the mesh (default 4 1; 2 2 "
                                             "with --arch)")
    ap.add_argument("--arch", default=None,
                    help="train this config tensor-parallel (the model "
                         "axis) instead of the sync cases")
    ap.add_argument("--layers", type=int, default=2,
                    help="--arch: the depth it is cut to")
    ap.add_argument("--reduced", action="store_true",
                    help="--arch: its reduced widths (a rehearsal)")
    ap.add_argument("--strategies", nargs="+", default=AXIS_STRATEGIES,
                    choices=AXIS_STRATEGIES,
                    help="--arch: the wire strategies, each its own rounds")
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    import torch
    args.mesh = tuple(args.mesh or ((2, 2) if args.arch else (F, M)))
    n = args.mesh[0] * args.mesh[1]
    if args.arch is None and args.mesh != (F, M):
        ap.error("the sync cases run on the (4, 1) mesh; --mesh needs "
                 "--arch")
    if args.cpu:
        cs.N_FEATURES, cs.N_CLASSES, cs.HIDDEN = 24, 6, (16, 8)
        devices = ("cpu",) * n
        card = "cpu (rehearsal width)"
    else:
        if not torch.cuda.is_available():
            print("FAIL: CUDA is not available", file=sys.stderr)
            return 1
        if torch.cuda.device_count() < n:
            print(f"FAIL: {n} ranks need {n} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 1
        devices = tuple(f"cuda:{r}" for r in range(n))
        cs.phase_build()           # the ranks load the built libraries
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", " | ")
    print(card, flush=True)
    if args.arch:
        return _model_axis(args, devices, card)
    digests = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for i, backend in enumerate(args.backends):
                out = f"{tmp}/{i}"
                Path(out).mkdir()
                t0 = time.perf_counter()
                reports = cs._dist_run(F, M, out, backend, devices)
                _, _, lines, sync_s = cs._dist_report(F, M, reports,
                                                      f"{backend} {F}x{M}")
                print(f"{backend}: {F}x{M} mesh in "
                      f"{time.perf_counter() - t0:.1f} s, the syncs "
                      f"{sync_s:.1f} s of it", flush=True)
                for line in lines:
                    print(line, flush=True)
                digests[backend] = reports[0]["digests"]
    except cs.SmokeError as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1
    ok = True
    first = digests[args.backends[0]]
    for key in first:
        same = len({d[key] for d in digests.values()}) == 1
        exact = key.rsplit("_t", 1)[0] not in SUMMED
        print(f"agree {key}: {'bitwise' if same else 'differ'}"
              f"{'' if exact else ' (float sums in the backend order)'}",
              flush=True)
        ok &= same or not exact
    print(json.dumps({"card": card, "mesh": [F, M], "agree": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
