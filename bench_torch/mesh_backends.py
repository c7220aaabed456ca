#!/usr/bin/env python3
"""Run the distributed runtime's (4, 1) mesh under each
``torch.distributed`` backend, one card a rank, and check that the
backends agree.

    python3 bench_torch/mesh_backends.py [--backends nccl gloo] [--cpu]

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backends", nargs="+", default=["nccl", "gloo"],
                    choices=("nccl", "gloo"))
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU at a small width")
    args = ap.parse_args()
    import torch
    if args.cpu:
        cs.N_FEATURES, cs.N_CLASSES, cs.HIDDEN = 24, 6, (16, 8)
        devices = ("cpu",) * (F * M)
        card = "cpu (rehearsal width)"
    else:
        if not torch.cuda.is_available():
            print("FAIL: CUDA is not available", file=sys.stderr)
            return 1
        if torch.cuda.device_count() < F * M:
            print(f"FAIL: {F * M} ranks need {F * M} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 1
        devices = tuple(f"cuda:{r}" for r in range(F * M))
        cs.phase_build()           # the ranks load the built libraries
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", " | ")
    print(card, flush=True)
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
