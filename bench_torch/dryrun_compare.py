#!/usr/bin/env python3
"""Run every dry-run combo of a tree and compare two trees' records.

    python3 bench_torch/dryrun_compare.py --src build/parent/src --out A
    python3 bench_torch/dryrun_compare.py --src src --out B --against A

Each (architecture, input shape) on the single-pod and the multi-pod
mesh runs as its own ``repro_torch.launch.dryrun`` process of the tree
under ``--src`` (``JOBS`` at a time, each with one thread), its record
written to ``OUT/<arch>_<shape>_<0|1>.json``. With ``--against`` each
record is set beside the other tree's of the same combo: the statuses,
and whether the counts (memory, collectives, loop trips) are the same,
with the error of a combo that fails and the replicated ops where they
differ. Prints the torch version and a count of ok / fail / skipped a
tree, and exits non-zero if a combo the other tree passes fails here or
a combo both pass counts differently. To compare two trees on one
torch, run both in one call.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ARCHS = ("mistral-nemo-12b", "mistral-large-123b", "grok-1-314b",
         "jamba-1.5-large-398b", "phi4-mini-3.8b", "deepseek-moe-16b",
         "xlstm-350m", "whisper-medium", "qwen2-vl-7b", "qwen3-14b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
KEYS = ("status", "memory", "collectives", "loop_trip_counts")
TIMEOUT = 900                     # seconds a combo may take
JOBS = 8                          # combos at a time


def run_all(src: str, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src),
               OMP_NUM_THREADS="1")

    def one(combo):
        arch, shape, multi = combo
        name = f"{out}/{arch}_{shape}_{int(multi)}"
        with open(name + ".log", "w") as log:
            subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--arch", arch, "--shape", shape,
                            *(["--multi-pod"] if multi else []),
                            "--out", name + ".json"], env=env, stdout=log,
                           stderr=subprocess.STDOUT, timeout=TIMEOUT)

    combos = [(a, s, m) for a in ARCHS for s in SHAPES for m in (False, True)]
    with ThreadPoolExecutor(JOBS) as pool:
        list(pool.map(one, combos))


def _record(path: str) -> dict:
    if not os.path.exists(path):
        return {"status": "missing"}
    return json.loads(Path(path).read_text())[-1]


def compare(out: str, against: str) -> bool:
    ok = True
    for path in sorted(glob.glob(f"{out}/*.json")):
        name = os.path.basename(path)[:-5]
        b, a = _record(path), _record(f"{against}/{name}.json")
        same = all(a.get(k) == b.get(k) for k in KEYS)
        line = (f"{name:42s} other {a['status']:8s} this {b['status']:8s} "
                f"counts {'same' if same else 'DIFFER'}")
        if b["status"] == "fail":
            line += " | " + b.get("error", "")[:200].replace("\n", " ")
        if a.get("replicated_ops") != b.get("replicated_ops"):
            line += f" | ops {b.get('replicated_ops')}"
        print(line, flush=True)
        ok &= not (a["status"] == "ok" and b["status"] != "ok")
        ok &= not (a["status"] == b["status"] == "ok" and not same)
    return ok


def _tally(out: str) -> dict:
    recs = [_record(p) for p in glob.glob(f"{out}/*.json")]
    return {s: sum(r["status"] == s for r in recs)
            for s in ("ok", "fail", "skipped")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="src", help="the tree's src directory")
    ap.add_argument("--out", required=True, help="where the records go")
    ap.add_argument("--against", default=None,
                    help="another tree's records to compare with")
    ap.add_argument("--no-run", action="store_true",
                    help="compare records already in --out")
    args = ap.parse_args()
    import torch
    print(f"torch {torch.__version__}", flush=True)
    if not args.no_run:
        t0 = time.perf_counter()
        run_all(args.src, args.out)
        print(f"{args.src}: every combo in {time.perf_counter() - t0:.1f} s",
              flush=True)
    ok = compare(args.out, args.against) if args.against else True
    print(json.dumps({"this": _tally(args.out), **(
        {"other": _tally(args.against)} if args.against else {}),
        "agree": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
