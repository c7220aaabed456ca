#!/usr/bin/env python3
"""Time what the model axis's dispatch mode costs a local training step.

    python3 bench_torch/model_transport_cost.py [--cpu]

Inside ``fed.collectives.model_transport`` a ``TorchDispatchMode`` sees
every op of a tensor-parallel worker's local training: under gloo it runs
the model group's collectives on pinned host copies, under NCCL it only
books their bytes and passes every op on, in Python. This script measures
that pass-through on one card: ``qwen3-14b`` at its published widths in
bfloat16 (momentum in bfloat16), cut to 2 layers (the four-card call's
config), one ``model.train_step`` on a batch of 2 x 256 tokens (that
call's shape) on plain tensors, timed with and without the mode of a
one-rank NCCL model group entered, in the order A B B A, 8 times each
after two warm-up steps each way. Prints the card's name and power limit, each
way's median ms, the ops one step dispatches, and the mode's cost per op.
A tensor-parallel step dispatches these ops on its local shards, plus
DTensor's own, so the cost per op carries over; the NCCL round itself is
not timed here. ``--cpu`` rehearses it with gloo on the CPU at reduced
widths.
"""
from __future__ import annotations

import argparse
import json
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ARCH, LAYERS = "qwen3-14b", 2
BATCH, SEQ = 2, 256
REPS, WARMUP = 8, 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU at reduced widths")
    args = ap.parse_args()
    import torch
    import torch.distributed as dist
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.fed import collectives as col
    from repro_torch.launch.mesh import make_debug_mesh
    if args.cpu:
        dev, backend, card = torch.device("cpu"), "gloo", "cpu (rehearsal)"
    else:
        if not torch.cuda.is_available():
            print("FAIL: CUDA is not available", file=sys.stderr)
            return 1
        dev, backend = torch.device("cuda", 0), "nccl"
        torch.cuda.set_device(dev)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        axis = make_debug_mesh(1, 1).axes["model"]
        cfg, m = cs._axis_model(torch, ARCH, dict(
            full=not args.cpu, layers=LAYERS, dtype="bfloat16"))
        params = m.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
        opt = m.optimizer.init(params)
        batch = {"tokens": torch.randint(
            0, cfg.vocab, (BATCH, SEQ), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))}
        state = [params, opt]

        def step(mode) -> float:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode is None:
                p, o, _ = m.train_step(*state, batch, 0.01)
            else:
                with mode:
                    p, o, _ = m.train_step(*state, batch, 0.01)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            state[:] = [p, o]
            return (time.perf_counter() - t0) * 1e3

        class Count(TorchDispatchMode):
            ops = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                Count.ops += 1
                return func(*args, **(kwargs or {}))

        step(Count())
        for _ in range(WARMUP):
            step(None)
            step(col._transport_mode(axis))
        times = {"without": [], "with": []}
        for _ in range(REPS // 2):
            for way in ("without", "with", "with", "without"):
                times[way].append(step(
                    col._transport_mode(axis) if way == "with" else None))
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"{ARCH} at {'reduced' if args.cpu else 'published'} "
              f"widths, {LAYERS} layers, bf16, one train_step of "
              f"{BATCH} x {SEQ} tokens on {card}: median "
              f"{med['without']:.3f} ms without the mode, "
              f"{med['with']:.3f} ms with it (each of {REPS}); "
              f"{Count.ops} ops a step; the mode "
              f"{(med['with'] - med['without']) * 1e3 / Count.ops:.2f} us "
              f"an op", flush=True)
        print(json.dumps({"card": card, "arch": ARCH,
                          "layers": LAYERS, "ops": Count.ops,
                          "ms": med, "all_ms": times}))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
