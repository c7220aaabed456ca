#!/usr/bin/env python3
"""Time one round of local training of the PyTorch/CUDA port's simulator
federation at full width, on one CUDA card.

    python3 bench_torch/local_training.py [--src DIR] [--rounds R] [--forms]
                                          [--json PATH]

The federation is ``chip_smoke.py``'s: the MLP 3072→4096→2048→10
(20,998,154 params), 10 workers, 10,240 synthetic samples, worker and
loader draws from seed 0, in two splits: ``ragged``, the random shares of
the plain slice (419 to 1,579 samples a worker), and ``uniform``, 1,024
samples a worker in equal contiguous shards (the scan slice). Each round
every worker runs ``Worker.train_round_device`` from the same global
params, one after another, and the round is timed between two
``torch.cuda.synchronize()``; the first round is reported apart, as it
captures a worker's CUDA graph where the tree has one. Where the tree has
``Worker.train_round_eager`` (the per-batch loop), it is timed too on
the uniform shards.

``--forms`` instead times four forms of one worker's round of local
training on the uniform shards, in turns, three times each (after a
pass that warms up), for worker 0 and worker 1: ``host``, the per-batch
loop fed from host memory (each batch copied from pageable memory,
which waits for the device every step: the loop before
``Worker.train_round_eager``); ``device``, the same loop fed from the
shard on the device with no sync; ``device_sync``, that loop with a
``torch.cuda.synchronize()`` after every step; and ``graph``,
``Worker.train_round_device`` where the tree graphs it. Then one round
of ``host`` and of ``device`` under ``torch.profiler``: the summed
device time of its kernels and the five kernels that take the most.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two trees, for example a parent
commit unpacked with ``git archive``, can be timed in turns in one
call. Prints the card's name and power limit and one JSON object;
``--json`` also writes it to a file. Needs CUDA: it exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
N_WORKERS = 10
SHARD = 1024
N_FEATURES, N_CLASSES, HIDDEN = 3072, 10, (4096, 2048)


def federation(torch, split: str, dev):
    import numpy as np

    from repro_torch.data.pipeline import federated_loaders
    from repro_torch.data.synthetic import (SyntheticClassification,
                                            random_share_split)
    from repro_torch.fed.worker import Worker, make_worker_configs
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_and_grad
    x, y = SyntheticClassification(n_samples=N_WORKERS * SHARD,
                                   n_features=N_FEATURES,
                                   n_classes=N_CLASSES, seed=SEED).generate()
    if split == "ragged":
        splits = random_share_split(y, n_workers=N_WORKERS, seed=SEED + 1)
    else:
        splits = [np.arange(k * SHARD, (k + 1) * SHARD)
                  for k in range(N_WORKERS)]
    loaders = federated_loaders((x, y), splits, seed=SEED + 2)
    cfgs = make_worker_configs(N_WORKERS, [len(s) for s in splits],
                               seed=SEED + 3)
    workers = [Worker(cfg=cfgs[k], loader=loaders[k],
                      loss_and_grad=mlp_loss_and_grad)
               for k in range(N_WORKERS)]
    params = init_mlp_classifier(torch.Generator().manual_seed(SEED),
                                 N_FEATURES, N_CLASSES, HIDDEN, device=dev)
    return workers, params


def rounds_ms(torch, workers, params, rounds: int, method: str) -> list:
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in workers:
            getattr(w, method)(params)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def eager_round(torch, w, params, dev, feed: str, sync: bool = False):
    """One round of the per-batch loop from ``params``, the worker's own
    loader and optimizer state; ``feed`` ``host`` copies each batch from
    host memory, ``device`` gathers it from the shard on the device."""
    from repro_torch.optim import optimizers as opt_mod
    if w.opt_state is None:
        w.opt_state = w.opt.init(params)
    shard = tuple(torch.from_numpy(a).to(dev) for a in w.loader.arrays)
    for _ in range(w.cfg.local_epochs):
        for sel in w.loader.epoch_indices():
            if feed == "host":
                batch = tuple(torch.from_numpy(a[sel]).to(dev)
                              for a in w.loader.arrays)
            else:
                idx = torch.from_numpy(sel).to(dev, non_blocking=True)
                batch = tuple(a.index_select(0, idx) for a in shard)
            lr = float(w.lr_fn(w.step))
            (_loss, _aux), grads = w.loss_and_grad(params, batch)
            updates, w.opt_state = w.opt.update(grads, w.opt_state, params,
                                                lr)
            params = opt_mod.apply_updates(params, updates)
            w.step += 1
            if sync:
                torch.cuda.synchronize()
    return params


def forms(torch, dev) -> dict:
    """The ``--forms`` timings of workers 0 and 1 (module docstring)."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for k in (0, 1):
        workers, params = federation(torch, "uniform", dev)
        w = workers[k]
        runs = {
            "host": lambda: eager_round(torch, w, params, dev, "host"),
            "device": lambda: eager_round(torch, w, params, dev, "device"),
            "device_sync": lambda: eager_round(torch, w, params, dev,
                                               "device", sync=True),
        }
        if hasattr(w, "scan_train"):
            runs["graph"] = lambda: w.train_round_device(params)
        times: dict = {name: [] for name in runs}
        for _ in range(4):
            for name, fn in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        steps = w.cfg.local_epochs * w.loader.steps_per_epoch()
        label = (f"worker {k} ({w.cfg.optimizer}, batch "
                 f"{w.loader.batch_size}, {steps} steps)")
        res = {name: ms[1:] for name, ms in times.items()}
        for name in ("host", "device"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                runs[name]()
                torch.cuda.synchronize()
            ev = prof.key_averages()
            top = sorted(ev, key=lambda e: -e.self_device_time_total)[:5]
            res[f"{name}_profile"] = {
                "kernels_ms": sum(e.self_device_time_total for e in ev) / 1e3,
                "top": [(e.key[:60], round(e.self_device_time_total / 1e3,
                                            3), e.count) for e in top]}
        out[label] = res
        print(f"{label}: " + "; ".join(
            f"{n} {[round(x, 1) for x in ms]} ms" for n, ms in res.items()
            if not n.endswith("profile")), flush=True)
        for name in ("host", "device"):
            pr = res[f"{name}_profile"]
            print(f"  {name} under the profiler: kernels "
                  f"{pr['kernels_ms']:.1f} ms of device time; top "
                  f"{pr['top']}", flush=True)
        del workers, params, w, runs
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", default=None)
    ap.add_argument("--forms", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import gc

    import torch
    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    from repro_torch.fed.worker import Worker
    result = {"src": args.src, "card": card}
    runs = [("ragged", "train_round_device"),
            ("uniform", "train_round_device")]
    if hasattr(Worker, "train_round_eager"):
        runs.append(("uniform", "train_round_eager"))
    if args.forms:
        result["forms"] = forms(torch, dev)
        runs = []
    for split, method in runs:
        workers, params = federation(torch, split, dev)
        ms = rounds_ms(torch, workers, params, args.rounds, method)
        steps = sum(w.step for w in workers) // args.rounds
        key = f"{split}_{method}"
        result[key] = {"first_ms": ms[0], "later_ms": ms[1:],
                       "steps_a_round": steps}
        print(f"{key}: first round {ms[0]:.1f} ms, later rounds "
              f"{[round(m, 1) for m in ms[1:]]} ms, {steps} steps a round",
              flush=True)
        del workers, params
        gc.collect()
        torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line, flush=True)
    if args.json:
        Path(args.json).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
