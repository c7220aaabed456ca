#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero and prints no
result:

1. card   — requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build  — builds the kernels of the path from ``src/repro_torch/
   kernels/csrc/fused_wire.cu`` with ``nvcc``.
3. check  — each kernel against its plain PyTorch version on the card,
   bitwise, at both round branches, at the main-path shape (N = 10
   workers, R = rows/4 = 41,016) and at odd shapes (N ∈ {1, 3}, R = 8).
4. slice  — ``FedSimulator.run_fedpc``: 3 rounds, 10 workers, the MLP
   3072→4096→2048→10 (20,998,154 params, CIFAR-10 input width) on
   synthetic data, ~1,024 samples per worker. Every launch counter is set
   to 0 just before and must read 3 just after (one uplink and one master
   launch per round); ``round_step`` runs under
   ``torch.cuda.set_sync_debug_mode("error")``; costs must be finite and
   bytes per round equal Eq. (8). A quickstart-size federation then runs
   on the card and on the CPU (plain versions) and must pick the same
   pilots.
5. times  — each kernel and its plain version with CUDA events at the
   main-path shape (median of 25), beside the device-memory bound; the
   uplink also at round 1 (no P^{t-2} read), and the round's whole wire
   (``WirePath.round_from_stacked``) beside the sum of its two kernels.

The line before the last is one JSON object with every kernel's numbers;
the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
N_WORKERS = 10
ROUNDS = 3
HIDDEN = (4096, 2048)
N_FEATURES, N_CLASSES = 3072, 10
N_PARAMS = 20_998_154
ROWS = 164_064
REPEATS = 25
FP32_OPS_PER_S = 67e12            # H100 SXM, float32 outside tensor cores
# Device-memory rate by card name (NVIDIA data sheets), first match wins.
MEM_RATES = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def phase_card(torch) -> tuple[str, int, float]:
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    name = torch.cuda.get_device_name(0)
    rate = next((r for key, r in MEM_RATES if key in name), MEM_RATES[-1][1])
    print(f"card: {name}, count {torch.cuda.device_count()}, "
          f"memory rate used for bounds {rate / 1e12:.2f} TB/s", flush=True)
    return name, torch.cuda.device_count(), rate


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    so = build.build("fused_wire")
    dt = time.perf_counter() - t0
    log = so.with_name(so.name + ".log")
    usage = [line.strip() for line in (log.read_text().splitlines()
                                       if log.exists() else [])
             if "registers" in line or "spill" in line]
    print(f"build: fused_wire in {dt:.1f} s -> {so.name}; "
          + " | ".join(usage), flush=True)


def _inputs(torch, n: int, r: int, gen, dev):
    """Worker views near a shared history, as a round sees them; the last
    worker is the pilot, whose weight is zero."""
    p1 = torch.randn((r, 512), generator=gen, device=dev) * 0.05
    p2 = p1 + torch.randn((r, 512), generator=gen, device=dev) * 0.01
    q = p1 + torch.randn((n, r, 512), generator=gen, device=dev) * 0.01
    beta = torch.rand((n,), generator=gen, device=dev) * 0.3
    w = torch.rand((n,), generator=gen, device=dev) / n
    w[n - 1] = 0.0
    k = torch.tensor(n - 1, device=dev)
    return q, p1, p2, beta, w, k


def phase_check(torch, dev) -> dict:
    """Each kernel against its plain version, bitwise. Returns the largest
    absolute difference per kernel at the main-path shape."""
    from repro_torch.kernels import fused_wire as fw
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"uplink_stacked": 0.0, "master": 0.0}
    lines = []
    for n, r in ((N_WORKERS, ROWS // 4), (1, 8), (3, 8)):
        q, p1, p2, beta, w, k = _inputs(torch, n, r, gen, dev)
        for t in (1, 2):
            tt = torch.tensor(t, dtype=torch.int32, device=dev)
            packed = fw.ternary_pack_stacked(q, p1, p2, tt, beta, 0.01)
            plain = fw.ternary_pack_stacked_plain(q, p1, p2, tt, beta, 0.01)
            up_err = float((packed.int() - plain.int()).abs().max())
            out = fw.packed_master_update(q, k, packed, w, p1, p2, tt, 0.01)
            ref = fw.packed_master_update_plain(q, k, packed, w, p1, p2, tt,
                                                0.01)
            torch.cuda.synchronize()
            ma_err = float((out - ref).abs().max())
            up_ok = torch.equal(packed, plain)
            ma_ok = torch.equal(out.view(torch.int32), ref.view(torch.int32))
            lines.append(f"N={n} R={r} t={t}: uplink "
                         f"{'bitwise' if up_ok else 'DIFFERS'}, master "
                         f"{'bitwise' if ma_ok else 'DIFFERS'}")
            check(up_ok, f"uplink differs from plain at N={n} R={r} t={t}")
            check(ma_ok, f"master differs from plain at N={n} R={r} t={t}")
            check(bool(torch.isfinite(out).all()), "master output not finite")
            if (n, r) == (N_WORKERS, ROWS // 4):
                errs["uplink_stacked"] = max(errs["uplink_stacked"], up_err)
                errs["master"] = max(errs["master"], ma_err)
        del q, p1, p2, packed, plain, out, ref
    print("kernels: " + "; ".join(lines), flush=True)
    return errs


def _federation(n_workers, n_samples, n_features, n_classes, seed):
    from repro_torch.data.pipeline import federated_loaders
    from repro_torch.data.synthetic import (SyntheticClassification,
                                            random_share_split)
    from repro_torch.fed.worker import Worker, make_worker_configs
    from repro_torch.models.mlp import mlp_loss_and_grad
    x, y = SyntheticClassification(n_samples=n_samples,
                                   n_features=n_features,
                                   n_classes=n_classes,
                                   seed=seed).generate()
    splits = random_share_split(y, n_workers=n_workers, seed=seed + 1)
    loaders = federated_loaders((x, y), splits, seed=seed + 2)
    cfgs = make_worker_configs(n_workers, [len(s) for s in splits],
                               seed=seed + 3)
    return [Worker(cfg=cfgs[k], loader=loaders[k],
                   loss_and_grad=mlp_loss_and_grad)
            for k in range(n_workers)]


def phase_slice(torch, dev) -> dict:
    import numpy as np

    from repro_torch.core import flat as fl
    from repro_torch.core import protocol as proto
    from repro_torch.fed import rounds as rd
    from repro_torch.fed.simulator import FedSimulator
    from repro_torch.fed.worker import Worker
    from repro_torch.kernels import fused_wire as fw
    from repro_torch.models.mlp import init_mlp_classifier
    from repro_torch.utils import tree_leaves, tree_size

    workers = _federation(N_WORKERS, N_WORKERS * 1024, N_FEATURES,
                          N_CLASSES, SEED)
    params = init_mlp_classifier(torch.Generator().manual_seed(SEED),
                                 N_FEATURES, N_CLASSES, HIDDEN, device=dev)
    check(tree_size(params) == N_PARAMS, f"{tree_size(params)} params")
    check(fl.layout_of(params).rows == ROWS, "unexpected flat rows")
    sim = FedSimulator(workers, params, device=dev)

    # round_step runs between syncs under sync-debug "error", so any host
    # sync inside it raises; local training is timed between syncs too.
    step_s: list[float] = []
    train_s: list[float] = []
    inner_step = rd.WirePath.round_step
    inner_train = Worker.train_round_device

    def guarded(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = inner_step(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    def timed_train(self, params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_train(self, params)
        torch.cuda.synchronize()
        train_s.append(time.perf_counter() - t0)
        return out

    rd.WirePath.round_step = guarded
    Worker.train_round_device = timed_train
    try:
        for k in fw.LAUNCHES:
            fw.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run_fedpc(rounds=ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fw.LAUNCHES)
    finally:
        rd.WirePath.round_step = inner_step
        Worker.train_round_device = inner_train

    check(len(step_s) == ROUNDS, f"round_step ran {len(step_s)} times")
    for k, v in launches.items():
        check(v == ROUNDS, f"{k} launched {v} times in {ROUNDS} rounds")
    check(all(np.isfinite(res.costs)), f"costs not finite: {res.costs}")
    want = proto.fedpc_bytes_per_round(proto.model_size_bytes(params),
                                       N_WORKERS)
    check(res.bytes_per_round == [want] * ROUNDS,
          f"bytes per round {res.bytes_per_round} != {want}")
    check(all(0 <= k < N_WORKERS for k in res.pilot_history), "bad pilot")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(res.params)),
          "global model not finite")
    check(int(res.round_state.round) == ROUNDS + 1, "round counter")
    print(f"slice: run_fedpc {N_PARAMS:,} params x {N_WORKERS} workers, "
          f"rows {ROWS}, sizes {[w.loader.n for w in workers]}; costs "
          f"{[round(c, 5) for c in res.costs]}; pilots {res.pilot_history}; "
          f"bytes/round {want:.0f}; launches {launches}; round_step under "
          f"sync-debug 'error' with no sync", flush=True)
    train_ms = sum(train_s) / ROUNDS * 1e3
    step_ms = sum(step_s) / ROUNDS * 1e3
    wall_ms = wall / ROUNDS * 1e3
    print(f"round: wall {wall_ms:.1f} ms per round = local training "
          f"{train_ms:.1f} ms ({N_WORKERS} workers, "
          f"{sum(len(w.loader.arrays[0]) for w in workers)} samples) + "
          f"round_step {step_ms:.3f} ms + stack/flatten/unflatten "
          f"{wall_ms - train_ms - step_ms:.1f} ms; round_step per round "
          f"{[round(s * 1e3, 3) for s in step_s]} ms", flush=True)

    # A quickstart-size federation on the card and on the CPU (plain
    # versions) must agree: same pilots, costs within float32 drift.
    runs = []
    for d in (dev, torch.device("cpu")):
        ws = _federation(3, 1500, 24, 6, SEED)
        p = init_mlp_classifier(torch.Generator().manual_seed(SEED), 24, 6,
                                device=d)
        runs.append(FedSimulator(ws, p, device=d).run_fedpc(rounds=5))
    check(runs[0].pilot_history == runs[1].pilot_history,
          f"pilots card {runs[0].pilot_history} cpu {runs[1].pilot_history}")
    check(np.allclose(runs[0].costs, runs[1].costs, rtol=1e-3),
          f"costs card {runs[0].costs} cpu {runs[1].costs}")
    print(f"small: card and CPU agree, pilots {runs[0].pilot_history}",
          flush=True)
    return launches


def _median_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_times(torch, dev, rate: float, launches: dict,
                errs: dict) -> list[dict]:
    from repro_torch.fed import rounds as rd
    from repro_torch.kernels import fused_wire as fw
    n, r = N_WORKERS, ROWS // 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q, p1, p2, beta, w, k = _inputs(torch, n, r, gen, dev)
    tt = torch.tensor(2, dtype=torch.int32, device=dev)
    t1 = torch.tensor(1, dtype=torch.int32, device=dev)
    packed = fw.ternary_pack_stacked(q, p1, p2, tt, beta, 0.01)
    m = r * 512                                    # float elements per view
    f32, u8, i64 = 4, 1, 8
    # Bytes each function must move at t = 2: every input read once (the
    # round index and the pilot index too), every output written once.
    up_bytes = n * m * f32 + 2 * m * f32 + n * f32 + f32 + n * m // 4 * u8
    work = {
        "uplink_stacked": (
            up_bytes,
            3 * n * m + m,                         # delta, beta·|step|, product
            lambda: fw.ternary_pack_stacked(q, p1, p2, tt, beta, 0.01),
            lambda: fw.ternary_pack_stacked_plain(q, p1, p2, tt, beta, 0.01),
            "ternary_pack_stacked", "src/repro/kernels/fused_wire.py:275"),
        "master": (
            3 * m * f32 + n * m // 4 * u8 + n * f32 + f32 + i64 + m * f32,
            3 * n * m + 3 * m,                     # fold; step and fma
            lambda: fw.packed_master_update(q, k, packed, w, p1, p2, tt,
                                            0.01),
            lambda: fw.packed_master_update_plain(q, k, packed, w, p1, p2,
                                                  tt, 0.01),
            "packed_master_update", "src/repro/kernels/fused_wire.py:335"),
    }
    before = dict(fw.LAUNCHES)
    rows, kernel_ms = [], {}
    for kind, (nbytes, ops, kern, plain, name, replaces) in work.items():
        ms = _median_ms(torch, kern)
        plain_ms = _median_ms(torch, plain)
        kernel_ms[kind] = ms
        bytes_ms = nbytes / rate * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"time: {name} {ms:.4f} ms (plain {plain_ms:.4f} ms); bound "
              f"{bound_ms:.4f} ms = {nbytes / 1e6:.1f} MB at "
              f"{rate / 1e12:.2f} TB/s; {bound_ms / ms:.1%} of bound; "
              f"achieved {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s", flush=True)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_wire.cu",
            "replaces": replaces, "launches": launches[kind],
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None})

    # Round 1 reads no P^{t-2}: one history buffer fewer.
    r1_bytes = up_bytes - m * f32
    r1_ms = _median_ms(torch, lambda: fw.ternary_pack_stacked(
        q, p1, p2, t1, beta, 0.01))
    print(f"time: ternary_pack_stacked at round 1 {r1_ms:.4f} ms; bound "
          f"{r1_bytes / rate * 1e3:.4f} ms = {r1_bytes / 1e6:.1f} MB",
          flush=True)
    # The round's whole wire: the pilot is read in place, so nothing but
    # the two kernels should run.
    wire = rd.WirePath()
    bufs = q.view(n, ROWS, 128)
    f1, f2 = p1.view(ROWS, 128), p2.view(ROWS, 128)
    wire_ms = _median_ms(torch, lambda: wire.round_from_stacked(
        bufs, k, w, f1, f2, t=tt, betas=beta))
    both = kernel_ms["uplink_stacked"] + kernel_ms["master"]
    print(f"time: round_from_stacked {wire_ms:.4f} ms at t=2 vs its two "
          f"kernels {both:.4f} ms (+{wire_ms - both:.4f} ms)", flush=True)
    fw.LAUNCHES.update(before)                     # timing launches not counted
    return rows


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("FAIL: run from the root of the repository (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    try:
        import torch
        name, count, rate = phase_card(torch)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("numerics: float32 matmuls in full float32 (TF32 off for "
              "matmul and cuDNN)", flush=True)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        phase_build()
        errs = phase_check(torch, dev)
        launches = phase_slice(torch, dev)
        rows = phase_times(torch, dev, rate, launches, errs)
    except (SmokeError, RuntimeError, ImportError, OSError,
            subprocess.SubprocessError) as exc:
        print(f"FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
