#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one card and check them.

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero and prints no
result:

1. card   — requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build  — builds the kernels of both paths from ``src/repro_torch/
   kernels/csrc/{fused_wire,masked_wire}.cu``, one ``nvcc`` each, started
   together; prints each kernel's registers and spills.
3. check  — each plain-round kernel against its plain PyTorch version on
   the card, bitwise, at both round branches, at the main-path shape
   (N = 10 workers, R = rows/4 = 41,016) and at odd shapes (N ∈ {1, 3},
   R = 8); then each masked-round kernel the same way, at 16 and 32 bits,
   RR off and on, masks off and on, t ∈ {1, 2}, at the main-path shape and
   at N ∈ {1, 2, 3, 33}, R = 8, with and without a participation-folded
   sign matrix.
4. slice  — ``FedSimulator.run_fedpc``: 3 rounds, 10 workers, the MLP
   3072→4096→2048→10 (20,998,154 params, CIFAR-10 input width) on
   synthetic data, ~1,024 samples per worker. Every launch counter is set
   to 0 just before and read just after: each plain kernel must read 3
   (one uplink and one master launch per round), each masked one 0;
   ``round_step`` runs under ``torch.cuda.set_sync_debug_mode("error")``;
   costs must be finite and bytes per round equal Eq. (8). A
   quickstart-size federation then runs on the card and on the CPU (plain
   versions) and must pick the same pilots.
5. masked slice — the same federation at the same width with
   ``FedPCConfig(privacy=PrivacySpec(dp_epsilon=2.0, enforce=False))``:
   16-bit words, pairwise masks and randomized response on. Each masked
   kernel must read 3 launches and each plain one 0; no host sync in
   ``round_step``; masked Eq. (8) bytes; 3 rounds on the accountant;
   finite costs and model; the quickstart federation again on card and
   CPU. Then, at full width, the masked and unmasked (``mask_seed=None``)
   rounds must give different words and the same new global buffer, and
   one masked uplink may raise the peak of device memory by no more than
   its output and 1 MiB (no code or mask tensor is ever stored).
6. times  — each kernel and its plain version with CUDA events at the
   main-path shape (median of 25), beside its bound: device-memory bytes,
   or integer operations for the masked uplink; the plain uplink also at
   round 1 (no P^{t-2} read), the masked kernels at 16 and 32 bits, and
   each round's whole wire (``WirePath.round_from_stacked``) beside the
   sum of its two kernels; the masked uplink also without RR, without
   masks and without either, to show where its time goes.
7. bounds — the least time of each TPU kernel not ported yet at the
   main-path shape, by arithmetic from the shapes alone.

The line before the last is one JSON object with every kernel's numbers;
the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
# H100 SXM INT32 pipe: 132 SMs x 64 lanes x 1.98 GHz boost clock (the FMA
# pipe takes integer multiply-adds at the same rate beside it).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
DP_EPSILON = 2.0                  # the masked slice's per-round epsilon
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


def _kernel_label(mangled: str) -> str:
    """``name<template args>`` of a mangled kernel symbol."""
    m = re.search(r"([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?", mangled)
    if m is None:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def phase_build() -> None:
    """Build every kernel library at once: one nvcc per source."""
    from repro_torch.kernels import build
    names = ("fused_wire", "masked_wire")

    def timed(name):
        t0 = time.perf_counter()
        return build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(timed, names))
    for name, (so, dt) in zip(names, built):
        log = so.with_name(so.name + ".log")
        usage: dict[str, list[str]] = {}
        kernel = "?"
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "Compiling entry function" in line:
                kernel = _kernel_label(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                usage.setdefault(kernel, []).append(
                    line.split(":", 1)[-1].strip())
        print(f"build: {name} in {dt:.1f} s -> {so.name}", flush=True)
        for kernel, use in usage.items():
            print(f"build:   {kernel}: {'; '.join(use)}", flush=True)


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


def _masked_inputs(torch, n: int, gen, dev, participation: bool = False):
    """The masked uplink's pair keys, signs and RR keys of round 2, built
    as ``WirePath`` builds them, and the participation mask: with
    ``participation`` about a third of the workers sit out."""
    from repro_torch.privacy import dp as pdp
    from repro_torch.privacy import masking as pvm
    t = torch.tensor(2, dtype=torch.int32, device=dev)
    part = None
    if participation:
        part = (torch.rand((n,), generator=gen, device=dev) < 0.7).float()
    keys = pvm.pair_stream_keys(0, n, t)
    signs = pvm.pair_signs(n, participation=part, device=dev)
    return keys, signs, pdp.rr_stream_keys(1, t, n), part


def phase_check_masked(torch, dev) -> dict:
    """Each masked kernel against its plain version, bitwise, over the
    grid of the module docstring. Returns the largest absolute difference
    per kernel at the main-path shape (word values, and floats)."""
    from repro_torch.kernels import masked_wire as mw
    from repro_torch.privacy import masking as pvm
    from repro_torch.privacy.spec import PrivacySpec
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    errs = {"uplink_masked": 0.0, "master_masked": 0.0}
    cases = 0
    shapes = ((N_WORKERS, ROWS // 4, False), (1, 8, False), (2, 8, False),
              (3, 8, True), (33, 8, False), (33, 8, True))
    for n, r, participation in shapes:
        q, p1, p2, beta, w, k = _inputs(torch, n, r, gen, dev)
        keys, signs, rrk, part = _masked_inputs(torch, n, gen, dev,
                                                participation)
        if part is not None:
            w = w * part
        for bits in (16, 32):
            spec = PrivacySpec(modulus_bits=bits)
            wq = pvm.quantize_weights(w, spec.fixpoint_bits)
            sum_wq = pvm.to_words(pvm.as_u64(wq).sum(), 32)
            for thr in (0, PrivacySpec(dp_epsilon=DP_EPSILON).rr_threshold):
                smult = PrivacySpec(modulus_bits=bits, dp_epsilon=(
                    DP_EPSILON if thr else None)).scale_mult
                for use_masks in (True, False):
                    for t in (1, 2):
                        tt = torch.tensor(t, dtype=torch.int32, device=dev)
                        args = (q, p1, p2, tt, beta, 0.01, wq, keys, signs,
                                rrk)
                        kw = dict(rr_threshold=thr, word_bits=bits,
                                  use_masks=use_masks)
                        words = mw.ternary_pack_masked(*args, **kw)
                        plain = mw.ternary_pack_masked_plain(*args, **kw)
                        out = mw.masked_master_update(
                            q, k, words, sum_wq, p1, p2, tt, 0.01, smult)
                        ref = mw.masked_master_update_plain(
                            q, k, words, sum_wq, p1, p2, tt, 0.01, smult)
                        torch.cuda.synchronize()
                        up_err = float((pvm.as_u64(words)
                                        - pvm.as_u64(plain)).abs().max())
                        ma_err = float((out - ref).abs().max())
                        where = (f"N={n} R={r} part={participation} "
                                 f"bits={bits} thr={thr} masks={use_masks} "
                                 f"t={t}")
                        check(words.dtype == plain.dtype and up_err == 0,
                              f"masked uplink differs from plain at {where}")
                        check(torch.equal(out.view(torch.int32),
                                          ref.view(torch.int32)),
                              f"masked master differs from plain at {where}")
                        check(bool(torch.isfinite(out).all()),
                              f"masked master not finite at {where}")
                        if n == N_WORKERS:
                            errs["uplink_masked"] = max(
                                errs["uplink_masked"], up_err)
                            errs["master_masked"] = max(
                                errs["master_masked"], ma_err)
                        cases += 1
                        del words, plain, out, ref
        del q, p1, p2
    print(f"kernels: masked uplink and master bitwise equal to their plain "
          f"versions in all {cases} cases (N, R, participation in "
          f"{list(shapes)}, 16/32 bits, RR off/on, masks off/on, "
          f"t = 1, 2)", flush=True)
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


def _drive(torch, sim, rounds: int):
    """``sim.run_fedpc(rounds)`` with every launch counter set to 0 just
    before and read just after, ``round_step`` under sync-debug "error"
    (any host sync inside it raises) and timed between syncs, as is each
    worker's local training. Returns (result, launches, step_s, train_s,
    wall_s)."""
    from repro_torch.fed import rounds as rd
    from repro_torch.fed.worker import Worker
    from repro_torch.kernels import fused_wire as fw
    from repro_torch.kernels import masked_wire as mw
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
        for counts in (fw.LAUNCHES, mw.LAUNCHES):
            for k in counts:
                counts[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run_fedpc(rounds=rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**fw.LAUNCHES, **mw.LAUNCHES}
    finally:
        rd.WirePath.round_step = inner_step
        Worker.train_round_device = inner_train
    check(len(step_s) == rounds, f"round_step ran {len(step_s)} times")
    return res, launches, step_s, train_s, wall


def _check_run(torch, res, launches: dict, on_path: tuple,
               want_bytes: float, workers, label: str) -> dict:
    """The checks common to both slices; returns the launch counts of the
    path's own kernels."""
    import numpy as np

    from repro_torch.utils import tree_leaves
    for k, v in launches.items():
        want = ROUNDS if k in on_path else 0
        check(v == want, f"{label}: {k} launched {v} times in {ROUNDS} "
              f"rounds, expected {want}")
    check(all(np.isfinite(res.costs)), f"{label}: costs not finite: "
          f"{res.costs}")
    check(res.bytes_per_round == [want_bytes] * ROUNDS,
          f"{label}: bytes per round {res.bytes_per_round} != {want_bytes}")
    check(all(0 <= k < N_WORKERS for k in res.pilot_history), "bad pilot")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(res.params)),
          f"{label}: global model not finite")
    check(int(res.round_state.round) == ROUNDS + 1, "round counter")
    print(f"{label}: run_fedpc {N_PARAMS:,} params x {N_WORKERS} workers, "
          f"rows {ROWS}, sizes {[w.loader.n for w in workers]}; costs "
          f"{[round(c, 5) for c in res.costs]}; pilots {res.pilot_history}; "
          f"bytes/round {want_bytes:.0f}; launches {launches}; round_step "
          f"under sync-debug 'error' with no sync", flush=True)
    return {k: launches[k] for k in on_path}


def _print_round(label: str, step_s, train_s, wall: float, workers) -> None:
    train_ms = sum(train_s) / ROUNDS * 1e3
    step_ms = sum(step_s) / ROUNDS * 1e3
    wall_ms = wall / ROUNDS * 1e3
    print(f"{label}: wall {wall_ms:.1f} ms per round = local training "
          f"{train_ms:.1f} ms ({N_WORKERS} workers, "
          f"{sum(len(w.loader.arrays[0]) for w in workers)} samples) + "
          f"round_step {step_ms:.3f} ms + stack/flatten/unflatten "
          f"{wall_ms - train_ms - step_ms:.1f} ms; round_step per round "
          f"{[round(x * 1e3, 3) for x in step_s]} ms", flush=True)


def _small_agrees(torch, dev, cfg, label: str) -> None:
    """A quickstart-size federation on the card and on the CPU (plain
    versions) must agree: same pilots, costs within float32 drift."""
    import numpy as np

    from repro_torch.fed.simulator import FedSimulator
    from repro_torch.models.mlp import init_mlp_classifier
    runs = []
    for d in (dev, torch.device("cpu")):
        ws = _federation(3, 1500, 24, 6, SEED)
        p = init_mlp_classifier(torch.Generator().manual_seed(SEED), 24, 6,
                                device=d)
        runs.append(FedSimulator(ws, p, cfg, device=d).run_fedpc(rounds=5))
    check(runs[0].pilot_history == runs[1].pilot_history,
          f"{label}: pilots card {runs[0].pilot_history} cpu "
          f"{runs[1].pilot_history}")
    check(np.allclose(runs[0].costs, runs[1].costs, rtol=1e-3),
          f"{label}: costs card {runs[0].costs} cpu {runs[1].costs}")
    print(f"{label}: card and CPU agree, pilots {runs[0].pilot_history}",
          flush=True)


def _full_width(torch, dev):
    from repro_torch.core import flat as fl
    from repro_torch.models.mlp import init_mlp_classifier
    from repro_torch.utils import tree_size
    workers = _federation(N_WORKERS, N_WORKERS * 1024, N_FEATURES,
                          N_CLASSES, SEED)
    params = init_mlp_classifier(torch.Generator().manual_seed(SEED),
                                 N_FEATURES, N_CLASSES, HIDDEN, device=dev)
    check(tree_size(params) == N_PARAMS, f"{tree_size(params)} params")
    check(fl.layout_of(params).rows == ROWS, "unexpected flat rows")
    return workers, params


def phase_slice(torch, dev) -> dict:
    """The plain round at full width; returns its launch counts."""
    from repro_torch.core import protocol as proto
    from repro_torch.fed.simulator import FedSimulator
    workers, params = _full_width(torch, dev)
    sim = FedSimulator(workers, params, device=dev)
    res, launches, step_s, train_s, wall = _drive(torch, sim, ROUNDS)
    want = proto.fedpc_bytes_per_round(proto.model_size_bytes(params),
                                       N_WORKERS)
    own = _check_run(torch, res, launches, ("uplink_stacked", "master"),
                     want, workers, "slice")
    _print_round("round", step_s, train_s, wall, workers)
    _small_agrees(torch, dev, None, "small")
    return own


def phase_masked_slice(torch, dev) -> dict:
    """The masked round (16-bit words, masks and RR on) at full width;
    returns its launch counts."""
    from repro_torch.core import protocol as proto
    from repro_torch.core.fedpc import FedPCConfig
    from repro_torch.fed.simulator import FedSimulator
    from repro_torch.privacy.spec import PrivacySpec
    spec = PrivacySpec(dp_epsilon=DP_EPSILON, enforce=False)
    workers, params = _full_width(torch, dev)
    sim = FedSimulator(workers, params,
                       FedPCConfig(n_workers=N_WORKERS, privacy=spec),
                       device=dev)
    res, launches, step_s, train_s, wall = _drive(torch, sim, ROUNDS)
    want = proto.fedpc_masked_bytes_per_round(
        proto.model_size_bytes(params), N_WORKERS, word_bits=16)
    own = _check_run(torch, res, launches, ("uplink_masked", "master_masked"),
                     want, workers, "masked slice")
    acc = res.round_state.accountant
    check(acc is not None and int(acc.spent_rounds) == ROUNDS,
          "accountant did not count the rounds")
    check(sorted({k for (_, _, k, _) in sim.ledger.events})
          == ["cost", "masked_words", "pilot_params"], "ledger kinds")
    print(f"masked slice: eps per round {spec.eps_round:.6f} (threshold "
          f"{spec.rr_threshold}), accountant {int(acc.spent_rounds)} rounds, "
          f"eps {float(acc.epsilon()):.6f} basic, "
          f"{float(acc.epsilon(spec.delta)):.6f} advanced at delta "
          f"{spec.delta}", flush=True)
    _print_round("masked round", step_s, train_s, wall, workers)
    _small_agrees(torch, dev, FedPCConfig(n_workers=3, privacy=spec),
                  "masked small")
    return own


def phase_masked_wire(torch, dev) -> None:
    """Exact cancellation and no stored mask, at full width."""
    from repro_torch.fed import rounds as rd
    from repro_torch.privacy.spec import PrivacySpec
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n, r = N_WORKERS, ROWS // 4
    q, p1, p2, beta, w, k = _inputs(torch, n, r, gen, dev)
    bufs = q.view(n, ROWS, 128)
    f1, f2 = p1.view(ROWS, 128), p2.view(ROWS, 128)
    tt = torch.tensor(3, dtype=torch.int32, device=dev)
    outs = []
    for seed in (0, None):
        wire = rd.WirePath(privacy=PrivacySpec(
            mask_seed=seed, dp_epsilon=DP_EPSILON, enforce=False))
        outs.append(wire.round_from_stacked(bufs, k, w, f1, f2, t=tt,
                                            betas=beta))
    (new_m, y_m), (new_u, y_u) = outs
    differ = float((y_m != y_u).float().mean())
    check(differ > 0.99, f"masked words equal unmasked ones at {differ:.3%}")
    check(torch.equal(new_m.view(torch.int32), new_u.view(torch.int32)),
          "masked and unmasked rounds give different global buffers")
    del outs, new_m, new_u, y_m, y_u
    wire = rd.WirePath(privacy=PrivacySpec(dp_epsilon=DP_EPSILON,
                                           enforce=False))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y, _wq = wire.uplink_masked(bufs, f1, f2, t=tt, w=w, betas=beta)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    out_bytes = y.numel() * y.element_size()
    check(rise <= out_bytes + (1 << 20),
          f"masked uplink raised peak memory by {rise} bytes, output "
          f"{out_bytes}")
    print(f"cancel: full width, masked and unmasked words differ in "
          f"{differ:.4%} of places, new global buffers bitwise equal; "
          f"memory: one masked uplink raised the peak by {rise:,} bytes "
          f"for a {out_bytes:,}-byte output (+{rise - out_bytes:,})",
          flush=True)


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


def uplink_masked_int_ops(n: int, elems: int, bits: int, rr: bool,
                          masks: bool, active_pairs: int
                          ) -> tuple[float, float]:
    """(ALU-only, all) integer operations the masked uplink needs on these
    inputs, counted as ``nvcc`` compiles its code for sm_90a (read from
    ``cuobjdump -sass``), without loop overhead.

    Hopper's SM runs 64 integer ops per clock on its INT32 pipe and can
    send integer multiplies and adds (IMAD) to its FMA pipe beside it, so
    the least time is the larger of the ALU-only ops (shifts, logic,
    compares) at 64 per SM per clock and all integer ops at twice that.
    An add and a mix32 are 9 ops, 6 of them ALU-only (3 shifts, 3 xors;
    the add and 2 multiplies go to the FMA pipe); a trailing ``& 0xFFFF``
    folds into the last xor. Per element: the RR counter hash (9, 6); the
    mask counter hash per element pair at 16 bits (4.5, 3 per element),
    shared with RR at 32 or (9, 6) without it. Per worker and element: the
    weight multiply (1, 0) and, with RR, a stream word (9, 6), a compare
    (1, 1), a mod 3 (a multiply-high, a shift, a multiply-add: 3, 1) and a
    select (1, 0). Per active (k, l) pair of the sign matrix: at 16 bits
    per stream word of two elements a stream word (9, 6) and two
    multiply-adds (5.5, 3 per element); at 32 bits per element a stream
    word and a multiply-add (10, 6). Float operations are left out."""
    alu = total = 0.0
    if rr:
        alu, total = 6 * elems, 9 * elems
    if masks and bits == 16:
        alu, total = alu + 3 * elems, total + 4.5 * elems
    elif masks and not rr:
        alu, total = alu + 6 * elems, total + 9 * elems
    total += n * elems * (1 + (14 if rr else 0))
    alu += n * elems * (8 if rr else 0)
    if masks:
        per_pair = (3.0, 5.5) if bits == 16 else (6.0, 10.0)
        alu += active_pairs * elems * per_pair[0]
        total += active_pairs * elems * per_pair[1]
    return alu, total


def int_bound_ms(alu: float, total: float) -> float:
    """The least time for these integer ops: ALU-only ops at the INT32
    pipe's rate, all ops at the INT32 and FMA pipes' together."""
    return max(alu / INT32_OPS_PER_S, total / (2 * INT32_OPS_PER_S)) * 1e3


def phase_times_masked(torch, dev, rate: float, launches: dict,
                       errs: dict) -> list[dict]:
    """The masked kernels and their plain versions at the main-path shape,
    RR on, at 16 bits (the main path's, in the JSON line) and 32."""
    from repro_torch.fed import rounds as rd
    from repro_torch.kernels import masked_wire as mw
    from repro_torch.privacy import masking as pvm
    from repro_torch.privacy.spec import PrivacySpec
    n, r = N_WORKERS, ROWS // 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q, p1, p2, beta, w, k = _inputs(torch, n, r, gen, dev)
    keys, signs, rrk, _ = _masked_inputs(torch, n, gen, dev)
    active = int((signs != 0).sum())
    tt = torch.tensor(2, dtype=torch.int32, device=dev)
    m = r * 512                                    # elements per view
    f32 = 4
    before = dict(mw.LAUNCHES)
    rows = []
    for bits in (16, 32):
        spec = PrivacySpec(modulus_bits=bits, dp_epsilon=DP_EPSILON,
                           enforce=False)
        thr = spec.rr_threshold
        wq = pvm.quantize_weights(w, spec.fixpoint_bits)
        sum_wq = pvm.to_words(pvm.as_u64(wq).sum(), 32)
        args = (q, p1, p2, tt, beta, 0.01, wq, keys, signs, rrk)
        kw = dict(rr_threshold=thr, word_bits=bits)
        words = mw.ternary_pack_masked(*args, **kw)
        word = bits // 8
        small = n * f32 * 3 + keys.numel() * 8 + f32   # beta, wq, rr, keys
        up_bytes = n * m * f32 + 2 * m * f32 + small + n * m * word
        ma_bytes = n * m * word + 4 + 8 + 3 * m * f32 + f32 + m * f32
        alu, total = uplink_masked_int_ops(n, m, bits, True, True, active)
        work = {
            "uplink_masked": (
                up_bytes, int_bound_ms(alu, total),
                f"{alu / 1e9:.2f} G ALU-only / {total / 1e9:.2f} G int ops",
                lambda: mw.ternary_pack_masked(*args, **kw),
                lambda: mw.ternary_pack_masked_plain(*args, **kw),
                "ternary_pack_masked", "src/repro/kernels/masked_wire.py:299"),
            "master_masked": (
                ma_bytes, int_bound_ms((n + 6) * m, (n + 6) * m),
                f"{(n + 6) * m / 1e9:.2f} G int ops",  # fold, de-bias
                lambda: mw.masked_master_update(
                    q, k, words, sum_wq, p1, p2, tt, 0.01, spec.scale_mult),
                lambda: mw.masked_master_update_plain(
                    q, k, words, sum_wq, p1, p2, tt, 0.01, spec.scale_mult),
                "masked_master_update",
                "src/repro/kernels/masked_wire.py:386"),
        }
        kernel_ms = {}
        for kind, (nbytes, ops_ms, ops_text, kern, plain, name,
                   replaces) in work.items():
            ms = _median_ms(torch, kern)
            plain_ms = _median_ms(torch, plain)
            kernel_ms[kind] = ms
            bytes_ms = nbytes / rate * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            by = "bytes" if bytes_ms >= ops_ms else "operations"
            print(f"time: {name} {bits}-bit {ms:.4f} ms (plain "
                  f"{plain_ms:.4f} ms); bound {bound_ms:.4f} ms by {by}: "
                  f"{nbytes / 1e6:.1f} MB at {rate / 1e12:.2f} TB/s = "
                  f"{bytes_ms:.4f} ms, {ops_text} = {ops_ms:.4f} ms; "
                  f"{bound_ms / ms:.1%} of bound; achieved "
                  f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s", flush=True)
            if bits == 16:
                rows.append({
                    "name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/masked_wire.cu",
                    "replaces": replaces, "launches": launches[kind],
                    "max_abs_err": errs[kind], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": None})
        # Where the uplink's time goes: the same launch without RR, without
        # masks, and without either.
        parts = []
        for rr_on, masks_on in ((True, False), (False, True),
                                (False, False)):
            kw_part = dict(rr_threshold=thr if rr_on else 0, word_bits=bits,
                           use_masks=masks_on)
            part_ms = _median_ms(torch, lambda: mw.ternary_pack_masked(
                *args, **kw_part))
            part_bound = max(
                (up_bytes - (0 if masks_on else keys.numel() * 8)) / rate
                * 1e3, int_bound_ms(*uplink_masked_int_ops(
                    n, m, bits, rr_on, masks_on, active)))
            parts.append(f"RR {'on' if rr_on else 'off'} masks "
                         f"{'on' if masks_on else 'off'} {part_ms:.4f} ms "
                         f"(bound {part_bound:.4f} ms)")
        print(f"time: ternary_pack_masked {bits}-bit parts: "
              + "; ".join(parts), flush=True)
        wire = rd.WirePath(privacy=spec)
        bufs = q.view(n, ROWS, 128)
        f1, f2 = p1.view(ROWS, 128), p2.view(ROWS, 128)
        wire_ms = _median_ms(torch, lambda: wire.round_from_stacked(
            bufs, k, w, f1, f2, t=tt, betas=beta))
        both = kernel_ms["uplink_masked"] + kernel_ms["master_masked"]
        print(f"time: masked round_from_stacked {bits}-bit {wire_ms:.4f} ms "
              f"at t=2 vs its two kernels {both:.4f} ms "
              f"(+{wire_ms - both:.4f} ms)", flush=True)
        del words
    mw.LAUNCHES.update(before)                     # timing launches not counted
    return rows


def print_unported_bounds(rate: float) -> None:
    """The least time of each TPU kernel not ported yet, at the main-path
    shape (m = 21,000,192 elements a worker view, N = 10): bytes it must
    move (each input read once, each output written once) at the card's
    memory rate, or integer ops counted as for the masked uplink, the
    larger. Nothing here runs a kernel."""
    m = ROWS * 128
    n = N_WORKERS
    pairs = n - 1             # one post-uplink death among n: its pairs
    kernels = (
        (3, "fused_wire.py:246 ternary_pack_any_2d",
         "one worker's uplink, t >= 2", 3 * 4 * m + m / 4, (0, 0)),
        (4, "fused_wire.py:205 ternary_pack_2d",
         "one worker's Eq. (5) uplink", 3 * 4 * m + m / 4, (0, 0)),
        (5, "fused_wire.py:228 ternary_pack_round1_2d",
         "one worker's Eq. (4) uplink", 2 * 4 * m + m / 4, (0, 0)),
        (8, "masked_wire.py:503 mask_repair_2d",
         f"16-bit words, one death: {pairs} repair pairs", 2 * 2 * m,
         (3 * m + pairs * 3 * m, 4.5 * m + pairs * 5.5 * m)),
        (9, "partial_sum.py:179 partial_sum_2d",
         f"{n} packed leaves into 3 uint32 partials (fanout 4)",
         n * m / 4 + 3 * 4 * m, (0, 0)),
        (10, "partial_sum.py:229 masked_partial_sum_2d",
         f"{n} 16-bit leaf words into 3 masked partials (fanout 4)",
         n * 2 * m + 3 * 2 * m, (3 * (3 + 2 * 3) * m, 3 * (4.5 + 2 * 5.5) * m)),
        (11, "ternary_encode.py:45 ternary_encode_2d",
         "one worker's Eq. (5) int8 codes", 3 * 4 * m + m, (0, 0)),
        (12, "ternary_encode.py:63 ternary_encode_round1_2d",
         "one worker's Eq. (4) int8 codes", 2 * 4 * m + m, (0, 0)),
        (13, "pack2bit.py:47/65 pack2bit_2d / unpack2bit_2d",
         "one worker's int8 codes <-> packed bytes", m + m / 4, (0, 0)),
        (14, "master_update.py:35 master_update_2d",
         f"Eq. (3) over {n} workers' int8 codes", n * m + 4 * 4 * m,
         (0, 0)),
    )
    for row, name, what, nbytes, (alu, total) in kernels:
        bytes_ms = nbytes / rate * 1e3
        ops_ms = int_bound_ms(alu, total)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        ops = (f", {alu / 1e9:.2f} G ALU-only / {total / 1e9:.2f} G int ops "
               f"= {ops_ms:.4f} ms" if total else "")
        print(f"bound: #{row} {name} ({what}): {max(bytes_ms, ops_ms):.4f} "
              f"ms by {by}: {nbytes / 1e6:.1f} MB = {bytes_ms:.4f} ms{ops} "
              f"(not ported)", flush=True)


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
        errs.update(phase_check_masked(torch, dev))
        launches = phase_slice(torch, dev)
        launches.update(phase_masked_slice(torch, dev))
        phase_masked_wire(torch, dev)
        rows = phase_times(torch, dev, rate, launches, errs)
        rows += phase_times_masked(torch, dev, rate, launches, errs)
        print_unported_bounds(rate)
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
