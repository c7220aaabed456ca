#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one card and check them.

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero and prints no
result:

1. card   — requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build  — builds every kernel from the six ``src/repro_torch/kernels/
   csrc/*.cu`` (``fused_wire``, ``masked_wire``, ``partial_sum``,
   ``ternary_encode``, ``pack2bit``, ``master_update``), one ``nvcc``
   each, started together; prints each kernel's registers and spills, and
   fails if any kernel spills.
3. check  — each kernel against its plain PyTorch version on the card,
   bitwise. The plain round's at both round branches, at the main-path
   shape (N = 10 workers, R = rows/4 = 41,016) and at N ∈ {1, 3}, R = 8.
   The masked round's at 16 and 32 bits, RR off and on, masks off and on,
   t ∈ {1, 2}, at the main-path shape and at N ∈ {1, 2, 3, 10, 16, 17,
   33}, R = 8, with and without a participation-folded sign matrix and
   with tree-scoped signs (sibling groups of 2 and 4); the masked uplink
   through the kernel its wrapper picks (the pair kernel up to 16
   workers) and through the row-fold kernel, both against the plain
   version. The tree's:
   ``partial_sum`` at 16/32 bits, fanout ∈ {2, 4, 8}, C ∈ {5, 7, 10}
   (ragged groups) and at the main-path shape (C = 10, fanout 4);
   ``masked_partial_sum`` at 16/32 bits, G ∈ {1, 2, 3, 5}, sibling below
   and equal to G, masks off and on, with a participation fold, and a
   fully dropped subtree whose partial must be exactly zero;
   ``mask_repair`` at 16/32 bits, P ∈ {1, 3, 9, 45} and the main path's
   13 at R ∈ {1, 8, 17} and the main path's, out of place, in place and
   write-only, all-zero coefficients the identity; the masked master over
   C = 3 word rows beside a 10-row pilot stack. The one-worker uplinks (static
   Eq. (5), Eq. (4), and at a device round t ∈ {1, 2, 3} with beta_k
   sliced from a vector), the encode at both rules, pack and unpack and
   the unfused master at one worker's main-path view and small ones;
   unpack on all 256 byte values, pack on random int8, the unfused master
   at N ∈ {1, 10, 33} on ternary and random int8 codes.
4. slice  — ``FedSimulator.run_fedpc``: 3 rounds, 10 workers, the MLP
   3072→4096→2048→10 (20,998,154 params, CIFAR-10 input width) on
   synthetic data, ~1,024 samples per worker. Before each slice every
   launch counter is set to 0, and it is read just after: each kernel of
   the slice's path must read its launches (3 rounds of one uplink and
   one master launch here), every other kernel 0; ``round_step`` runs
   under ``torch.cuda.set_sync_debug_mode("error")``; costs must be
   finite and bytes per round equal Eq. (8). A quickstart-size federation
   then runs on the card and on the CPU (plain versions) and must pick
   the same pilots.
   worker rounds — on each of the slice's three rounds' own inputs (its
   ten trained models and history), bitwise: the round built a worker at
   a time (``WirePath.uplink`` ten times, stacked, then ``master``: 11
   launches) == the batched round's bytes and new buffer; the same with
   ``WirePath.uplink_traced`` at a device round and per-worker beta_k,
   under sync-debug "error"; the unfused round (``ops.ternary_encode``,
   ``pack2bit``, ``unpack2bit`` a worker, then one ``ops.master_update``
   at t = 2, 3: 31 launches) == the fused round's bytes and new buffer,
   with round 1's bytes through ``ternary_encode_round1`` == the Eq. (4)
   uplink's. Then the ``ops`` functions on the MLP's own leaves and on
   sizes that are not multiples of 4 or 512, card against CPU, bitwise.
   scan slice — the same MLP and N with 1,024 samples a worker in equal
   contiguous shards (every shard uniform, so local training runs
   ``Worker.scan_train``, one CUDA graph replay a batch): (a)
   ``run_fedpc`` and ``run_fedpc_scan`` on two fresh, equal federations
   for 3 rounds, pilots, costs, bytes and every leaf bitwise, each run
   launching the uplink and the master once a round and nothing else,
   the scan driver's whole round loop (``rounds.scan_rounds``) under
   sync-debug "error"; (b) the same with ``participation=0.6``
   (seed 0) on the plain wire and for 2 rounds on the masked wire
   (16-bit, DP epsilon 2), bytes per round of the 6 sampled workers;
   (c) one worker's graph replay against the same step called eagerly,
   bitwise; (d) local training per round through the graph and through
   the eager per-batch loop on the same shards, and each driver's round
   wall time, beside the card's name and power limit.
   baselines slice — the scan slice's federation: (a) ``run_fedpc`` with
   ``evade_streak=2`` for 6 rounds, one uplink and one master launch a
   round, Eq. (8) bytes, the ledger's pilot uploads == the pilot history,
   no pilot streak over 4, and a quickstart-size run with the defence on
   the card and on the CPU; (b) ``run_fedavg`` and ``run_phong`` for 2
   rounds and ``run_centralized`` for 2 on the union of the shards, no
   launch, 2VN and 0 bytes, quickstart-size FedAvg and Phong on the card
   and on the CPU; (c) FedAvg's aggregate of round 1 on the card == on
   the CPU, bitwise, and its sum timed beside its bound; (d)
   ``core.fedpc.master_round`` over every round of (a) as trees against
   ``round_step``; (e) each algorithm's round split into local training
   and aggregation, beside the card's name and power limit.
5. masked slice — the same federation with
   ``FedPCConfig(privacy=PrivacySpec(dp_epsilon=2.0, enforce=False))``:
   16-bit words, pairwise masks and randomized response on; masked
   Eq. (8) bytes; 3 rounds on the accountant. Then, at full width, the
   masked and unmasked (``mask_seed=None``) rounds must give different
   words and the same new global buffer, and one masked uplink may raise
   the peak of device memory by no more than its output and 1 MiB.
6. tree slice — the plain federation through ``TreeSpec(fanout=2)``
   (widths 10, 5, 3, 2): uplink 3, ``partial_sum`` 3,
   ``masked_partial_sum`` 6, masked master 3 launches; tree Eq. (8)
   bytes.
7. masked tree slice — the masked federation through ``TreeSpec(
   fanout=4)`` with ``recovery_threshold=2`` under ``FaultPlan(seed=0,
   drop_before_uplink=0.05, drop_after_uplink=0.15, straggler=0.05)``:
   one masked uplink, ``masked_partial_sum``, ``mask_repair`` and masked
   master launch a round; bytes and recovery bytes by the JAX simulator's
   rules from the schedule; at least one repaired post-uplink death; the
   ledger's ``seed_shares``/``mask_recovery`` events. Then, at full
   width, bitwise: the plain tree at fanout 2 == one group (fanout 16),
   the masked tree == the flat masked round, and each repaired round ==
   the survivors-only round, on the masked tree and on the flat masked
   wire.
   telemetry slice — every run of every slice above builds its trace
   and cross-checks it (a ``TelemetryMismatch`` fails the run). On the
   masked tree with faults, at full width, on equal 1,024-sample shards:
   (a) ``run_fedpc`` and ``run_fedpc_scan`` for 3 rounds, their traces
   equal one for one, the summed counts and the edge level widths
   printed, the bytes the slice's own rules; (b) 2 rounds,
   ``save_round_state`` (about 168 MB) into a temporary directory,
   ``load_round_state`` onto the card, 1 more round == (a)'s
   ``run_fedpc`` bitwise (buffers, costs, round, accountant, carry,
   pilots, params, trace), save and load timed; (c) ``round_step`` at
   rounds 2–3 on the plain and the masked wire with the telemetry carry
   and without, in turns, and the ops the record adds under
   ``torch.profiler``; (d) a plain and a masked-tree round under
   ``telemetry.profile_session``: one ``wire/<kind>/r<rows>n<N>/cuda``
   range a launch, the ``LAUNCHES`` counter read inside each, and each
   launch call inside its range where the profiler records CUDA activity.
   privacy slice — §4.2 enforcement with ``PrivacySpec(enforce=True)``,
   the default, on equal 1,024-sample shards, 2 rounds a run: (a) the
   shipped ``secure-agg`` and ``secure-agg-ldp`` scenarios (C = 0.5,
   eps 4) through ``run_fedpc`` and ``run_fedpc_scan``: each driver
   records exactly one audit (masked, 2 launches), the drivers agree
   bitwise, and ``run_fedpc`` with ``enforce=False`` launches the same
   kernels as often and gives the same bits; (b) the masked tree under
   the masked tree slice's fault plan, enforced (an audit of levels + 3
   launches); (c) at the main-path shapes the audit refuses the plaintext
   wire under the masked policy and a leaky master launched through the
   public seam (``kernels.seam.run_plain``); (d) the pilot slot: #2 and
   #7, kernel and plain, at the main-path shape, give the same bits with
   every non-pilot row of the worker stack NaN, -inf and garbage; (e)
   each audit's set-up time, beside the card's name and power limit.
   model serving — the model zoo's ``qwen3-14b`` at full width and depth
   (40 layers, d_model 5120, 40 heads over 8 KV heads, d_ff 17408, vocab
   151936, qk-norm; 14,768,307,200 params) in bfloat16, random weights
   drawn on the card from a seed: prefill 4 x 1,024 random tokens (the
   512-key blocked attention), then 32 greedy decode steps with ``pos`` a
   device tensor under sync-debug "error"; logits finite; the blocked
   prefill's last logits against ``forward``'s materialized full
   sequence, and a 64-token prefill then one decode step against
   ``prefill_sequential`` then the same step, each a relative L2
   distance within 0.08 in bfloat16; prefill and decode times beside
   their bounds (2 x params x tokens at the dense bf16 peak; the weights
   at the memory rate) and ``max_memory_allocated``. Then the same widths
   at 4 layers in float32 (2,877,077,504 params), the same checks within
   1e-4.
   federated LM — ``launch/train.py simulate``'s setup through the port:
   the reduced ``qwen3-14b`` (1,443,328 params), 4 workers on 192
   SyntheticLM sequences of 64 tokens (``sequence_split``, batch sizes
   from (16, 8)), 3 rounds of ``run_fedpc``, twice: #1 and #2 launched 3
   times a run and nothing else, ``round_step`` under sync-debug "error",
   Eq. (8) bytes, the two runs bitwise equal, the CPU's run (plain
   versions) picking the same pilots; an LM worker's captured training
   step (the token gather and its backward) replayed against the same
   step called eagerly, bitwise.
   MoE and recurrent serving — the same serving at full width and depth
   for ``deepseek-moe-16b`` (28 layers, a dense first one, 64 routed
   experts top-6 + 2 shared; 16,375,728,128 params) and ``xlstm-350m``
   (24 alternating mLSTM / sLSTM blocks; 443,057,248 params), each then at
   4 layers in float32; the MoE's prefill / ``prefill_sequential`` check
   at a capacity where no assignment drops (the two see other token
   counts); the bf16 xLSTM's checks within ``SERVE_TOL_LSTM_BF16``; prints the prefill's kept token-expert pairs (its
   drop_frac) and the experts routed to a decode step; bounds counted a
   block kind at a time: attention as above, a MoE block's router, shared
   experts and dense prefix a token and its routed experts at the kept
   pairs, the recurrent mixers' projections a token and their state
   updates a step in float32; decode's bytes without the experts no token
   was routed to, plus the recurrent state read and written. An LSTM's
   prefill is profiled at 128 tokens. Then ``jamba-1.5-large-398b``'s
   Mamba mixer alone at its width (d_model 8192, d_inner 16384):
   ``mamba_prefill`` on 4 x 1,024, 8 ``mamba_decode`` steps under
   sync-debug "error", held to float32 (0.08) and to every token decoded
   one at a time (0.08 in bf16, 1e-4 in float32). Then the federated LM
   on the reduced ``deepseek-moe-16b``: its launches join #1's and #2's.
   distributed slice — the mesh runtime (``fed.distributed``) on this
   card: the (10, 1) and (4, 2) meshes, each rank a spawned process on
   card 0 with gloo (every collective staged through host memory), the
   MLP at full width; at rounds 1 and 3 every strategy with betas and a
   participation mask and the masked wire at 16 and 32 bits, DP off and
   on; on (10, 1) the flat masked wire under ``FaultPlan(**FAULTS)`` with
   threshold 2 beside the survivors-only sync; on (4, 2) masks off, the
   masked tree at fanout 2 and the replicated wire (every rank the whole
   buffer: the (4, 1) computation); each sync under sync-debug "error"
   but for its staged transport calls, one audited (``enforce``). Every
   rank's new models equal (digests); bitwise: masks on == off, repaired
   == survivors-only, the tree == the flat wire, sharded == replicated
   for the exact modes, and the (10, 1) packed round ==
   ``WirePath.round_from_stacked`` on the same ten locals in this
   process; ``fedpc_reduce`` within its f16 bound of the int8 gather and
   the (10, 1) FedAvg within its f32 bound of the sum in worker order in
   this process. The ranks' launches (#2, #3, #6, #8) join the
   ``kernels`` line. Then ``launch.train distributed --backend gloo
   --full-size`` (F = 4, M = 2, 3 rounds) and ``simulate`` (3 rounds), as
   two subprocesses side by side.
8. times  — each kernel and its plain version with CUDA events at the
   main-path shape (median of 25), beside its bound: device-memory bytes,
   or integer operations for the stream-generating kernels; the plain
   uplink also at round 1, the masked kernels at 16 and 32 bits, the
   masked uplink's pair kernel beside its row-fold kernel, its bound beside
   the row-fold count of operations, the masked uplink without RR, without
   masks and without either, the
   master over the tree root's C = 3 rows, the masks-off partial sums and
   a ``torch.sum`` of sibling groups beside one; the repair in place (the
   tree's form) beside its out-of-place and write-only forms and the
   ``copy_`` and ``fill_`` of its row; each round's whole wire
   (``WirePath.round_from_stacked``, the tree rounds' and the flat and
   tree rounds with a repair too) beside the sum of its kernels, with the
   fault path's selects on the device; the one-worker uplinks, encode,
   pack, unpack and the unfused master (beside the two-call PyTorch composition
   ``addcmul(q, tensordot(w, codes), p1 - p2)``), and the per-worker
   round's wire against the batched round's; then a mesh rank's kernels
   at each mesh's slab (#3, #2 with the pilot apart, #6 at N = 1 with
   L = F at 16 and 32 bits with RR, #8 on the reduced slab), each
   bitwise to its plain version first.

The line before the last is one JSON object with every kernel's numbers,
one entry a kernel function, each with ``row``, its row in the kernel
table of ``PERF.md`` (#1–#14); the last is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

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
QUEUED = 10                       # calls per timing when queued
SLEEP_CYCLES = 40_000_000         # ~20 ms of card clock: the host queues them
SLEEP_DOUBLINGS = 4               # per repeat, before a queued timing fails
SCRUB_BYTES = 128 << 20           # read before each queued call: over the L2
FP32_OPS_PER_S = 67e12            # H100 SXM, float32 outside tensor cores
# H100 SXM INT32 pipe: 132 SMs x 64 lanes x 1.98 GHz boost clock (the FMA
# pipe takes integer multiply-adds at the same rate beside it).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
DP_EPSILON = 2.0                  # the masked slice's per-round epsilon
SCAN_SHARD = 1024                 # samples a worker (equal in the scan slice)
SCAN_PARTICIPATION = 0.6          # its partial-participation runs
SCAN_MASKED_ROUNDS = 2
EVADE_STREAK = 2                  # the baselines slice's evasion defence
EVADE_ROUNDS = 6
BASELINE_ROUNDS = 2               # FedAvg, Phong and the centralized bound
CENTRAL_BATCH = 64
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
    """``name<template args>`` of a mangled kernel symbol: the
    length-prefixed identifier ending in ``_kernel`` (the length's digits
    may follow the hex digits of the anonymous namespace), then its int,
    bool or enum template arguments."""
    for run in re.finditer(r"\d+(?=[a-z])", mangled):
        digits = run.group()
        for i in range(len(digits)):
            size = int(digits[i:])
            name = mangled[run.end():run.end() + size]
            if name.endswith("_kernel"):
                rest = mangled[run.end() + size:]
                head = rest[:rest.find("EE")] if rest.startswith("I") else ""
                args = re.findall(r"L(?:[ib]|N\w*?E)(\d+)", head)
                return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def phase_build() -> None:
    """Build every kernel library at once: one nvcc per source."""
    from repro_torch.kernels import build
    names = ("fused_wire", "masked_wire", "partial_sum", "ternary_encode",
             "pack2bit", "master_update")

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
        # A kernel with one instantiation per worker count (its last
        # template argument) is reported on one line over all of them.
        families: dict[str, dict[str, str]] = {}
        for kernel, use in usage.items():
            spills = [int(b) for b in re.findall(r"(\d+) bytes spill",
                                                  " ".join(use))]
            check(not any(spills), f"{kernel} of {name} spills registers")
            head, _, last = kernel.rpartition(",")
            if kernel.count(",") >= 3:
                families.setdefault(head, {})[last.rstrip(">")] = " ".join(
                    use)
            else:
                print(f"build:   {kernel}: {'; '.join(use)}", flush=True)
        for head, uses in families.items():
            every = " ".join(uses.values())
            regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                               every)]
            frames = [int(b) for b in re.findall(r"(\d+) bytes stack",
                                                 every)]
            main = re.search(r"Used (\d+) registers",
                             uses.get(str(N_WORKERS), ""))
            print(f"build:   {head},N> for {len(uses)} worker counts: "
                  f"{min(regs)}-{max(regs)} registers ("
                  f"{main.group(1) if main else '?'} at N = {N_WORKERS}), "
                  f"0 bytes spill stores and loads, stack frame at most "
                  f"{max(frames)} bytes", flush=True)


def _counters() -> tuple[dict, ...]:
    """Every kernel module's launch counter."""
    from repro_torch.kernels import (fused_wire, master_update, masked_wire,
                                     pack2bit, partial_sum, ternary_encode)
    return (fused_wire.LAUNCHES, masked_wire.LAUNCHES, partial_sum.LAUNCHES,
            ternary_encode.LAUNCHES, pack2bit.LAUNCHES, master_update.LAUNCHES)


def _zero_counts() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def _read_counts() -> dict:
    """Every kernel's launches, by kind (the kinds are unique)."""
    return {k: v for counts in _counters() for k, v in counts.items()}


def _restore_counts(saved: dict) -> None:
    """Put back counts read before a phase whose launches do not count."""
    for counts in _counters():
        counts.update({k: saved[k] for k in counts})


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


def _masked_inputs(torch, n: int, gen, dev, participation: bool = False,
                   sibling: int | None = None):
    """The masked uplink's pair keys, signs and RR keys of round 2, built
    as ``WirePath`` builds them, and the participation mask: with
    ``participation`` about a third of the workers sit out; with
    ``sibling`` the signs are a tree's, scoped to sibling groups."""
    from repro_torch.privacy import dp as pdp
    from repro_torch.privacy import masking as pvm
    t = torch.tensor(2, dtype=torch.int32, device=dev)
    part = None
    if participation:
        part = (torch.rand((n,), generator=gen, device=dev) < 0.7).float()
    keys = pvm.pair_stream_keys(0, n, t)
    if sibling is None:
        signs = pvm.pair_signs(n, participation=part, device=dev)
    else:
        signs = pvm.tree_pair_signs(n, sibling, participation=part,
                                    device=dev)
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
    # (N, R, participation, sibling group of tree-scoped signs or None):
    # the pair kernel runs up to 16 workers, the row-fold kernel beyond.
    shapes = ((N_WORKERS, ROWS // 4, False, None), (1, 8, False, None),
              (2, 8, False, None), (3, 8, True, None), (10, 8, True, 2),
              (10, 8, False, 4), (16, 8, False, None), (16, 8, True, 4),
              (17, 8, True, None), (17, 8, False, 4), (33, 8, False, None),
              (33, 8, True, None))
    for n, r, participation, sibling in shapes:
        q, p1, p2, beta, w, k = _inputs(torch, n, r, gen, dev)
        keys, signs, rrk, part = _masked_inputs(torch, n, gen, dev,
                                                participation, sibling)
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
                        rows = mw._ternary_pack_masked_rows(*args, **kw)
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
                                 f"sibling={sibling} bits={bits} thr={thr} "
                                 f"masks={use_masks} t={t}")
                        check(words.dtype == plain.dtype and up_err == 0,
                              f"masked uplink differs from plain at {where}")
                        check(torch.equal(pvm.as_u64(rows),
                                          pvm.as_u64(plain)),
                              f"row-fold masked uplink differs from plain "
                              f"at {where}")
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
                        del words, rows, plain, out, ref
        del q, p1, p2
    print(f"kernels: masked uplink (the wrapper's kernel, the pair kernel "
          f"up to {mw.PAIR_MAX_WORKERS} workers, and the row-fold kernel) "
          f"and master bitwise equal to their plain versions in all "
          f"{cases} cases (N, R, participation, tree sibling group in "
          f"{list(shapes)}, 16/32 bits, RR off/on, masks off/on, "
          f"t = 1, 2)", flush=True)
    return errs


def _rand_words(torch, shape, bits: int, gen, dev):
    """Random wire words of ``bits`` bits on ``dev``."""
    from repro_torch.privacy import masking as pvm
    x = torch.randint(0, 1 << 16, shape, generator=gen, device=dev)
    if bits == 32:
        x = x | (torch.randint(0, 1 << 16, shape, generator=gen,
                               device=dev) << 16)
    return pvm.to_words(x, bits)


def _same_words(a, b) -> tuple[bool, float]:
    """(bitwise equal, largest absolute difference of the word values)."""
    from repro_torch.privacy import masking as pvm
    diff = float((pvm.as_u64(a) - pvm.as_u64(b)).abs().max())
    return a.dtype == b.dtype and a.shape == b.shape and diff == 0, diff


def phase_check_tree(torch, dev) -> dict:
    """The tree's and the repair's kernels, and the masked master over C
    word rows beside an N-row pilot stack, against their plain versions,
    bitwise. Returns the largest absolute difference per kernel at the
    main-path shapes: N_WORKERS rows of R = ROWS // 4 at the leaves, and
    the narrower levels and roots of both tree slices."""
    from repro_torch.fed import rounds as rd
    from repro_torch.kernels import masked_wire as mw
    from repro_torch.kernels import partial_sum as ps
    from repro_torch.privacy import masking as pvm
    from repro_torch.privacy.spec import PrivacySpec
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    r_main = ROWS // 4
    errs = {"partial_sum": 0.0, "masked_partial_sum": 0.0,
            "masked_partial_sum_off": 0.0, "mask_repair": 0.0,
            "master_masked_tree": 0.0}
    cases = dict.fromkeys(errs, 0)

    def record(kind, ok, diff, where, r):
        check(ok, f"{kind} differs from plain at {where}")
        if r == r_main:
            errs[kind] = max(errs[kind], diff)
        cases[kind] += 1

    # #9: 16/32 bits, fanout 2/4/8, C 5/7/10 (ragged groups included), and
    # the plain tree slice's level 1 (C = 10, fanout 2) at full R.
    grid = [(c, f, 8) for f in (2, 4, 8) for c in (5, 7, 10)]
    for bits in (16, 32):
        for c, fanout, r in grid + [(N_WORKERS, 4, r_main),
                                    (N_WORKERS, TREE_FANOUT, r_main)]:
            packed = torch.randint(0, 256, (c, r, 128), generator=gen,
                                   device=dev, dtype=torch.uint8)
            wq = pvm.to_words(torch.randint(
                0, 1 << (14 if bits == 16 else 24), (c,), generator=gen,
                device=dev), 32)
            out = ps.partial_sum(packed, wq, fanout=fanout, word_bits=bits)
            plain = ps.partial_sum_plain(packed, wq, fanout=fanout,
                                         word_bits=bits)
            torch.cuda.synchronize()
            record("partial_sum", *_same_words(out, plain),
                   f"bits={bits} C={c} fanout={fanout} R={r}", r)
            del packed, out, plain
    # #10: G in {1, 2, 3, 5}, sibling below and equal to G, masks on and
    # off, with and without a participation-folded sign matrix.
    grid = [(4, 4, 1, 8), (4, 2, 2, 8), (9, 3, 3, 8), (10, 2, 2, 8),
            (10, 2, 5, 8), (7, 4, 2, 8), (N_WORKERS, 4, 3, r_main)]
    t = torch.tensor(3, dtype=torch.int32, device=dev)
    for bits in (16, 32):
        for c, fanout, sib, r in grid:
            g = -(-c // fanout)
            words = _rand_words(torch, (c, r, 512), bits, gen, dev)
            keys = pvm.pair_stream_keys(pvm.tree_level_seed(0, 1), g, t)
            act = (torch.arange(g, device=dev) % 3 != 1).float()
            for part in (None, act):
                signs = pvm.tree_pair_signs(g, sib, participation=part,
                                            device=dev)
                for use_masks in (True, False):
                    kw = dict(fanout=fanout, sibling=sib,
                              use_masks=use_masks)
                    out = ps.masked_partial_sum(words, keys, signs, **kw)
                    plain = ps.masked_partial_sum_plain(words, keys, signs,
                                                        **kw)
                    torch.cuda.synchronize()
                    record("masked_partial_sum", *_same_words(out, plain),
                           f"bits={bits} C={c} fanout={fanout} sibling="
                           f"{sib} R={r} part={part is not None} "
                           f"masks={use_masks}", r)
                    del out, plain
            del words
        # A fully dropped subtree: leaves 4..7 sent zero words and their
        # level-1 nodes are inactive, so those partials are exactly zero.
        words = _rand_words(torch, (8, 8, 512), bits, gen, dev)
        words.view(torch.int16 if bits == 16 else torch.int32)[4:] = 0
        act = torch.tensor([1.0, 1.0, 0.0, 0.0], device=dev)
        keys = pvm.pair_stream_keys(pvm.tree_level_seed(0, 1), 4, t)
        signs = pvm.tree_pair_signs(4, 2, participation=act, device=dev)
        out = ps.masked_partial_sum(words, keys, signs, fanout=2, sibling=2)
        plain = ps.masked_partial_sum_plain(words, keys, signs, fanout=2,
                                            sibling=2)
        torch.cuda.synchronize()
        record("masked_partial_sum", *_same_words(out, plain),
               f"bits={bits} dropped subtree", 8)
        check(not bool((pvm.as_u64(out[2:]) != 0).any()),
              f"a dropped subtree's partial is not zero at {bits} bits")
        check(bool((pvm.as_u64(out[:2]) != 0).any()), "live partials zero")
    # The plain tree slice's interior levels at full R: uint32 words, masks
    # off, 5 partials into 3 and 3 into 2 (ragged), fanout and sibling 2.
    for c in (5, 3):
        g = -(-c // TREE_FANOUT)
        words = _rand_words(torch, (c, r_main, 512), 32, gen, dev)
        kw = dict(fanout=TREE_FANOUT, sibling=TREE_FANOUT, use_masks=False)
        out = ps.masked_partial_sum(words, *rd._no_masks(g, dev), **kw)
        plain = ps.masked_partial_sum_plain(words, *rd._no_masks(g, dev),
                                            **kw)
        torch.cuda.synchronize()
        record("masked_partial_sum_off", *_same_words(out, plain),
               f"bits=32 C={c} fanout={TREE_FANOUT} masks off R={r_main}",
               r_main)
        del words, out, plain
    # #8: P in {1, 3, 9, 45} and the main path's 13 sibling pairs, random
    # coefficients in {-1, 0, 1} and all zero (the identity), at R = 1, 8,
    # 17 (not a multiple of a block's 1,024 chunks: 16 rows at 16 bits, 8
    # at 32) and the main path's R; each out of place (y not written), in
    # place (out=y, the tree's form) and write-only (y None, the flat
    # wire's form, against the plain twin of a zero row).
    for bits in (16, 32):
        for p, r in ((1, 8), (3, 8), (9, 8), (45, 8), (13, 1), (13, 17),
                     (13, r_main)):
            y = _rand_words(torch, (r, 512), bits, gen, dev)
            keys = pvm.to_words(torch.randint(0, 1 << 31, (p,),
                                              generator=gen, device=dev), 32)
            rand = torch.randint(-1, 2, (p,), generator=gen, device=dev,
                                 dtype=torch.int32)
            for coeff in (rand, torch.zeros_like(rand)):
                plain = mw.mask_repair_plain(y, keys, coeff)
                out = mw.mask_repair(y, keys, coeff)
                inplace = y.clone()
                mw.mask_repair(inplace, keys, coeff, out=inplace)
                alone = torch.full_like(y, 7)
                mw.mask_repair(None, keys, coeff, out=alone)
                term = mw.mask_repair_plain(torch.zeros_like(y), keys, coeff)
                torch.cuda.synchronize()
                where = f"bits={bits} P={p} R={r}"
                ok, diff = _same_words(out, plain)
                record("mask_repair", ok and out.data_ptr() != y.data_ptr(),
                       diff, where, r)
                record("mask_repair", *_same_words(inplace, plain),
                       where + " in place", r)
                record("mask_repair", *_same_words(alone, term),
                       where + " write-only", r)
                if not bool(coeff.any()):
                    check(_same_words(out, y)[0],
                          f"zero coefficients changed the words at {bits}")
                del out, plain, inplace, alone, term
            del y
    # #7 at the tree roots' shapes beside N = 10 pilot rows: C = 3 rows at
    # 16/32 bits and the privacy wire's scale (the masked tree's root), and
    # C = 2 uint32 rows at scale 2**-24 (the plain tree's root).
    q, p1, p2, _beta, _w, k = _inputs(torch, N_WORKERS, r_main, gen, dev)
    roots = [(3, bits, 14, PrivacySpec(modulus_bits=bits,
                                       dp_epsilon=DP_EPSILON).scale_mult)
             for bits in (16, 32)]
    roots.append((2, rd.TREE_PLAIN_WORD_BITS, rd.TREE_PLAIN_FIXPOINT_BITS,
                  2.0 ** -rd.TREE_PLAIN_FIXPOINT_BITS))
    for c, bits, wq_bits, smult in roots:
        words = _rand_words(torch, (c, r_main, 512), bits, gen, dev)
        sum_wq = pvm.to_words(torch.randint(0, 1 << wq_bits, (),
                                            generator=gen, device=dev), 32)
        for t in (1, 2):
            tt = torch.tensor(t, dtype=torch.int32, device=dev)
            out = mw.masked_master_update(q, k, words, sum_wq, p1, p2, tt,
                                          0.01, smult)
            ref = mw.masked_master_update_plain(q, k, words, sum_wq, p1, p2,
                                                tt, 0.01, smult)
            torch.cuda.synchronize()
            record("master_masked_tree",
                   torch.equal(out.view(torch.int32), ref.view(torch.int32))
                   and bool(torch.isfinite(out).all()),
                   float((out - ref).abs().max()),
                   f"C={c} N={N_WORKERS} bits={bits} scale={smult} t={t}",
                   r_main)
            del out, ref
        del words
    del q, p1, p2
    print(f"kernels: partial_sum ({cases['partial_sum']} cases), "
          f"masked_partial_sum ({cases['masked_partial_sum']}, a dropped "
          f"subtree's partial exactly zero; "
          f"{cases['masked_partial_sum_off']} more at the plain tree's "
          f"interior levels), mask_repair ({cases['mask_repair']}: out of "
          f"place, in place and write-only; zero coefficients the "
          f"identity) and the masked master over C = 3 "
          f"and C = 2 rows beside N = {N_WORKERS} "
          f"({cases['master_masked_tree']}) bitwise equal to their plain "
          f"versions", flush=True)
    return errs


def _federation(n_workers, n_samples, n_features, n_classes, seed,
                uniform: bool = False):
    """Workers on synthetic data: the paper's random shares, or with
    ``uniform`` equal contiguous shards."""
    import numpy as np

    from repro_torch.data.pipeline import federated_loaders
    from repro_torch.data.synthetic import (SyntheticClassification,
                                            random_share_split)
    from repro_torch.fed.worker import Worker, make_worker_configs
    from repro_torch.models.mlp import mlp_loss_and_grad
    x, y = SyntheticClassification(n_samples=n_samples,
                                   n_features=n_features,
                                   n_classes=n_classes,
                                   seed=seed).generate()
    per = n_samples // n_workers
    splits = ([np.arange(k * per, (k + 1) * per) for k in range(n_workers)]
              if uniform else
              random_share_split(y, n_workers=n_workers, seed=seed + 1))
    loaders = federated_loaders((x, y), splits, seed=seed + 2)
    cfgs = make_worker_configs(n_workers, [len(s) for s in splits],
                               seed=seed + 3)
    return [Worker(cfg=cfgs[k], loader=loaders[k],
                   loss_and_grad=mlp_loss_and_grad)
            for k in range(n_workers)]


class Drive(NamedTuple):
    """What ``_drive`` measured of one run."""
    res: object                   # the simulator's SimResult
    launches: dict                # kernel kind -> launches in the run
    agg_s: list                   # each aggregation call's seconds
    train_s: list                 # each worker's local training's seconds
    wall: float                   # the whole call's seconds
    round_s: list                 # each round's seconds (``marks`` only)
    allocs: tuple                 # (device allocations, retries) in the run


def _drive(torch, sim, rounds: int, *args, method: str = "run_fedpc",
           capture: list | None = None, marks: bool = False,
           **kw) -> Drive:
    """``sim.<method>(rounds, *args, **kw)`` with every launch counter set
    to 0 just before and read just after. Each worker's local training is
    timed between syncs, as is each round's aggregation: ``round_step``
    for ``run_fedpc``, under sync-debug "error" (any host sync inside it
    raises), and ``fedavg_aggregate`` for ``run_fedavg``. With ``capture``
    a list, each aggregation's inputs and output are appended to it:
    ``(state, worker buffers, costs, sizes, new buffer, info)`` for
    ``round_step``, ``(local models, sizes, new model)`` for FedAvg. With
    ``marks`` the rounds run with ``eval_every=1``, each clocked at its
    end, synchronized, through ``eval_fn``."""
    from repro_torch.core import baselines as bl
    from repro_torch.fed import rounds as rd
    from repro_torch.fed.worker import Worker
    agg_s: list[float] = []
    train_s: list[float] = []
    ends: list[float] = []
    owner, name = {"run_fedpc": (rd.WirePath, "round_step"),
                   "run_fedavg": (bl, "fedavg_aggregate")}.get(
                       method, (None, None))
    inner_agg = getattr(owner, name) if owner is not None else None
    inner_train = Worker.train_round_device
    wire = owner is rd.WirePath

    def aggregate(*a, **k):
        if wire and a[2].device.type == "meta":    # the set-up audit's run
            return inner_agg(*a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if wire:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = inner_agg(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        agg_s.append(time.perf_counter() - t0)
        if capture is not None:
            capture.append((*a[1:5], out[1], out[2]) if wire else (*a, out))
        return out

    def timed_train(self, params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_train(self, params)
        torch.cuda.synchronize()
        train_s.append(time.perf_counter() - t0)
        return out

    def end(_params):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    if marks:
        kw["eval_every"] = 1
        sim.eval_fn = end
    if owner is not None:
        setattr(owner, name, aggregate)
    Worker.train_round_device = timed_train
    before = _allocs(torch)
    try:
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = getattr(sim, method)(rounds, *args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
    finally:
        if owner is not None:
            setattr(owner, name, inner_agg)
        Worker.train_round_device = inner_train
    allocs = tuple(b - a for a, b in zip(before, _allocs(torch)))
    if owner is not None:
        check(len(agg_s) == rounds, f"{name} ran {len(agg_s)} times")
    if marks:
        check(len(ends) == rounds, f"{len(ends)} rounds marked")
    round_s = [b - a for a, b in zip([t0, *ends], ends)]
    return Drive(res, launches, agg_s, train_s, wall, round_s, allocs)


def _allocs(torch) -> tuple[int, int]:
    """The caching allocator's device allocations (``cudaMalloc`` calls)
    and its retries after a failed one (each frees the cache first) so
    far."""
    stats = torch.cuda.memory_stats()
    return stats.get("num_device_alloc", -1), stats.get("num_alloc_retries",
                                                         -1)


def _check_run(torch, res, launches: dict, on_path: dict,
               want_bytes: list, workers, label: str, rounds: int = ROUNDS,
               driver: str = "run_fedpc",
               synced: str = "round_step") -> dict:
    """The checks common to every slice: each kernel of ``on_path`` (kind
    → launches in the run) launched that often and every other kernel
    never. Returns the launch counts of the path's own kernels."""
    import numpy as np

    from repro_torch.core import flat as fl
    from repro_torch.telemetry import trace as tmt
    from repro_torch.utils import tree_leaves, tree_size
    for k, v in launches.items():
        want = on_path.get(k, 0)
        check(v == want, f"{label}: {k} launched {v} times in {rounds} "
              f"rounds, expected {want}")
    check(all(np.isfinite(res.costs)), f"{label}: costs not finite: "
          f"{res.costs}")
    check(res.bytes_per_round == want_bytes,
          f"{label}: bytes per round {res.bytes_per_round} != {want_bytes}")
    check(all(0 <= k < len(workers) for k in res.pilot_history),
          "bad pilot")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(res.params)),
          f"{label}: global model not finite")
    check(int(res.round_state.round) == rounds + 1, "round counter")
    # The bytes above are the trace's: build_trace held the device's
    # counts to the host's ledger; summarize derives them once more.
    check(res.telemetry is not None and len(res.telemetry.rounds) == rounds
          and int(res.round_state.telemetry.rounds) == rounds,
          f"{label}: no telemetry trace of every round")
    tmt.summarize(res.telemetry.events())
    print(f"{label}: {driver} {tree_size(res.params):,} params x "
          f"{len(workers)} workers, rows {fl.layout_of(res.params).rows}, "
          f"sizes {[w.loader.n for w in workers]}; costs "
          f"{[round(c, 5) for c in res.costs]}; pilots {res.pilot_history}; "
          f"bytes/round {[round(b) for b in want_bytes]} (the trace's, "
          f"cross-checked); launches {launches}; {synced} under sync-debug "
          f"'error' with no sync", flush=True)
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


def _small_agrees(torch, dev, cfg, label: str, method: str = "run_fedpc",
                  **sim_kw) -> None:
    """A quickstart-size federation on the card and on the CPU (plain
    versions) must agree: same pilots, costs within float32 drift.
    ``method`` is the simulator's driver, ``sim_kw`` more arguments of
    the simulator (``evade_streak``)."""
    import numpy as np

    from repro_torch.fed.simulator import FedSimulator
    from repro_torch.models.mlp import init_mlp_classifier
    runs = []
    for d in (dev, torch.device("cpu")):
        ws = _federation(3, 1500, 24, 6, SEED)
        p = init_mlp_classifier(torch.Generator().manual_seed(SEED), 24, 6,
                                device=d)
        sim = FedSimulator(ws, p, cfg, device=d, **sim_kw)
        runs.append(getattr(sim, method)(rounds=5))
    check(runs[0].pilot_history == runs[1].pilot_history,
          f"{label}: pilots card {runs[0].pilot_history} cpu "
          f"{runs[1].pilot_history}")
    check(np.allclose(runs[0].costs, runs[1].costs, rtol=1e-3),
          f"{label}: costs card {runs[0].costs} cpu {runs[1].costs}")
    print(f"{label}: card and CPU agree, pilots {runs[0].pilot_history}",
          flush=True)


def _full_width(torch, dev, uniform: bool = False):
    from repro_torch.core import flat as fl
    from repro_torch.models.mlp import init_mlp_classifier
    from repro_torch.utils import tree_size
    workers = _federation(N_WORKERS, N_WORKERS * SCAN_SHARD, N_FEATURES,
                          N_CLASSES, SEED, uniform)
    params = init_mlp_classifier(torch.Generator().manual_seed(SEED),
                                 N_FEATURES, N_CLASSES, HIDDEN, device=dev)
    check(tree_size(params) == N_PARAMS, f"{tree_size(params)} params")
    check(fl.layout_of(params).rows == ROWS, "unexpected flat rows")
    return workers, params


def phase_slice(torch, dev, capture: list) -> dict:
    """The plain round at full width; returns its launch counts and leaves
    each round's inputs in ``capture`` (``_drive``), the flat layout last."""
    from repro_torch.core import flat as fl
    from repro_torch.core import protocol as proto
    from repro_torch.fed.simulator import FedSimulator
    workers, params = _full_width(torch, dev)
    sim = FedSimulator(workers, params, device=dev)
    res, launches, step_s, train_s, wall, *_ = _drive(
        torch, sim, ROUNDS, capture=capture)
    capture.append(fl.layout_of(params))
    want = proto.fedpc_bytes_per_round(proto.model_size_bytes(params),
                                       N_WORKERS)
    own = _check_run(torch, res, launches,
                     {"uplink_stacked": ROUNDS, "master": ROUNDS},
                     [want] * ROUNDS, workers, "slice")
    _print_round("round", step_s, train_s, wall, workers)
    _small_agrees(torch, dev, None, "small")
    return own


def _smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip()


def _drive_scan(torch, sim, rounds: int, **kw):
    """``sim.run_fedpc_scan(rounds, **kw)`` with every launch counter set
    to 0 just before and read just after, and the whole round loop
    (``rounds.scan_rounds``: local training and ``round_step``, every
    round) under sync-debug "error" and timed between syncs. Returns
    (result, launches, loop_s, wall_s)."""
    from repro_torch.fed import rounds as rd
    inner = rd.scan_rounds
    loop_s: list[float] = []

    def guarded(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = inner(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t0)
        return out

    rd.scan_rounds = guarded
    try:
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run_fedpc_scan(rounds, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
    finally:
        rd.scan_rounds = inner
    check(len(loop_s) == 1, f"scan_rounds ran {len(loop_s)} times")
    return res, launches, loop_s[0], wall


def _same_runs(torch, a, b, label: str) -> None:
    """Two drivers' results: pilots, costs, bytes and every leaf equal."""
    from repro_torch.utils import tree_leaves
    check(a.pilot_history == b.pilot_history,
          f"{label}: pilots {a.pilot_history} != {b.pilot_history}")
    check(a.costs == b.costs, f"{label}: costs {a.costs} != {b.costs}")
    check(a.bytes_per_round == b.bytes_per_round, f"{label}: bytes")
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        check(torch.equal(x, y), f"{label}: a leaf differs")


def _graph_equals_eager(torch, worker, params, dev) -> int:
    """One worker's captured step replayed against the same step called
    eagerly, from the same inputs, over one round of its batches:
    params, optimizer state, step and loss sum bitwise. Returns the
    round's steps."""
    from repro_torch.utils import tree_leaves, tree_map
    idx = torch.from_numpy(worker.round_indices()).to(dev)
    batches = worker.gather(idx)
    opt0 = tree_map(torch.clone, worker.opt_state)
    step0 = torch.tensor(worker.step, dtype=torch.int32, device=dev)
    ts = worker.train_step(params, opt0, batches)
    check(ts.graph is not None, "the worker's step was not captured")
    outs = []
    for replay in (True, False):
        ts.load(params, opt0, step0, batches)
        for _ in range(idx.shape[0]):
            if replay:
                ts.graph.replay()
            else:
                ts()
        outs.append([x.clone() for x in tree_leaves(
            (ts.params, ts.opt_state, ts.step, ts.total))])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        check(torch.equal(a, b), "graph replay != eager step")
    return idx.shape[0]


def _release(torch) -> None:
    """Free a dropped federation's graphs and buffers before the next."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def phase_scan_slice(torch, dev) -> dict:
    """The scan driver and the graphed local training at full width.

    (a) ``run_fedpc`` and ``run_fedpc_scan`` on two fresh, equal
    federations (equal contiguous shards, every one uniform): pilots,
    costs, bytes and every leaf bitwise; each run launches
    ``uplink_stacked`` and ``master`` once a round and nothing else; the
    scan driver's whole round loop under sync-debug "error". (b) the same
    with ``participation=0.6`` on the plain wire and, for two rounds, on
    the masked wire (16-bit, DP epsilon 2), with Eq. (8) bytes of the
    sampled count. (c) one worker's graphed step against the same step
    called eagerly. (d) local training per round through the graph and
    through the eager per-batch loop (``train_round_eager``, called
    directly) on the same shards, and each driver's round wall time.
    Returns the launch counts of all the phase's runs."""
    from repro_torch import prng
    from repro_torch.core import protocol as proto
    from repro_torch.core.fedpc import FedPCConfig
    from repro_torch.fed import rounds as rd
    from repro_torch.fed.simulator import FedSimulator
    from repro_torch.privacy.spec import PrivacySpec
    own: dict = {}

    def add(launches: dict) -> None:
        for k, v in launches.items():
            if v:
                own[k] = own.get(k, 0) + v

    plain = {"uplink_stacked": ROUNDS, "master": ROUNDS}
    card = _smi()
    # (a), the Python driver, with (c) and (d) on its workers
    workers, params = _full_width(torch, dev, uniform=True)
    check(all(w.uniform_batches for w in workers), "a ragged shard")
    mb = proto.model_size_bytes(params)
    want = [proto.fedpc_bytes_per_round(mb, N_WORKERS)] * ROUNDS
    sim = FedSimulator(workers, params, device=dev)
    res_py, launches, step_s, train_s, wall_py, *_ = _drive(
        torch, sim, ROUNDS)
    add(_check_run(torch, res_py, launches, plain, want, workers,
                   "scan slice"))
    steps = _graph_equals_eager(torch, workers[0], res_py.params, dev)
    print(f"scan slice (c): worker 0's graphed step == its eager step, "
          f"bitwise, over {steps} steps (params, optimizer state, step, "
          f"loss sum)", flush=True)
    eager_s = []
    for w in workers:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w.train_round_eager(res_py.params)
        torch.cuda.synchronize()
        eager_s.append(time.perf_counter() - t0)
    per_round = [sum(train_s[i * N_WORKERS:(i + 1) * N_WORKERS]) * 1e3
                 for i in range(ROUNDS)]
    del sim, workers
    _release(torch)
    # (a), the scan driver
    workers, params = _full_width(torch, dev, uniform=True)
    sim = FedSimulator(workers, params, device=dev)
    res_scan, launches, loop_s, wall_scan = _drive_scan(torch, sim, ROUNDS)
    add(_check_run(torch, res_scan, launches, plain, want, workers,
                   "scan slice", driver="run_fedpc_scan",
                   synced="the whole round loop"))
    _same_runs(torch, res_py, res_scan, "scan slice (a)")
    print(f"scan slice (a): run_fedpc == run_fedpc_scan bitwise (pilots, "
          f"costs, bytes, all {N_PARAMS:,} params)", flush=True)
    print(f"scan slice (d) on {card}: local training per round, "
          f"{N_WORKERS} workers x {SCAN_SHARD} samples, graphed "
          f"{[round(x, 1) for x in per_round]} ms (round 1 captures each "
          f"worker's graph), eager per-batch loop on the same shards "
          f"{sum(eager_s) * 1e3:.1f} ms; round wall time run_fedpc "
          f"{wall_py / ROUNDS * 1e3:.1f} ms, run_fedpc_scan "
          f"{wall_scan / ROUNDS * 1e3:.1f} ms (its round loop "
          f"{loop_s / ROUNDS * 1e3:.1f} ms, set-up and capture "
          f"{(wall_scan - loop_s) * 1e3:.1f} ms)", flush=True)
    del sim, workers, res_py, res_scan
    _release(torch)
    # (b) partial participation, plain and masked
    spec = PrivacySpec(dp_epsilon=DP_EPSILON, enforce=False)
    n_part = max(1, round(SCAN_PARTICIPATION * N_WORKERS))
    kw = dict(participation=SCAN_PARTICIPATION, participation_seed=SEED)
    for label, cfg, rounds, wire_bytes, on_path in (
            ("plain", None, ROUNDS, proto.fedpc_bytes_per_round(mb, n_part),
             plain),
            ("masked", FedPCConfig(n_workers=N_WORKERS, privacy=spec),
             SCAN_MASKED_ROUNDS,
             proto.fedpc_masked_bytes_per_round(mb, n_part, word_bits=16),
             {"uplink_masked": SCAN_MASKED_ROUNDS,
              "master_masked": SCAN_MASKED_ROUNDS})):
        masks = rd.participation_masks(prng.PRNGKey(SEED), rounds,
                                       N_WORKERS, SCAN_PARTICIPATION).numpy()
        out = {}
        for driver in ("run_fedpc", "run_fedpc_scan"):
            workers, params = _full_width(torch, dev, uniform=True)
            sim = FedSimulator(workers, params, cfg, device=dev)
            if driver == "run_fedpc":
                res, launches, _, _, wall, *_ = _drive(torch, sim, rounds,
                                                       **kw)
                synced = "round_step"
            else:
                res, launches, _, wall = _drive_scan(torch, sim, rounds,
                                                     **kw)
                synced = "the whole round loop"
            add(_check_run(torch, res, launches, on_path,
                           [wire_bytes] * rounds, workers,
                           f"scan slice (b) {label}, participation "
                           f"{SCAN_PARTICIPATION}", rounds=rounds,
                           driver=driver, synced=synced))
            check(all(masks[i][k] > 0
                      for i, k in enumerate(res.pilot_history)),
                  "a pilot that was not sampled")
            out[driver] = res
            del sim, workers
            _release(torch)
        _same_runs(torch, out["run_fedpc"], out["run_fedpc_scan"],
                   f"scan slice (b) {label}")
        print(f"scan slice (b) {label}: run_fedpc == run_fedpc_scan bitwise "
              f"with {n_part} of {N_WORKERS} workers sampled a round "
              f"(masks {masks.astype(int).tolist()})", flush=True)
    return own


def _ms(xs) -> list:
    return [round(x * 1e3, 1) for x in xs]


def _per_round(xs: list, n: int) -> list:
    """Times of one call a worker, summed a round."""
    return [sum(xs[i:i + n]) for i in range(0, len(xs), n)]


def _second_oracle(torch, kept: tuple, layout) -> tuple[int, float]:
    """``core.fedpc.master_round`` over a captured round's local models
    as trees against ``WirePath.round_step``'s new buffer (kernels
    #1 and #2): the same pilot; each new parameter within 2 ulps of its
    own magnitude (rtol 2^-22) and 1e-8: the kernel rounds ``q −
    coeff·mult`` once, as an FMA, the trees twice, and the two sum
    ``Σ p_k·beta·T_k`` in their own orders. Returns (t, max abs diff)."""
    from repro_torch.core import fedpc as cfp
    from repro_torch.core import flat as fl
    from repro_torch.utils import tree_leaves, tree_map
    state, bufs_q, costs, sizes, new_buf, info = kept
    n = bufs_q.shape[0]
    stacked = tree_map(lambda *xs: torch.stack(xs),
                       *[fl.unflatten_tree(bufs_q[k], layout)
                         for k in range(n)])
    ref_state = cfp.FedPCState(
        params=fl.unflatten_tree(state.buf_p1, layout),
        params_prev=fl.unflatten_tree(state.buf_p2, layout),
        prev_costs=state.prev_costs, round=state.round)
    new_state, aux = cfp.master_round(cfp.FedPCConfig(n_workers=n),
                                      ref_state, stacked, costs, sizes)
    t = int(state.round)
    check(int(aux["k_star"]) == int(info["k_star"]),
          f"round {t}: master_round's pilot {int(aux['k_star'])} != "
          f"round_step's {int(info['k_star'])}")
    worst = 0.0
    for got, want in zip(tree_leaves(fl.unflatten_tree(new_buf, layout)),
                         tree_leaves(new_state.params)):
        diff = (got - want).abs()
        check(bool((diff <= want.abs() * 2.0 ** -22 + 1e-8).all()),
              f"round {t}: the kernels' new params differ from "
              f"master_round's by up to {float(diff.max()):.3e}")
        worst = max(worst, float(diff.max()))
    return t, worst


def phase_baselines_slice(torch, dev, rate: float) -> dict:
    """The paper's comparison path at full width, on the scan slice's
    federation (equal 1,024-sample shards, graphed local training).

    (a) ``run_fedpc`` with ``evade_streak`` 2 for 6 rounds: one uplink
    and one master launch a round and nothing else, ``round_step`` under
    sync-debug "error", Eq. (8) bytes, the ledger's pilot uploads == the
    pilot history, no pilot streak over 4; a quickstart-size run with the
    defence picks the same pilots on the card and on the CPU. (b)
    ``run_fedavg`` and ``run_phong`` for 2 rounds, ``run_centralized`` for
    2 on the union of the shards (batch 64): no kernel launches, finite
    costs, 2VN and 0 bytes; quickstart-size FedAvg and Phong agree on the
    card and on the CPU. (c) ``fedavg_aggregate`` of the ten local models
    of FedAvg's first round on the card == on the CPU, bitwise. (d)
    ``core.fedpc.master_round`` over every round of (a) as trees ==
    ``round_step`` (``_second_oracle``). (e) each algorithm's round wall
    time, local training and aggregation, beside the card's name and
    power limit. Returns (a)'s launch counts."""
    import numpy as np

    from repro_torch.core import baselines as bl
    from repro_torch.core import flat as fl
    from repro_torch.core import protocol as proto
    from repro_torch.data.pipeline import BatchIterator
    from repro_torch.data.synthetic import SyntheticClassification
    from repro_torch.fed.simulator import FedSimulator
    from repro_torch.fed.worker import Worker, WorkerConfig
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_and_grad
    from repro_torch.utils import tree_leaves, tree_map, tree_weighted_sum
    card = _smi()
    # (a) the evasion defence, every round kept for (d)
    workers, params = _full_width(torch, dev, uniform=True)
    layout = fl.layout_of(params)
    mb = proto.model_size_bytes(params)
    sim = FedSimulator(workers, params, evade_streak=EVADE_STREAK,
                       device=dev)
    kept: list = []
    res, launches, step_s, train_s, _, round_s, allocs = _drive(
        torch, sim, EVADE_ROUNDS, capture=kept, marks=True)
    want = proto.fedpc_bytes_per_round(mb, N_WORKERS)
    own = _check_run(torch, res, launches,
                     {"uplink_stacked": EVADE_ROUNDS,
                      "master": EVADE_ROUNDS},
                     [want] * EVADE_ROUNDS, workers,
                     "baselines slice (a) evade_streak 2",
                     rounds=EVADE_ROUNDS)
    pilots = [(r, w) for (r, w, k, _) in sim.ledger.events
              if k == "pilot_params"]
    check(pilots == list(enumerate(res.pilot_history, start=1)),
          f"ledger pilots {pilots} != history {res.pilot_history}")
    longest = cur = 1
    for a, b in zip(res.pilot_history, res.pilot_history[1:]):
        cur = cur + 1 if a == b else 1
        longest = max(longest, cur)
    check(longest <= 4, f"a pilot streak of {longest} rounds")
    evaders = [k for k in range(N_WORKERS)
               if sim.ledger.consecutive_pilot_streak(k) >= EVADE_STREAK]
    print(f"baselines slice (a): {want:,} bytes a round (Eq. (8)); ledger "
          f"pilot uploads == pilot history; longest streak {longest}; "
          f"workers evading after the run {evaders}", flush=True)
    _small_agrees(torch, dev, None, "baselines slice (a) small, evasion",
                  evade_streak=EVADE_STREAK)
    oracle = [_second_oracle(torch, k, layout) for k in kept]
    print(f"baselines slice (d): core.fedpc.master_round over the ten "
          f"local models as trees == round_step's kernels #1/#2: the same "
          f"pilot, new params within 2 ulps + 1e-8, max abs diff "
          f"{', '.join(f'round {t} {d:.3e}' for t, d in oracle)}",
          flush=True)
    times = {"FedPC with evasion": (round_s, _per_round(train_s, N_WORKERS),
                                    "round_step", step_s, allocs)}
    del sim, workers, kept, oracle, res
    _release(torch)
    # (b) FedAvg and Phong, with (c) on FedAvg's first round
    fedavg = proto.fedavg_bytes_per_round(mb, N_WORKERS)
    check(proto.phong_bytes_per_round(mb, N_WORKERS) == fedavg, "2VN")
    for method in ("run_fedavg", "run_phong"):
        workers, params = _full_width(torch, dev, uniform=True)
        sim = FedSimulator(workers, params, device=dev)
        kept = []
        res, launches, agg_s, train_s, _, round_s, allocs = _drive(
            torch, sim, BASELINE_ROUNDS, method=method, capture=kept,
            marks=True)
        check(not any(launches.values()), f"{method} launched {launches}")
        check(all(np.isfinite(res.costs)), f"{method}: costs {res.costs}")
        check(res.bytes_per_round == [fedavg] * BASELINE_ROUNDS,
              f"{method}: bytes {res.bytes_per_round}")
        check(all(bool(torch.isfinite(p).all())
                  for p in tree_leaves(res.params)), f"{method}: params")
        training = _per_round(train_s, N_WORKERS)
        if method == "run_fedavg":
            local, sizes, out = kept[0]
            cpu = bl.fedavg_aggregate(
                [tree_map(lambda x: x.cpu(), q) for q in local], sizes)
            for a, b in zip(tree_leaves(out), tree_leaves(cpu)):
                check(torch.equal(a.cpu(), b),
                      "fedavg_aggregate: card != CPU")
            # The call copies the host's sizes to the card, which waits
            # for the stream: the device time is the sum's alone, one call
            # (114 launches) at a time, since ten would fill the card's
            # launch queue behind the sleep and block the host.
            shares = torch.as_tensor(sizes, device=dev)
            weights = list(shares / shares.sum())
            dev_ms = _median_ms(
                torch, lambda: tree_weighted_sum(local, weights),
                queued=True, calls=1)
            call_ms = _median_ms(torch,
                                 lambda: bl.fedavg_aggregate(local, sizes))
            print(f"baselines slice (c): fedavg_aggregate of the ten "
                  f"{N_PARAMS:,}-param local models of round 1 on the "
                  f"card == on the CPU, bitwise; its sum {dev_ms:.4f} ms on "
                  f"the device (queued, L2 scrubbed), {call_ms:.4f} ms a "
                  f"call (the weights copied from the host included); "
                  f"bound {11 * mb / rate * 1e3:.4f} ms by bytes "
                  f"({11 * mb / 1e9:.3f} GB: read the {N_WORKERS} models "
                  f"of {mb:,} B, write 1, 11 V), "
                  f"{11 * mb / rate / (dev_ms * 1e-3):.1%} of it; the eager "
                  f"op sequence moves 47 V ({47 * mb / 1e9:.3f} GB, 10 "
                  f"products and 9 sums each written and read back), "
                  f"{47 * mb / rate * 1e3:.4f} ms at the same rate",
                  flush=True)
            times["FedAvg"] = (round_s, training, "weighted sum", agg_s,
                               allocs)
            del local, sizes, out, cpu
        else:
            times["Phong"] = (round_s, training, None, None, allocs)
        print(f"baselines slice (b) {method}: {N_PARAMS:,} params x "
              f"{N_WORKERS} workers; costs "
              f"{[round(c, 5) for c in res.costs]}; bytes/round "
              f"{[round(b) for b in res.bytes_per_round]}; launches 0",
              flush=True)
        del sim, workers, res, kept
        _release(torch)
    # (b) the centralized bound on the union of the shards
    x, y = SyntheticClassification(n_samples=N_WORKERS * SCAN_SHARD,
                                   n_features=N_FEATURES,
                                   n_classes=N_CLASSES,
                                   seed=SEED).generate()
    steps = len(x) // CENTRAL_BATCH
    central = Worker(
        cfg=WorkerConfig(worker_id=0, batch_size=CENTRAL_BATCH,
                         lr_decay_every=10 * steps, seed=SEED),
        loader=BatchIterator((x, y), CENTRAL_BATCH, seed=SEED),
        loss_and_grad=mlp_loss_and_grad)
    params = init_mlp_classifier(torch.Generator().manual_seed(SEED),
                                 N_FEATURES, N_CLASSES, HIDDEN, device=dev)
    sim = FedSimulator([central], params, device=dev)
    res, launches, _, train_s, _, round_s, allocs = _drive(
        torch, sim, BASELINE_ROUNDS, central, method="run_centralized",
        marks=True)
    check(not any(launches.values()), f"centralized launched {launches}")
    check(all(np.isfinite(res.costs)), f"centralized: costs {res.costs}")
    check(res.bytes_per_round == [0.0] * BASELINE_ROUNDS, "centralized bytes")
    check(central.step == BASELINE_ROUNDS * steps, "centralized steps")
    times["centralized, 1 worker"] = (round_s, train_s, None, None, allocs)
    print(f"baselines slice (b) run_centralized: {len(x):,} samples, batch "
          f"{CENTRAL_BATCH} ({steps} steps a round); costs "
          f"{[round(c, 5) for c in res.costs]}; bytes/round 0; launches 0",
          flush=True)
    del sim, central, res, x, y
    _release(torch)
    red = proto.reduction_vs_fedavg(mb, N_WORKERS)
    check(red == 0.421875, f"reduction_vs_fedavg {red}")
    print(f"baselines slice (b): FedPC {want:,} bytes a round against "
          f"FedAvg/Phong {fedavg:,}: reduction_vs_fedavg(V, {N_WORKERS}) = "
          f"{red} (the paper: 42.20%)", flush=True)
    _small_agrees(torch, dev, None, "baselines slice (b) small, FedAvg",
                  method="run_fedavg")
    _small_agrees(torch, dev, None, "baselines slice (b) small, Phong",
                  method="run_phong")
    # (e) the rest: FedPC's stack/flatten/unflatten and the ledger's
    # host work, FedAvg's the same around its sum, Phong's the hand-off
    for name, (round_s, training, part, agg, allocs) in times.items():
        rest = [r - tr - (agg[i] if agg else 0.0)
                for i, (r, tr) in enumerate(zip(round_s, training))]
        print(f"baselines slice (e) on {card}: {name}, {N_PARAMS:,} "
              f"params, rounds 1..{len(round_s)} (round 1 captures the "
              f"graphs): round wall time {_ms(round_s)} ms = local "
              f"training {_ms(training)} ms"
              + (f" + {part} {[round(a * 1e3, 3) for a in agg]} ms"
                 if agg else "")
              + f" + {'the hand-off' if name == 'Phong' else 'the rest'} "
              f"{_ms(rest)} ms; {allocs[0]} device allocations and "
              f"{allocs[1]} allocation retries in the run", flush=True)
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
    res, launches, step_s, train_s, wall, *_ = _drive(torch, sim, ROUNDS)
    want = proto.fedpc_masked_bytes_per_round(
        proto.model_size_bytes(params), N_WORKERS, word_bits=16)
    own = _check_run(torch, res, launches,
                     {"uplink_masked": ROUNDS, "master_masked": ROUNDS},
                     [want] * ROUNDS, workers, "masked slice")
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


FAULTS = dict(seed=0, drop_before_uplink=0.05, drop_after_uplink=0.15,
              straggler=0.05)             # the masked tree slice's plan
TREE_FANOUT, MASKED_TREE_FANOUT = 2, 4


def phase_tree_slice(torch, dev) -> dict:
    """The plain round through a fan-in tree of fanout 2 (widths 10, 5, 3,
    2) at full width; returns its launch counts."""
    from repro_torch.core import protocol as proto
    from repro_torch.core.fedpc import FedPCConfig
    from repro_torch.core.tree import TreeSpec
    from repro_torch.fed.simulator import FedSimulator
    tree = TreeSpec(fanout=TREE_FANOUT)
    workers, params = _full_width(torch, dev)
    sim = FedSimulator(workers, params,
                       FedPCConfig(n_workers=N_WORKERS, tree=tree),
                       device=dev)
    res, launches, step_s, train_s, wall, *_ = _drive(torch, sim, ROUNDS)
    levels = tree.n_levels(N_WORKERS)
    want = proto.fedpc_tree_bytes_per_round(
        proto.model_size_bytes(params), N_WORKERS, TREE_FANOUT)
    own = _check_run(torch, res, launches,
                     {"uplink_stacked": ROUNDS, "partial_sum": ROUNDS,
                      "masked_partial_sum": (levels - 1) * ROUNDS,
                      "master_masked": ROUNDS},
                     [want] * ROUNDS, workers, "tree slice")
    check(sum(launches.values()) == tree.launches(N_WORKERS) * ROUNDS,
          "tree slice: launches per round are not levels + 2")
    print(f"tree slice: widths {tree.level_widths(N_WORKERS)}, "
          f"{tree.launches(N_WORKERS)} launches a round", flush=True)
    _print_round("tree round", step_s, train_s, wall, workers)
    _small_agrees(torch, dev, FedPCConfig(n_workers=3, tree=tree),
                  "tree small")
    return own


def _masked_tree_cfg():
    """The masked tree slice's configuration: 16-bit words, masks and RR,
    fanout 4, recovery threshold 2, under ``FAULTS``."""
    from repro_torch.core.fedpc import FedPCConfig
    from repro_torch.core.tree import TreeSpec
    from repro_torch.fed import faults as ft
    from repro_torch.privacy.spec import PrivacySpec
    return FedPCConfig(n_workers=N_WORKERS,
                       privacy=PrivacySpec(dp_epsilon=DP_EPSILON,
                                           recovery_threshold=2,
                                           enforce=False),
                       tree=TreeSpec(fanout=MASKED_TREE_FANOUT),
                       faults=ft.FaultPlan(**FAULTS))


def _fault_bytes(model_bytes: int, spec, tree, plan, rounds: int = ROUNDS
                 ) -> tuple[list, list, list, int]:
    """The JAX simulator's byte rules for the masked tree under ``plan``,
    from the schedule on the host: a pre-uplink death sends no leaf words;
    each round deals every worker's within-group seeds and reconstructs
    each recoverable dead worker's (dead in a group that kept >= threshold
    survivors). Returns (bytes, recovery bytes, fault codes by round,
    recoverable deaths)."""
    from repro_torch.core import protocol as proto
    from repro_torch.fed import faults as ft
    from repro_torch.privacy import recovery as pvr
    want, want_rec, schedule, recovered = [], [], [], 0
    for t in range(1, rounds + 1):
        codes = plan.codes(t, N_WORKERS, device="cpu")
        alive = (codes == ft.FAULT_NONE).float()
        _, dead = pvr.effective_masks(None, alive, spec.recovery_threshold,
                                      tree.fanout, N_WORKERS)
        n_pre = int((codes == ft.DROP_BEFORE).sum())
        want.append(proto.fedpc_tree_bytes_per_round(
            model_bytes, N_WORKERS, tree.fanout, word_bits=16)
            - model_bytes * n_pre * 16.0 / 32.0)
        want_rec.append(
            proto.recovery_dealing_bytes_per_round(N_WORKERS, tree.fanout)
            + proto.recovery_reconstruction_bytes(
                int(dead.sum()), spec.recovery_threshold, tree.fanout,
                n_workers=N_WORKERS))
        recovered += int(dead.sum())
        schedule.append(codes.tolist())
    return want, want_rec, schedule, recovered


def phase_masked_tree_slice(torch, dev) -> dict:
    """The masked round (16-bit words, masks and RR on) through a tree of
    fanout 4 under the fault plan ``FAULTS`` at full width; returns its
    launch counts."""
    from repro_torch.core import protocol as proto
    from repro_torch.core.fedpc import FedPCConfig
    from repro_torch.fed.simulator import FedSimulator
    cfg = _masked_tree_cfg()
    spec, tree, plan = cfg.privacy, cfg.tree, cfg.faults
    workers, params = _full_width(torch, dev)
    sim = FedSimulator(workers, params, cfg, device=dev)
    res, launches, step_s, train_s, wall, *_ = _drive(torch, sim, ROUNDS)
    want, want_rec, schedule, recovered = _fault_bytes(
        proto.model_size_bytes(params), spec, tree, plan)
    check(recovered >= 1, "no post-uplink death in a viable group")
    own = _check_run(torch, res, launches,
                     {"uplink_masked": ROUNDS,
                      "masked_partial_sum": ROUNDS * tree.n_levels(N_WORKERS),
                      "mask_repair": ROUNDS, "master_masked": ROUNDS},
                     want, workers, "masked tree slice")
    check(res.recovery_bytes_per_round == want_rec,
          f"recovery bytes {res.recovery_bytes_per_round} != {want_rec}")
    acc = res.round_state.accountant
    check(acc is not None and int(acc.spent_rounds) == ROUNDS,
          "accountant did not count the rounds")
    kinds = [k for (_, _, k, _) in sim.ledger.events]
    check(kinds.count("mask_recovery") == recovered,
          "ledger: mask_recovery events")
    check(sorted(set(kinds)) == ["cost", "mask_recovery", "masked_words",
                                 "pilot_params", "seed_shares"],
          "ledger kinds")
    print(f"masked tree slice: fault codes by round {schedule} (1 before "
          f"the uplink, 2 after, 3 straggler); {recovered} recoverable "
          f"post-uplink deaths repaired; recovery bytes/round {want_rec}; "
          f"accountant {int(acc.spent_rounds)} rounds", flush=True)
    _print_round("masked tree round", step_s, train_s, wall, workers)
    _small_agrees(torch, dev, FedPCConfig(n_workers=3, privacy=spec,
                                          tree=tree, faults=plan),
                  "masked tree small")
    return own


def repair_operands(torch, dev):
    """The main path's repair operands: the (P,) keys and coefficients of
    round 1 of ``FAULTS`` on the masked tree (fanout 4, N_WORKERS leaves,
    threshold 2): the 13 sibling pairs at N = 10, 3 of them live."""
    from repro_torch.core.tree import TreeSpec
    from repro_torch.fed import faults as ft
    from repro_torch.fed import rounds as rd
    from repro_torch.privacy import recovery as pvr
    from repro_torch.privacy.spec import PrivacySpec
    n = N_WORKERS
    t1 = torch.tensor(1, dtype=torch.int32, device=dev)
    wire = rd.WirePath(privacy=PrivacySpec(dp_epsilon=DP_EPSILON,
                                           recovery_threshold=2,
                                           enforce=False),
                       tree=TreeSpec(MASKED_TREE_FANOUT),
                       faults=ft.FaultPlan(**FAULTS))
    eff, dead = pvr.effective_masks(None, wire.faults.alive(t1, n), 2,
                                    MASKED_TREE_FANOUT, n)
    return wire._repair(*wire._leaf_pairs(n, t1, None, dev), eff, dead)


def phase_tree_wire(torch, dev) -> None:
    """At full width: tree == one-group tree (plain), masked tree == flat
    masked round, repaired round == survivors-only round, all bitwise."""
    from repro_torch.core.tree import TreeSpec
    from repro_torch.fed import faults as ft
    from repro_torch.fed import rounds as rd
    from repro_torch.privacy import recovery as pvr
    from repro_torch.privacy.spec import PrivacySpec
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    n, r = N_WORKERS, ROWS // 4
    q, p1, p2, beta, w, k = _inputs(torch, n, r, gen, dev)
    bufs = q.view(n, ROWS, 128)
    f1, f2 = p1.view(ROWS, 128), p2.view(ROWS, 128)
    tt = torch.tensor(3, dtype=torch.int32, device=dev)

    def same(a, b) -> bool:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    plain = [rd.WirePath(tree=TreeSpec(f)).round_from_stacked(
        bufs, k, w, f1, f2, t=tt, betas=beta)[0] for f in (TREE_FANOUT, 16)]
    check(same(*plain), "plain tree at fanout 2 differs from one group")
    spec = PrivacySpec(dp_epsilon=DP_EPSILON, enforce=False)
    masked = [rd.WirePath(privacy=spec, tree=tree).round_from_stacked(
        bufs, k, w, f1, f2, t=tt, betas=beta)[0]
        for tree in (TreeSpec(MASKED_TREE_FANOUT), None)]
    check(same(*masked), "masked tree differs from the flat masked round")
    del plain, masked
    spec = PrivacySpec(dp_epsilon=DP_EPSILON, recovery_threshold=2,
                       enforce=False)
    sizes = torch.arange(1.0, n + 1.0, device=dev)
    costs = torch.rand((n,), generator=gen, device=dev) + 0.5
    repaired = {}
    # The tree repairs its root's first row in place; the flat wire sums
    # the survivors' words and the repair term in a row of its own.
    for tree in (TreeSpec(MASKED_TREE_FANOUT), None):
        faulty = rd.WirePath(privacy=spec, tree=tree,
                             faults=ft.FaultPlan(**FAULTS))
        clean = rd.WirePath(privacy=spec, tree=tree)
        what = "tree" if tree is not None else "flat"
        repaired[what] = []
        for t in (1, 2):
            st = rd.RoundState(f1, f2,
                               torch.linspace(1.0, 2.0, n, device=dev),
                               torch.tensor(t, dtype=torch.int32,
                                            device=dev))
            _, out_f, info = faulty.round_step(st, bufs, costs, sizes,
                                               betas=beta)
            eff, dead = pvr.effective_masks(
                None, info["alive"], 2,
                None if tree is None else tree.fanout, n)
            _, out_s, _ = clean.round_step(st, bufs, costs, sizes,
                                           betas=beta, mask=eff)
            check(same(out_f, out_s),
                  f"repaired {what} round {t} differs from the "
                  f"survivors-only round")
            repaired[what].append(int(dead.sum()))
            del out_f, out_s
        check(sum(repaired[what]) >= 1,
              f"no repaired death in the {what} wire check")
    print(f"tree wire: full width, plain tree at fanout {TREE_FANOUT} == "
          f"one group (fanout 16), masked tree at fanout "
          f"{MASKED_TREE_FANOUT} == flat masked round; repaired rounds 1-2 "
          f"== survivors-only rounds on the masked tree ({repaired['tree']} "
          f"deaths repaired) and on the flat masked wire "
          f"({repaired['flat']}), all bitwise", flush=True)


TELEMETRY_REPEATS = 15            # round_step calls a form and round in (c)
# The runtime and driver calls that launch a kernel, as CUPTI names them.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def _leaves_same(torch, a, b, label: str) -> None:
    """Two trees of tensors (None fields included), bitwise."""
    from repro_torch.utils import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    check(len(la) == len(lb), f"{label}: the trees differ in shape")
    for x, y in zip(la, lb):
        check((x is None and y is None) or (
            x.dtype == y.dtype and x.device == y.device
            and torch.equal(x, y)), f"{label}: a leaf differs")


def _telemetry_inputs(torch, dev):
    """A full-width round's operands: ten worker buffers near a shared
    history, costs and sizes."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    q, p1, p2, *_ = _inputs(torch, N_WORKERS, ROWS // 4, gen, dev)
    costs = torch.rand((N_WORKERS,), generator=gen, device=dev) + 0.5
    sizes = torch.full((N_WORKERS,), float(SCAN_SHARD), device=dev)
    return (q.view(N_WORKERS, ROWS, 128), p1.view(ROWS, 128),
            p2.view(ROWS, 128), costs, sizes)


def _state_at(torch, wire, t: int, telemetry: bool, p1, p2, costs):
    """A round state at round ``t`` over the given history."""
    from repro_torch.fed import rounds as rd
    from repro_torch.privacy.accountant import PrivacyAccountant
    from repro_torch.telemetry.record import TelemetryCarry
    dev = p1.device
    dp = wire.masked and wire.privacy.dp_on
    return rd.RoundState(
        p1, p2, costs * 1.01,
        torch.full((), t, dtype=torch.int32, device=dev),
        accountant=PrivacyAccountant.zero(dev) if dp else None,
        telemetry=TelemetryCarry.zero(dev) if telemetry else None)


def _op_counts(prof) -> tuple[int, int, int]:
    """(top-level ATen ops, kernel-launch calls, device kernels) in a
    profile."""
    from torch.autograd import DeviceType
    events = prof.events()
    ops = sum(1 for e in events if e.name.startswith("aten::")
              and e.device_type == DeviceType.CPU
              and not (e.cpu_parent is not None
                       and e.cpu_parent.name.startswith("aten::")))
    calls = sum(1 for e in events if e.name in LAUNCH_CALLS)
    kernels = sum(1 for e in events if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("wire/"))
    return ops, calls, kernels


def phase_telemetry_slice(torch, dev) -> dict:
    """The telemetry layer and the checkpoint at full width, on the masked
    tree with faults (``_masked_tree_cfg``) and equal 1,024-sample shards.

    (a) ``run_fedpc`` and ``run_fedpc_scan`` for 3 rounds on two fresh,
    equal federations: their traces equal one for one, bytes and recovery
    bytes the slice's own rules (``_fault_bytes``); the summed counts and
    the edge events' level widths printed. (b) the same federation for 2
    rounds, ``save_round_state`` into a temporary directory,
    ``load_round_state`` onto the card, 1 more round: == (a)'s
    ``run_fedpc`` bitwise (buffers, costs, round, accountant, carry,
    pilots, params and trace); save and load timed. (c) ``round_step`` at
    rounds 2 and 3 on the plain and the masked wire, with the telemetry
    carry and without, in turns (median of ``TELEMETRY_REPEATS``), and the
    ops the record adds to a round under ``torch.profiler``. (d) one plain
    round and one masked-tree round with a repair under
    ``profile_session``: one ``wire/<kind>/r<rows>n<N>/cuda`` range a
    launch, each holding its kernel's launch (the ``LAUNCHES`` counter
    read inside the scope, and the launch call's CUDA activity where the
    profiler gives it). Returns the launch counts of (a) and (b)."""
    import contextlib
    import tempfile

    from repro_torch.core import protocol as proto
    from repro_torch.fed import rounds as rd
    from repro_torch.fed.simulator import FedSimulator
    from repro_torch.privacy.spec import PrivacySpec
    from repro_torch.telemetry import profile as tprof
    cfg = _masked_tree_cfg()
    spec, tree, plan = cfg.privacy, cfg.tree, cfg.faults
    levels = tree.n_levels(N_WORKERS)
    own: dict = {}
    card = _smi()

    def path(rounds: int) -> dict:
        return {"uplink_masked": rounds, "masked_partial_sum": rounds * levels,
                "mask_repair": rounds, "master_masked": rounds}

    def add(launches: dict) -> None:
        for k, v in launches.items():
            if v:
                own[k] = own.get(k, 0) + v

    # (a) both drivers, one trace
    runs = {}
    for driver in ("run_fedpc", "run_fedpc_scan"):
        workers, params = _full_width(torch, dev, uniform=True)
        sim = FedSimulator(workers, params, cfg, device=dev)
        if driver == "run_fedpc":
            res, launches, *_ = _drive(torch, sim, ROUNDS)
            synced = "round_step"
        else:
            res, launches, _, _ = _drive_scan(torch, sim, ROUNDS)
            synced = "the whole round loop"
        want, want_rec, _, recovered = _fault_bytes(
            proto.model_size_bytes(params), spec, tree, plan)
        add(_check_run(torch, res, launches, path(ROUNDS), want, workers,
                       "telemetry slice (a)", driver=driver, synced=synced))
        check(res.recovery_bytes_per_round == want_rec,
              f"telemetry slice (a): recovery bytes "
              f"{res.recovery_bytes_per_round} != {want_rec}")
        runs[driver] = res
        del sim, workers
        _release(torch)
    full, scan = runs["run_fedpc"].telemetry, runs["run_fedpc_scan"].telemetry
    for kind in ("rounds", "workers", "edges"):
        check(getattr(full, kind) == getattr(scan, kind),
              f"telemetry slice (a): the traces' {kind} events differ")
    check({**full.meta, "driver": ""} == {**scan.meta, "driver": ""},
          "telemetry slice (a): the traces' meta events differ")
    names = ("n_sampled", "n_used", "n_dead", "n_pre_uplink", "n_recovered",
             "n_degraded")
    totals = {k: sum(r[k] for r in full.rounds) for k in names}
    check(totals["n_recovered"] == recovered,
          f"telemetry slice (a): {totals['n_recovered']} recovered in the "
          f"trace, {recovered} by the schedule")
    carry = runs["run_fedpc"].round_state.telemetry
    check([int(x) for x in carry[1:7]] == [totals[k] for k in names],
          "telemetry slice (a): the carry's totals are not the trace's")
    widths = sorted({(e["level"], e["width"]) for e in full.edges})
    print(f"telemetry slice (a): run_fedpc and run_fedpc_scan traces equal "
          f"one for one ({len(full.events())} events); over {ROUNDS} rounds "
          f"sampled {totals['n_sampled']}, used {totals['n_used']}, dead "
          f"{totals['n_dead']}, pre-uplink {totals['n_pre_uplink']}, "
          f"recovered {totals['n_recovered']}, degraded "
          f"{totals['n_degraded']} (by round: "
          f"{[[r[k] for k in names] for r in full.rounds]}); edge level "
          f"widths {widths}; bytes/round {full.bytes_per_round} and "
          f"recovery {full.recovery_bytes_per_round} == the slice's rules",
          flush=True)
    # (b) resume at full width
    workers, params = _full_width(torch, dev, uniform=True)
    sim = FedSimulator(workers, params, cfg, device=dev)
    first, launches, *_ = _drive(torch, sim, ROUNDS - 1)
    check({k: v for k, v in launches.items() if v} == path(ROUNDS - 1),
          f"telemetry slice (b): launches {launches}")
    add(launches)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        npz = rd.save_round_state(tmp, first.round_state)
        save_s = time.perf_counter() - t0
        size = sum(p.stat().st_size for p in Path(tmp).iterdir())
        like = rd.init_round_state(params, N_WORKERS, privacy=spec,
                                   device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded, manifest = rd.load_round_state(tmp, like)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    check(manifest["step"] == ROUNDS and Path(npz).name
          == f"ckpt_{ROUNDS:08d}.npz", f"checkpoint step {manifest['step']}")
    _leaves_same(torch, loaded, first.round_state,
                 "telemetry slice (b): the loaded state")
    rest, launches, *_ = _drive(torch, sim, 1, state=loaded)
    check({k: v for k, v in launches.items() if v} == path(1),
          f"telemetry slice (b): launches {launches}")
    add(launches)
    one = runs["run_fedpc"]
    check(first.pilot_history + rest.pilot_history == one.pilot_history,
          "telemetry slice (b): pilots")
    check(first.costs + rest.costs == one.costs, "telemetry slice (b): costs")
    for kind in ("rounds", "workers", "edges"):
        check(getattr(first.telemetry, kind) + getattr(rest.telemetry, kind)
              == getattr(one.telemetry, kind),
              f"telemetry slice (b): the resumed trace's {kind} events")
    _leaves_same(torch, rest.round_state, one.round_state,
                 "telemetry slice (b): the resumed state")
    _leaves_same(torch, rest.params, one.params,
                 "telemetry slice (b): the resumed model")
    print(f"telemetry slice (b) on {card}: 2 rounds, saved "
          f"({size / 1e6:.1f} MB in {save_s * 1e3:.1f} ms), loaded onto "
          f"the card ({load_s * 1e3:.1f} ms), 1 more round == the 3-round "
          f"run bitwise (buffers, costs, round, accountant, carry, pilots "
          f"{one.pilot_history}, {N_PARAMS:,} params, trace)", flush=True)
    del sim, workers, runs, first, rest, one, loaded, like
    _release(torch)
    # (c) the record's cost
    bufs, p1, p2, costs, sizes = _telemetry_inputs(torch, dev)
    wires = {"plain": rd.WirePath(),
             "masked": rd.WirePath(privacy=PrivacySpec(
                 dp_epsilon=DP_EPSILON, enforce=False))}
    saved = _read_counts()

    def step(wire, t: int, on: bool) -> float:
        st = _state_at(torch, wire, t, on, p1, p2, costs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            wire.round_step(st, bufs, costs, sizes)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    times: dict = {}
    for name, wire in wires.items():
        for on in (True, False):
            step(wire, 2, on)                       # warm up
            times[name, on] = []
    for rep in range(TELEMETRY_REPEATS):
        for name, wire in wires.items():
            for on in ((True, False) if rep % 2 == 0 else (False, True)):
                for t in (2, 3):
                    times[name, on].append(step(wire, t, on))
    added = {}
    for name, wire in wires.items():
        counts = {}
        for on in (True, False):
            st = _state_at(torch, wire, 2, on, p1, p2, costs)
            with tprof.profile_session() as prof:
                wire.round_step(st, bufs, costs, sizes)
                torch.cuda.synchronize()
            counts[on] = _op_counts(prof)
        added[name] = [a - b for a, b in zip(counts[True], counts[False])]
        check(added[name][0] > 0, f"{name}: the record added no op")
    _restore_counts(saved)
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    iqr = {k: "–".join(f"{q * 1e3:.4f}" for q in statistics.quantiles(
        v, n=4)[::2]) for k, v in times.items()}
    print(f"telemetry slice (c) on {card}: round_step at rounds 2-3, median "
          f"of {2 * TELEMETRY_REPEATS} calls in turns (host clock between "
          f"syncs, sync-debug 'error'; quartiles in brackets): "
          + "; ".join(f"{name} wire {med[name, True]:.4f} ms "
                      f"[{iqr[name, True]}] with the record and carry, "
                      f"{med[name, False]:.4f} [{iqr[name, False]}] without "
                      f"(+{med[name, True] - med[name, False]:.4f} ms); the "
                      f"record adds {added[name][0]} top-level ATen ops, "
                      f"{added[name][1]} kernel-launch calls and "
                      f"{added[name][2]} device kernels to a round"
                      for name in wires), flush=True)
    # (d) profiler scopes
    inner = tprof.kernel_scope
    seen: list = []

    @contextlib.contextmanager
    def counted(kind, rows, n=1, device=None):
        before = sum(_read_counts().values())
        with inner(kind, rows, n, device):
            yield
            seen.append((tprof.scope_name(kind, rows, n, device),
                         sum(_read_counts().values()) - before))

    r = ROWS // 4
    w_top = tree.level_widths(N_WORKERS)[-1]
    tree_wire = rd.WirePath(privacy=spec, tree=tree, faults=plan)
    forms = (
        ("plain", rd.WirePath(), 2,
         [f"wire/uplink_stacked/r{r}n{N_WORKERS}/cuda",
          f"wire/master/r{r}n{N_WORKERS}/cuda"]),
        ("masked tree, round 1 of FAULTS", tree_wire, 1,
         [f"wire/uplink_masked16/r{r}n{N_WORKERS}/cuda"]
         + [f"wire/partial_sum_masked16/r{r}n{MASKED_TREE_FANOUT}/cuda"]
         * levels + [f"wire/mask_repair16/r{r}n1/cuda",
                     f"wire/master_masked16/r{r}n{w_top}/cuda"]))
    from torch.autograd import DeviceType
    notes = []
    tprof.kernel_scope = counted
    try:
        for label, wire, t, want in forms:
            st = _state_at(torch, wire, t, True, p1, p2, costs)
            saved = _read_counts()
            _zero_counts()
            seen.clear()
            with tprof.profile_session() as prof:
                wire.round_step(st, bufs, costs, sizes)
                torch.cuda.synchronize()
            total = sum(_read_counts().values())
            _restore_counts(saved)
            events = prof.events()
            scopes = [e for e in events if e.name.startswith("wire/")
                      and e.device_type == DeviceType.CPU]
            check(total == len(want), f"(d) {label}: {total} launches")
            check(sorted(e.name for e in scopes) == sorted(want),
                  f"(d) {label}: scopes {[e.name for e in scopes]}")
            check(sorted(n for n, _ in seen) == sorted(want)
                  and all(d == 1 for _, d in seen),
                  f"(d) {label}: launches read inside the scopes {seen}")
            calls = [e for e in events if e.name in LAUNCH_CALLS]
            kernels = [e for e in events if e.device_type == DeviceType.CUDA
                       and not e.name.startswith("wire/")]
            gpu_ranges = [e for e in events if e.name.startswith("wire/")
                          and e.device_type == DeviceType.CUDA]
            check(not gpu_ranges or sorted(e.name for e in gpu_ranges)
                  == sorted(want), f"(d) {label}: device-side ranges "
                  f"{[e.name for e in gpu_ranges]}")
            if calls:
                # Each scope holds exactly one launch call (the kernel's).
                inside = [sum(1 for c in calls
                              if s.time_range.start <= c.time_range.start
                              and c.time_range.end <= s.time_range.end)
                          for s in scopes]
                check(inside == [1] * len(scopes),
                      f"(d) {label}: launch calls a scope {inside}")
                how = (f"CUDA activity: {len(calls)} launch calls in the "
                       f"round, one inside each scope; {len(kernels)} device "
                       f"kernels; {len(gpu_ranges)} device-side ranges, "
                       f"the scopes' names")
            else:
                how = (f"no launch call in the profile ({len(kernels)} "
                       f"device kernels): each scope held to the LAUNCHES "
                       f"counter read inside it")
            notes.append(f"{label}: {len(scopes)} scopes == {total} "
                         f"launches ({', '.join(sorted(set(want)))}); {how}")
    finally:
        tprof.kernel_scope = inner
    print("telemetry slice (d): " + "; ".join(notes), flush=True)
    return own


PRIVACY_ROUNDS = 2                # rounds a run in the privacy slice
PRIVACY_SCENARIOS = ("secure-agg", "secure-agg-ldp")


def _poisoned_stack(torch, q, k: int, gen):
    """``q`` with every worker row but the pilot's ``k`` replaced by
    garbage of magnitude 1e30 with NaN and -inf sprinkled in."""
    junk = torch.randn(q.shape, generator=gen, device=q.device) * 1e30
    junk.view(-1)[::3] = float("nan")
    junk.view(-1)[1::7] = float("-inf")
    keep = torch.arange(q.shape[0], device=q.device) == k
    return torch.where(keep[:, None, None], q, junk)


def _pilot_poison_check(torch, dev) -> str:
    """#2 and #7, kernel and plain, at the main-path shape: the stack's
    non-pilot rows poisoned change no bit of the output (the masters read
    their declared pilot slot only at ``k_star``)."""
    from repro_torch.kernels import fused_wire as fw
    from repro_torch.kernels import masked_wire as mw
    from repro_torch.privacy import masking as pvm
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    n, r = N_WORKERS, ROWS // 4
    q, p1, p2, beta, w, _ = _inputs(torch, n, r, gen, dev)
    packed = torch.randint(0, 256, (n, r, 128), generator=gen, device=dev,
                           dtype=torch.uint8)
    words = _rand_words(torch, (n, r, 512), 16, gen, dev)
    sum_wq = pvm.to_words(torch.tensor(16411, device=dev), 32)
    saved = _read_counts()
    cases = 0
    for k in (0, N_WORKERS - 1):
        ks = torch.tensor(k, device=dev)
        bad = _poisoned_stack(torch, q, k, gen)
        for t in (1, 2):
            tt = torch.tensor(t, dtype=torch.int32, device=dev)
            for label, fn, args in (
                    ("#2", fw.packed_master_update, (packed, w, p1, p2, tt,
                                                     0.01)),
                    ("#2 plain", fw.packed_master_update_plain,
                     (packed, w, p1, p2, tt, 0.01)),
                    ("#7", mw.masked_master_update, (words, sum_wq, p1, p2,
                                                     tt, 0.01, 2.0 ** -14)),
                    ("#7 plain", mw.masked_master_update_plain,
                     (words, sum_wq, p1, p2, tt, 0.01, 2.0 ** -14))):
                clean = fn(q, ks, *args)
                poisoned = fn(bad, ks, *args)
                same, diff = _bitwise(torch, clean, poisoned)
                check(bool(torch.isfinite(clean).all()) and same,
                      f"privacy slice: {label} read a poisoned row (pilot "
                      f"{k}, t {t}, max diff {diff})")
                cases += 1
        del bad
    _restore_counts(saved)
    return (f"{cases} cases: #2 and #7, kernel and plain, pilot 0 and "
            f"{N_WORKERS - 1}, t 1 and 2, at ({n}, {r}, 512)")


def _negative_audits(torch, dev) -> str:
    """At the main-path shapes the audit refuses the plaintext wire under
    the masked policy and a leaky master launch through the public seam."""
    from repro_torch.core.privacy import LeakageError
    from repro_torch.fed import rounds as rd
    from repro_torch.kernels import seam
    from repro_torch.privacy.audit import check_round_program
    from repro_torch.privacy.spec import PrivacySpec
    params = {"w": torch.zeros(ROWS * 128, device=dev)}
    state = rd.init_round_state(params, N_WORKERS, device=dev)
    bufs = torch.empty((N_WORKERS, ROWS, 128), device="meta")
    costs = torch.empty((N_WORKERS,), device="meta")
    sizes = torch.full((N_WORKERS,), float(SCAN_SHARD), device=dev)
    masked = rd.WirePath(privacy=PrivacySpec())

    def leaky(state, bufs, costs, sizes):
        new_state, new_buf, info = masked.round_step(state, bufs, costs,
                                                     sizes)
        out = seam.run_plain("leaky_master", lambda q, p: p + q.mean(0),
                             bufs, new_buf)
        return new_state, out, info

    said = []
    for label, fn, kw in (
            ("the plaintext wire under the masked policy",
             rd.WirePath().round_step, {"masked": True}),
            ("a leaky master through the seam", leaky, {"masked": True})):
        try:
            check_round_program(fn, state, bufs, costs, sizes,
                                n_workers=N_WORKERS, **kw)
        except LeakageError as exc:
            said.append(f"{label}: refused ({str(exc).split(':')[0]})")
            continue
        check(False, f"privacy slice: the audit passed {label}")
    return "; ".join(said)


def phase_privacy_slice(torch, dev) -> dict:
    """§4.2 enforcement at full width, with ``PrivacySpec(enforce=True)``.

    (a) the shipped ``secure-agg`` and ``secure-agg-ldp`` scenarios
    (``configs.get_scenario``; C = 0.5 and eps 4 for the second) through
    ``run_fedpc`` and ``run_fedpc_scan`` on equal 1,024-sample shards,
    ``PRIVACY_ROUNDS`` rounds each: each driver records exactly one audit
    (masked, 2 launches), the two drivers bitwise equal, and the same
    ``run_fedpc`` with ``enforce=False`` launches the same kernels as often
    and gives the same bits; (b) the masked tree under
    ``_masked_tree_cfg()``'s fault plan with enforcement on (one audit of
    levels + 3 launches); (c) the audit refuses, at the main-path shapes,
    the plaintext wire under the masked policy and a leaky master through
    the public seam; (d) the pilot poison check of #2 and #7; (e) each
    audit's set-up time, beside the card's name and power limit. Returns
    the launch counts of (a) and (b)."""
    import dataclasses

    from repro_torch.configs import get_scenario
    from repro_torch.core import protocol as proto
    from repro_torch.core.fedpc import FedPCConfig
    from repro_torch.fed.simulator import FedSimulator
    own: dict = {}
    audit_ms: list = []
    inner = FedSimulator._enforce_privacy

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        inner(self, *args, **kwargs)
        if self.fed_cfg.privacy.enforce:
            audit_ms.append(((time.perf_counter() - t0) * 1e3,
                             args[0], len(self.ledger.audits)))

    def add(launches: dict) -> None:
        for k, v in launches.items():
            if v:
                own[k] = own.get(k, 0) + v

    def run(cfg, driver: str, want: list, label: str, on_path: dict,
            **kw):
        workers, params = _full_width(torch, dev, uniform=True)
        sim = FedSimulator(workers, params, cfg, device=dev)
        if driver == "run_fedpc":
            res, launches, *_ = _drive(torch, sim, PRIVACY_ROUNDS, **kw)
            synced = "round_step"
        else:
            res, launches, *_ = _drive_scan(torch, sim, PRIVACY_ROUNDS,
                                            **kw)
            synced = "the whole round loop"
        add(_check_run(torch, res, launches, on_path, want, workers, label,
                       rounds=PRIVACY_ROUNDS, driver=driver, synced=synced))
        audits = sim.ledger.audits
        del sim, workers
        _release(torch)
        return res, launches, audits

    rounds = PRIVACY_ROUNDS
    mb = N_PARAMS * 4                 # float32 weights on the wire (§5.2)
    flat = {"uplink_masked": rounds, "master_masked": rounds}
    lines = []
    FedSimulator._enforce_privacy = timed
    try:
        for name in PRIVACY_SCENARIOS:
            scen = get_scenario(name)
            check(scen.privacy.enforce, f"{name}: enforcement is off")
            cfg = FedPCConfig(n_workers=N_WORKERS, privacy=scen.privacy)
            n_part = max(1, round(scen.participation * N_WORKERS))
            want = [proto.fedpc_masked_bytes_per_round(
                mb, n_part, word_bits=scen.privacy.modulus_bits)] * rounds
            kw = ({} if scen.participation == 1.0
                  else {"participation": scen.participation,
                        "participation_seed": SEED})
            out = {}
            for driver in ("run_fedpc", "run_fedpc_scan"):
                res, launches, audits = run(
                    cfg, driver, want, f"privacy slice (a) {name}", flat,
                    **kw)
                check(audits == [{"runtime": driver,
                                  "boundary": "round-step",
                                  "n_launches": 2, "masked": True}],
                      f"privacy slice: {name} {driver} audits {audits}")
                out[driver] = (res, launches)
            _same_runs(torch, out["run_fedpc"][0], out["run_fedpc_scan"][0],
                       f"privacy slice (a) {name}")
            off = FedPCConfig(n_workers=N_WORKERS, privacy=dataclasses.replace(
                scen.privacy, enforce=False))
            res, launches, audits = run(off, "run_fedpc", want,
                                        f"privacy slice (a) {name} "
                                        f"enforce=False", flat, **kw)
            check(audits == [], "an audit with enforcement off")
            check(launches == out["run_fedpc"][1],
                  f"privacy slice: {name} launches {launches} with "
                  f"enforcement off, {out['run_fedpc'][1]} on")
            _same_runs(torch, out["run_fedpc"][0], res,
                       f"privacy slice (a) {name} enforce on/off")
            lines.append(f"{name} (participation {scen.participation}, "
                         f"eps {scen.privacy.dp_epsilon}): run_fedpc == "
                         f"run_fedpc_scan == run_fedpc with enforce=False, "
                         f"bitwise; launches "
                         f"{ {k: v for k, v in launches.items() if v} } "
                         f"either way")
        # (b) the masked tree under faults, enforced
        cfg = _masked_tree_cfg()
        cfg = dataclasses.replace(cfg, privacy=dataclasses.replace(
            cfg.privacy, enforce=True))
        spec, tree, plan = cfg.privacy, cfg.tree, cfg.faults
        levels = tree.n_levels(N_WORKERS)
        want, want_rec, _, _ = _fault_bytes(mb, spec, tree, plan, rounds)
        res, launches, audits = run(
            cfg, "run_fedpc", want, "privacy slice (b) masked tree",
            {"uplink_masked": rounds, "masked_partial_sum": rounds * levels,
             "mask_repair": rounds, "master_masked": rounds})
        check(res.recovery_bytes_per_round == want_rec,
              "privacy slice (b): recovery bytes")
        check(audits == [{"runtime": "run_fedpc", "boundary": "round-step",
                          "n_launches": tree.launches(N_WORKERS) + 1,
                          "masked": True}],
              f"privacy slice (b): audits {audits}")
        lines.append(f"masked tree (fanout {tree.fanout}, threshold "
                     f"{spec.recovery_threshold}, faults {FAULTS}): audit "
                     f"{audits[0]['n_launches']} launches, launches "
                     f"{ {k: v for k, v in launches.items() if v} }")
    finally:
        FedSimulator._enforce_privacy = inner
    print("privacy slice (a, b): " + "; ".join(lines), flush=True)
    print(f"privacy slice (c): {_negative_audits(torch, dev)}", flush=True)
    print(f"privacy slice (d): pilot slot poison check bitwise, "
          f"{_pilot_poison_check(torch, dev)}", flush=True)
    _release(torch)
    print(f"privacy slice (e) on {_smi()}: audit set-up time per driver "
          f"run, host only, {N_PARAMS:,} params x {N_WORKERS} workers: "
          + ", ".join(f"{d} {ms:.1f} ms" for ms, d, _ in audit_ms)
          + " (secure-agg, secure-agg-ldp, the masked tree); no launch and "
          "no sync on the card", flush=True)
    check(len(audit_ms) == 2 * len(PRIVACY_SCENARIOS) + 1
          and all(n == 1 for *_, n in audit_ms), "an audit per driver run")
    return own


SERVE_ARCH = "qwen3-14b"          # the model zoo's serving phase
# Full-size parameter counts of the served configs: the JAX package's, as
# tests/test_torch_model_zoo.py derives them with jax.eval_shape.
SERVE_PARAMS_OF = {"qwen3-14b": 14_768_307_200,
                   "deepseek-moe-16b": 16_375_728_128,
                   "xlstm-350m": 443_057_248}
SERVE_BATCH = 4
SERVE_PROMPT = 1024               # a multiple of the 512-key prefill block
SERVE_NEW = 32                    # greedy tokens decoded
SERVE_SHORT = 64                  # prompt of the prefill_sequential check
SERVE_PROFILED = 4                # decode steps profiled (positions again)
SERVE_F32_LAYERS = 4              # depth of the float32 consistency model
SERVE_LSTM_PROFILED = 128         # prompt of an LSTM's profiled prefill
MOE_ARCH = "deepseek-moe-16b"     # served and federated (7b)
XLSTM_ARCH = "xlstm-350m"         # served (7b)
MAMBA_ARCH = "jamba-1.5-large-398b"   # its Mamba mixer alone, at width
MAMBA_NEW = 8                     # decode steps after the Mamba prefill
BF16_PEAK = 989e12                # H100 SXM dense bf16 tensor-core FLOP/s
# Relative L2 distance allowed between two computations of the same
# logits. bfloat16 keeps 8 significant bits and the two paths round at
# other places (blocked attention rounds exp(s - m) before it is
# normalized, a decode step's products run at other GEMM shapes); at 40
# layers the distance of a bfloat16 forward to its float32 twin measured
# 0.019 on the CPU at reduced width, so 0.08 is four times that. Float32
# with TF32 off differs only in summation order.
SERVE_TOL = {"bfloat16": 0.08, "float32": 1e-4}
# A bfloat16 LSTM stack feeds each step's rounding into the next through
# its exponential gates: at 24 layers the JAX package's own bfloat16
# prefill and prefill_sequential differ by 0.167 (reduced-width
# xlstm-350m, 64 tokens, on the CPU;
# tests/test_torch_lstm_bf16.py::test_bfloat16_lstm_limit_of_the_chip_smoke),
# so such a stack's paths are held to 0.25, that distance with a margin.
SERVE_TOL_LSTM_BF16 = 0.25
LM_WORKERS = 4                    # the federated LM, launch/train.py's
LM_SEQUENCES = 192
LM_SEQ_LEN = 64


def _rel_l2(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


class Busy(NamedTuple):
    """Device activity of a profiled call, per call."""
    kernels: float                # device kernels (and copies) a call
    busy_ms: float                # their summed time a call
    top: str                      # the largest by summed time, with ms


def _device_busy(torch, fn, calls: int = 1) -> list:
    """``fn()`` once under ``torch.profiler`` (CPU and CUDA activity):
    the device's kernels and copies (one stream: their times add), a call.
    Returns ``[Busy]``, a list so two profiles concatenate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    check(n > 0, "the profiler recorded no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return [Busy(n / calls, sum(by_name.values()) / calls,
                 "; ".join(f"{k[:60]} {v / calls:.2f} ms" for k, v in top))]


def _serve_checks(torch, m, params, prompt, dev) -> dict:
    """The consistency checks of one served model, each a relative L2
    distance held to ``SERVE_TOL``: the blocked prefill's last logits
    against ``forward``'s materialized full sequence, and a short prefill
    then one decode step against ``prefill_sequential`` then the same
    step (logits and caches). A MoE model's short prefill routes B x
    SERVE_SHORT tokens at once and its sequential twin B at a time, so
    the capacity each sees differs; that check runs the same weights with
    a capacity of T·K slots an expert (``capacity_factor = E``), where no
    assignment drops and both compute one function. A bfloat16 LSTM
    stack is held to ``SERVE_TOL_LSTM_BF16`` instead. A cache leaf that
    is all zero after the sequential path must be all zero after the
    blocked one too. Returns {check: distance}."""
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves
    tol = SERVE_TOL[m.cfg.param_dtype]
    if m.cfg.param_dtype == "bfloat16" and any(
            mx in ("mlstm", "slstm") for mx, _ in m.cfg.pattern):
        tol = SERVE_TOL_LSTM_BF16
    b, s = prompt.shape
    out = {}
    state = m.init_decode_state(b, s + SERVE_NEW, device=dev)
    last, state = m.prefill(params, {"tokens": prompt}, state)
    full, _ = m.forward(params, {"tokens": prompt})
    check(bool(torch.isfinite(full).all()), "forward logits not finite")
    out["blocked prefill vs materialized"] = _rel_l2(torch, last,
                                                     full[:, -1:])
    del state, full
    if m.cfg.n_experts:
        m = build_model(m.cfg.replace(
            capacity_factor=float(m.cfg.n_experts)))
    short = prompt[:, :SERVE_SHORT]
    runs = []
    for fn in (m.prefill, m.prefill_sequential):
        st = m.init_decode_state(b, SERVE_SHORT + 1, device=dev)
        logits, st = fn(params, {"tokens": short}, st)
        runs.append((logits, st))
    tok = runs[0][0].argmax(-1)
    steps = [m.decode_step(params, st, {"token": tok, "pos": SERVE_SHORT})
             for _, st in runs]
    out["prefill vs prefill_sequential"] = _rel_l2(torch, runs[0][0],
                                                   runs[1][0])
    out["decode step after each"] = _rel_l2(torch, steps[0][0],
                                            steps[1][0])
    dists, zero = [], []
    for x, y in zip(tree_leaves(steps[0][1]), tree_leaves(steps[1][1])):
        if y.norm() > 0:
            dists.append(_rel_l2(torch, x, y))
            continue
        zero.append(tuple(y.shape))
        check(torch.equal(x, y), f"{m.cfg.name}: a cache leaf of shape "
              f"{tuple(y.shape)} is all zero after prefill_sequential but "
              f"not after prefill")
    if zero:
        print(f"{m.cfg.name} {m.cfg.param_dtype}: cache leaves all zero "
              f"after both paths (held equal): {zero}", flush=True)
    out["caches after each"] = max(dists)
    for k, v in out.items():
        check(v <= tol, f"{m.cfg.name} {m.cfg.param_dtype}: {k} at "
              f"relative L2 {v:.3g} > {tol:.3g}")
    out["limit"] = tol
    return out


class _Routes:
    """Records each MoE block's routing (``models.moe.route``'s e_idx and
    keep) while it is entered; the device work is unchanged."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        from repro_torch.models import moe
        self._route = route = moe.route

        def recorded(p, cfg, xf):
            out = route(p, cfg, xf)
            self.calls.append((out[3], out[5]))
            return out

        moe.route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route


def _kind_ops(cfg, bp, mixer: str, ffn: str, tokens: int, B: int,
              keys: int) -> tuple[float, float]:
    """(matmul ops in the params' dtype, float32 ops outside the tensor
    cores) of one block of the stacked tree ``bp`` (leaves (n, ...)) over
    ``tokens`` tokens, 2 a multiply-add; causal attention over ``keys``
    keys a query on average. The routed experts are counted apart, by the
    kept assignments."""
    def mats(tree, *names):
        return sum(tree[k][0].numel() for k in names if k in tree)

    mx = bp["mixer"]
    mm = f32 = 0.0
    if mixer in ("attn", "swa"):
        mm += 2 * tokens * mats(mx, "wq", "wk", "wv", "wo")
        mm += 4 * tokens * cfg.n_heads * cfg.resolved_head_dim * keys
    elif mixer == "mamba":
        mm += 2 * tokens * mats(mx, "in_proj", "x_proj", "dt_proj",
                                "out_proj")
        # the scan a token and channel: exp(dt A), dt x B, a h + b, h . C;
        # the depthwise conv
        f32 += tokens * (8 * cfg.d_inner * cfg.d_state
                         + 2 * cfg.d_conv * cfg.d_inner)
    elif mixer == "mlstm":
        mm += 2 * tokens * mats(mx, "in_proj", "wq", "wk", "wv", "out_proj")
        dh = mx["wq"].shape[-1] // cfg.n_heads
        # gates (float32 weights); the state a token and head: f C,
        # i v k^T (two products) and their sum, then C q
        f32 += 2 * tokens * mats(mx, "gates_w")
        f32 += tokens * cfg.n_heads * 6 * dh * dh
    elif mixer == "slstm":
        mm += 2 * tokens * mats(mx, "out_proj")
        f32 += 2 * tokens * mats(mx, "gates_w", "r_gates_w")
    if ffn == "mlp":
        mm += 2 * tokens * mats(bp["ffn"], "w_gate", "w_up", "w_down")
    elif ffn == "moe":
        f32 += 2 * tokens * mats(bp["ffn"], "router")
        if "shared" in bp["ffn"]:
            mm += 2 * tokens * mats(bp["ffn"]["shared"], "w_gate", "w_up",
                                    "w_down")
    return mm, f32


def _model_ops(cfg, params, tokens: int, B: int, keys: int,
               kept: float) -> tuple[float, float]:
    """(matmul ops, float32 ops) of the whole stack over ``tokens``
    tokens, the LM head at B positions, and the routed experts' SwiGLU at
    ``kept`` token-expert pairs (summed over the MoE blocks)."""
    mm = f32 = 0.0
    blocks = [(params["units"][f"b{j}"], mixer, f, cfg.n_units)
              for j, (mixer, f) in enumerate(cfg.pattern)]
    if "dense_blocks" in params:
        blocks.append((params["dense_blocks"], "attn", "mlp",
                       cfg.first_k_dense))
    for bp, mixer, f, n in blocks:
        a, b = _kind_ops(cfg, bp, mixer, f, tokens, B, keys)
        mm, f32 = mm + n * a, f32 + n * b
    mm += 2 * B * params.get("lm_head", params["embed"]).numel()
    mm += 2 * kept * 3 * cfg.d_model * cfg.d_expert_ff
    return mm, f32


def _split_state(state: dict) -> tuple[int, int]:
    """(KV cache bytes, recurrent state bytes) of a decode state."""
    from repro_torch.utils import tree_leaves
    kv = rec = 0
    for key, tree in (*state["units"].items(),
                      ("dense", state.get("dense", {}))):
        for x in tree_leaves(tree):
            n = x.numel() * x.element_size()
            if isinstance(tree, dict) and set(tree) == {"k", "v"}:
                kv += n
            else:
                rec += n
    return kv, rec


def _serve_model(torch, cfg, dev, rate: float | None) -> None:
    """Init ``cfg`` from a seeded generator on the card, prefill
    SERVE_BATCH x SERVE_PROMPT random tokens, greedy-decode SERVE_NEW
    tokens (``pos`` a device tensor, every step under sync-debug "error"),
    check the logits finite and the consistency checks; with a memory
    ``rate`` print prefill and decode times beside their bounds, counted
    a block kind at a time (``_model_ops``): a MoE block's routed experts
    at the prefill's kept assignments, and decode's bytes without the
    experts no token was routed to."""
    from repro_torch.models import build_model, moe
    from repro_torch.models.layers import CHUNK
    from repro_torch.utils import tree_leaves, tree_size
    m = build_model(cfg)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = m.init(gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = tree_size(params)
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    # A stacked leaf is allocated once and filled a unit at a time, each
    # draw in chunks of CHUNK values: init holds the weights, one unit's
    # draw and a few chunks' float64 temporaries (1 GiB allows 8).
    unit_bytes = sum(x[0].numel() * x.element_size()
                     for x in tree_leaves(params["units"]))
    init_cap = nbytes + unit_bytes + 8 * CHUNK * 8
    check(init_peak - resident <= init_cap,
          f"init peaked at {(init_peak - resident) / 1e9:.2f} GB over the "
          f"{resident / 1e9:.2f} GB held before it, above the weights plus "
          f"one unit's draw plus 1 GiB ({init_cap / 1e9:.2f} GB)")
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen, device=dev)
    lstm = any(mx in ("mlstm", "slstm") for mx, _ in cfg.pattern)
    with torch.no_grad():
        state = m.init_decode_state(SERVE_BATCH, SERVE_PROMPT + SERVE_NEW,
                                    device=dev)
        kv_bytes, rec_bytes = _split_state(state)
        prefill_ms = []
        # The first call warms cuBLAS up; an LSTM's host-paced prefill
        # (seconds) is timed once, its GEMMs warmed by the earlier phases.
        for _ in range(1 if lstm else 2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            logits, state = m.prefill(params, {"tokens": prompt}, state)
            b.record()
            b.synchronize()
            prefill_ms.append(a.elapsed_time(b))
        check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
        tok = logits.argmax(-1)
        pos = torch.full((), SERVE_PROMPT, dtype=torch.int32, device=dev)
        ends = [torch.cuda.Event(enable_timing=True)
                for _ in range(SERVE_NEW + 1)]
        toks, finite = [tok], []
        ends[0].record()
        issued = [time.perf_counter()]     # the host's clock, no sync
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(SERVE_NEW):
                logits, state = m.decode_step(params, state,
                                              {"token": tok, "pos": pos})
                ends[i + 1].record()
                issued.append(time.perf_counter())
                finite.append(torch.isfinite(logits).all())
                tok = logits.argmax(-1)
                toks.append(tok)
                pos = pos + 1
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        check(bool(torch.stack(finite).all()), "decode logits not finite")
        step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        host_ms = [(b - a) * 1e3 for a, b in zip(issued, issued[1:])]
        busy = None
        if rate is not None:
            # An LSTM's prefill is a loop of ~20 launches a layer and
            # token; the profiler records a SERVE_LSTM_PROFILED-token one
            # (timed alone too), not the 1,024-token one.
            short = prompt[:, :SERVE_LSTM_PROFILED] if lstm else prompt
            prof_ms = prefill_ms[-1]
            if lstm:
                st = m.init_decode_state(SERVE_BATCH, short.shape[1],
                                         device=dev)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                m.prefill(params, {"tokens": short}, st)
                b.record()
                b.synchronize()
                prof_ms = a.elapsed_time(b)
                del st
            with _Routes() as pre_routes:
                busy = _device_busy(torch, lambda: m.prefill(
                    params, {"tokens": short}, m.init_decode_state(
                        SERVE_BATCH, short.shape[1], device=dev)))
            steps = [SERVE_PROMPT + i for i in range(SERVE_PROFILED)]
            with _Routes() as dec_routes:
                busy += _device_busy(torch, lambda: [m.decode_step(
                    params, state, {"token": toks[i], "pos": torch.full(
                        (), p, dtype=torch.int32, device=dev)})
                    for i, p in enumerate(steps)], len(steps))
        logits_bytes = logits.numel() * logits.element_size()
        del state, logits
        errs = _serve_checks(torch, m, params, prompt, dev)
    peak = torch.cuda.max_memory_allocated()
    label = f"serve {cfg.name} {cfg.param_dtype} {cfg.n_layers} layers"
    print(f"{label}: {n:,} params ({nbytes / 1e9:.2f} GB) drawn on the card "
          f"in {init_s:.1f} s, peak {init_peak / 1e9:.2f} GB after init "
          f"({resident / 1e9:.2f} GB held by earlier phases); "
          f"KV cache {kv_bytes / 1e9:.3f} GB and recurrent state "
          f"{rec_bytes / 1e6:.1f} MB (B = {SERVE_BATCH}, max_len "
          f"{SERVE_PROMPT + SERVE_NEW}); max_memory_allocated "
          f"{peak / 1e9:.2f} GB; continuation of request 0 "
          f"{[int(t[0, 0]) for t in toks[:12]]}", flush=True)
    tol = errs.pop("limit")
    print(f"{label}: consistency (relative L2, limit {tol:.3g}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()), flush=True)
    if cfg.param_dtype == "bfloat16":
        want = SERVE_PARAMS_OF[cfg.name]
        check(n == want, f"{n:,} params, expected {want:,}")
    if rate is None:
        del params, prompt, m
        _release(torch)
        return
    pre, dec = busy
    B, S = SERVE_BATCH, SERVE_PROMPT
    tokens = B * S
    head = params.get("lm_head", params["embed"]).numel()
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    row_bytes = cfg.d_model * params["embed"].element_size()
    expert_bytes = 0
    kept = 0.0
    routed = []
    if cfg.n_experts:
        e0 = params["units"][next(f"b{j}" for j, (_, f) in
                                  enumerate(cfg.pattern) if f == "moe")]
        expert_bytes = sum(e0["ffn"][k][0, 0].numel()
                           * e0["ffn"][k].element_size()
                           for k in ("experts_gate", "experts_up",
                                     "experts_down"))
        n_moe = sum(f == "moe" for _, f in cfg.pattern) * cfg.n_units
        # routing of the profiled prefill (the timed one's tokens): the
        # kept token-expert pairs over all MoE blocks
        pre_tokens = tokens
        kept = float(sum(int(k.sum()) for _, k in pre_routes.calls))
        check(len(pre_routes.calls) == n_moe, "a MoE block went unrecorded")
        drop = 1 - kept / (pre_tokens * cfg.top_k * n_moe)
        # experts some token was routed to, a MoE block and decode step
        routed = [int(torch.unique(e).numel()) for e, _ in dec_routes.calls]
        check(len(routed) == n_moe * SERVE_PROFILED,
              "a decode MoE block went unrecorded")
        print(f"{label}: prefill routing: {kept:,.0f} of "
              f"{pre_tokens * cfg.top_k * n_moe:,} token-expert pairs kept "
              f"(drop_frac {drop:.4f}, capacity "
              f"{moe.capacity(cfg, pre_tokens)} an expert); decode: {statistics.mean(routed):.1f} of "
              f"{cfg.n_experts} experts routed to a block and step (B = "
              f"{B}, top-{cfg.top_k})", flush=True)
    # Prefill: the products of every block kind over the prompt (causal
    # attention over (S + 1) / 2 keys a query on average), the LM head at
    # the last positions; bytes: the weights but the embedding (its B x S
    # rows), the caches written, the logits.
    mm, f32 = _model_ops(cfg, params, tokens, B, (S + 1) / 2, kept)
    pre_ops_ms = (mm / BF16_PEAK + f32 / FP32_OPS_PER_S) * 1e3
    pre_bytes = (nbytes - embed_bytes + tokens * row_bytes + kv_bytes
                 * S / (S + SERVE_NEW) + rec_bytes + logits_bytes)
    pre_bound = max(pre_ops_ms, pre_bytes / rate * 1e3)
    # Decode: the weights but the embedding (B rows of it) and the experts
    # no token was routed to, the recurrent states read and written, the
    # KV cache's filled part at the median timed step, the logits.
    filled = S + SERVE_NEW // 2 + 1
    kv_read = kv_bytes * filled / (S + SERVE_NEW)
    unrouted = sum(cfg.n_experts - r for r in routed) / max(
        SERVE_PROFILED, 1) * expert_bytes
    dec_bytes = (nbytes - embed_bytes + B * row_bytes - unrouted
                 + 2 * rec_bytes + kv_read + logits_bytes)
    dmm, df32 = _model_ops(cfg, params, B, B, filled,
                           B * cfg.top_k * sum(f == "moe" for _, f in
                                               cfg.pattern) * cfg.n_units)
    dec_ops_ms = (dmm / BF16_PEAK + df32 / FP32_OPS_PER_S) * 1e3
    dec_bound = max(dec_bytes / rate * 1e3, dec_ops_ms)
    rest = statistics.median(step_ms[1:])
    host = statistics.median(host_ms[1:])
    card = _smi()
    print(f"{label} on {card}: prefill {B} x {S} tokens "
          f"{prefill_ms[-1]:.1f} ms ("
          + (f"first call {prefill_ms[0]:.1f}" if len(prefill_ms) > 1
             else "one timed call") + ") against "
          f"{pre_bound:.2f} ms = max({mm / 1e12:.2f} T of matmul products "
          f"at {BF16_PEAK / 1e12:.0f} TFLOP/s + {f32 / 1e12:.3f} T of "
          f"float32 ops at {FP32_OPS_PER_S / 1e12:.0f} TFLOP/s = "
          f"{pre_ops_ms:.2f} ms, {pre_bytes / 1e9:.2f} GB at "
          f"{rate / 1e12:.2f} TB/s = {pre_bytes / rate * 1e3:.2f} ms) "
          f"(2 x all {n:,} params x tokens: "
          f"{2 * n * tokens / BF16_PEAK * 1e3:.1f} ms); decode "
          f"{rest:.2f} ms a token, median of steps 2-{SERVE_NEW} "
          f"(step 1 {step_ms[0]:.2f}; min {min(step_ms[1:]):.2f}, max "
          f"{max(step_ms[1:]):.2f}), against {dec_bound:.3f} ms = max("
          f"{dec_bytes / 1e9:.3f} GB at {rate / 1e12:.2f} TB/s: the "
          f"weights but the embedding and {unrouted / 1e9:.2f} GB of "
          f"unrouted experts, {B} embedding rows, {2 * rec_bytes / 1e6:.1f}"
          f" MB of recurrent state read and written, {kv_read / 1e9:.3f} "
          f"GB of KV cache at {filled} positions, the logits; "
          f"{dec_ops_ms:.3f} ms of ops) (all the weights: "
          f"{nbytes / rate * 1e3:.2f} ms); under sync-debug 'error' with "
          f"no sync", flush=True)
    print(f"{label} on {card}: decode on the host's clock, no sync: "
          f"{host:.2f} ms a token to queue, median of steps 2-"
          f"{SERVE_NEW} (min {min(host_ms[1:]):.2f}, max "
          f"{max(host_ms[1:]):.2f}) for {dec.kernels:.0f} device "
          f"kernels a token: {host / dec.kernels * 1e3:.2f} us of host "
          f"time a launch; the card's step {rest:.2f} ms, its kernels "
          f"busy {dec.busy_ms:.2f} ms", flush=True)
    short_s = SERVE_LSTM_PROFILED if lstm else S
    print(f"{label} on {card} under torch.profiler: prefill of {B} x "
          f"{short_s} "
          f"tokens {pre.kernels} kernels, device busy {pre.busy_ms:.1f} ms "
          f"(idle {1 - pre.busy_ms / prof_ms:.1%} of the timed "
          f"{prof_ms:.1f} ms), by kernel {pre.top}; decode "
          f"{dec.kernels} kernels a token, device busy "
          f"{dec.busy_ms:.2f} ms a token (idle "
          f"{1 - dec.busy_ms / rest:.1%} of the timed {rest:.2f} ms), "
          f"by kernel {dec.top}", flush=True)
    del params, prompt, m
    _release(torch)


def phase_model_serving(torch, dev, rate: float,
                        arch: str = SERVE_ARCH) -> None:
    """The model zoo served on the card: ``arch`` at full width and depth
    in bfloat16, timed, then at full width and SERVE_F32_LAYERS layers in
    float32 for the tight consistency checks."""
    from repro_torch.configs import get_config
    _release(torch)
    cfg = get_config(arch)
    _serve_model(torch, cfg.replace(param_dtype="bfloat16"), dev, rate)
    _serve_model(torch, cfg.replace(n_layers=SERVE_F32_LAYERS,
                                    param_dtype="float32"), dev, None)


def phase_mamba_mixer(torch, dev, rate: float) -> None:
    """The Mamba mixer alone at ``jamba-1.5-large-398b``'s published width
    (d_model 8192, d_inner 16384, d_state 16, d_conv 4, dt rank 512) in
    bfloat16: ``mamba_prefill`` on SERVE_BATCH x SERVE_PROMPT, then
    MAMBA_NEW ``mamba_decode`` steps under sync-debug "error". Held, as
    relative L2 distances, against the same weights and inputs in float32
    (``SERVE_TOL["bfloat16"]``), and the prefill + decode against every
    token decoded one at a time from the zeroed state (the recurrence
    itself) in bfloat16 (the same limit) and float32
    (``SERVE_TOL["float32"]``). Prints prefill and decode beside their
    bounds."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.utils import tree_leaves, tree_map
    _release(torch)
    cfg = get_config(MAMBA_ARCH).replace(param_dtype="bfloat16")
    B, S, D = SERVE_BATCH, SERVE_PROMPT, cfg.d_model
    gen = torch.Generator(dev).manual_seed(SEED)
    p16 = ssm.init_mamba(cfg, gen)
    x = torch.randn((B, S + MAMBA_NEW, D), generator=gen, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(p16))

    def serve(p, xs):
        out, st = ssm.mamba_prefill(p, cfg, xs[:, :S])
        steps = []
        for i in range(S, S + MAMBA_NEW):
            y, st = ssm.mamba_decode(p, cfg, xs[:, i:i + 1], st)
            steps.append(y)
        return out, torch.cat(steps, 1), st

    def one_at_a_time(p, xs):
        st = ssm.init_mamba_state(cfg, B, xs.dtype, dev)
        ys = []
        for i in range(S + MAMBA_NEW):
            y, st = ssm.mamba_decode(p, cfg, xs[:, i:i + 1], st)
            ys.append(y)
        y = torch.cat(ys, 1)
        return y[:, :S], y[:, S:], st

    with torch.no_grad():
        pre_ms = []
        for _ in range(2):                 # the first call warms cuBLAS up
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out, st = ssm.mamba_prefill(p16, cfg, x[:, :S])
            b.record()
            b.synchronize()
            pre_ms.append(a.elapsed_time(b))
        ends = [torch.cuda.Event(enable_timing=True)
                for _ in range(MAMBA_NEW + 1)]
        ends[0].record()
        dec = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(MAMBA_NEW):
                y, st = ssm.mamba_decode(p16, cfg, x[:, S + i:S + i + 1], st)
                ends[i + 1].record()
                dec.append(y)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        got = (out, torch.cat(dec, 1), st)
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(got)),
              "Mamba outputs not finite")
        busy = _device_busy(torch, lambda: ssm.mamba_prefill(
            p16, cfg, x[:, :S]))
        busy += _device_busy(torch, lambda: [ssm.mamba_decode(
            p16, cfg, x[:, S:S + 1], st) for _ in range(SERVE_PROFILED)],
            SERVE_PROFILED)
        p32 = tree_map(lambda t: t.float(), p16)
        got32 = serve(p32, x.float())
        errs = {}
        for name, a_, b_, tol in (
                ("bf16 vs float32", got, got32, SERVE_TOL["bfloat16"]),
                ("bf16 vs one token at a time", got, one_at_a_time(p16, x),
                 SERVE_TOL["bfloat16"]),
                ("float32 vs one token at a time", got32,
                 one_at_a_time(p32, x.float()), SERVE_TOL["float32"])):
            d = max(_rel_l2(torch, u, v) for u, v in
                    zip(tree_leaves(a_), tree_leaves(b_)))
            check(d <= tol, f"Mamba mixer: {name} at relative L2 {d:.3g} "
                  f"> {tol}")
            errs[name] = (d, tol)
        st_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(st))
    tokens = B * S
    mats = sum(p16[k].numel() for k in ("in_proj", "x_proj", "dt_proj",
                                        "out_proj"))
    f32 = tokens * (8 * cfg.d_inner * cfg.d_state
                    + 2 * cfg.d_conv * cfg.d_inner)
    pre_ops_ms = (2 * mats * tokens / BF16_PEAK + f32 / FP32_OPS_PER_S) * 1e3
    io = 2 * tokens * D * 2                          # x read, out written
    pre_bytes = nbytes + io + st_bytes
    pre_bound = max(pre_ops_ms, pre_bytes / rate * 1e3)
    dec_bytes = nbytes + 2 * st_bytes + 2 * B * D * 2
    dec_ops_ms = (2 * mats * B / BF16_PEAK
                  + f32 / S / FP32_OPS_PER_S) * 1e3
    dec_bound = max(dec_bytes / rate * 1e3, dec_ops_ms)
    rest = statistics.median(step_ms[1:])
    pre, dec_b = busy
    label = (f"Mamba mixer at {MAMBA_ARCH}'s width (d_model {D}, d_inner "
             f"{cfg.d_inner}, d_state {cfg.d_state}, d_conv {cfg.d_conv}, "
             f"dt rank {cfg.resolved_dt_rank}) bf16")
    print(f"{label}: consistency (relative L2): " + ", ".join(
        f"{k} {d:.3g} (limit {t})" for k, (d, t) in errs.items()),
        flush=True)
    card = _smi()
    print(f"{label} on {card}: prefill {B} x {S} tokens {pre_ms[1]:.2f} ms"
          f" (first call {pre_ms[0]:.2f}) against {pre_bound:.3f} ms = max("
          f"{2 * mats * tokens / 1e12:.3f} T of products at "
          f"{BF16_PEAK / 1e12:.0f} TFLOP/s + {f32 / 1e9:.2f} G float32 scan "
          f"and conv ops at {FP32_OPS_PER_S / 1e12:.0f} TFLOP/s, "
          f"{pre_bytes / 1e9:.3f} GB at {rate / 1e12:.2f} TB/s); decode "
          f"{rest:.3f} ms a token, median of steps 2-{MAMBA_NEW} (step 1 "
          f"{step_ms[0]:.3f}) against {dec_bound:.4f} ms ({nbytes / 1e9:.3f}"
          f" GB of weights + {2 * st_bytes / 1e6:.1f} MB of state read and "
          f"written at {rate / 1e12:.2f} TB/s), under sync-debug 'error'",
          flush=True)
    print(f"{label} on {card} under torch.profiler: prefill "
          f"{pre.kernels} kernels, "
          f"device busy {pre.busy_ms:.2f} ms (idle "
          f"{1 - pre.busy_ms / pre_ms[1]:.1%} of the timed "
          f"{pre_ms[1]:.2f} ms), by kernel {pre.top}; decode "
          f"{dec_b.kernels:.0f} kernels a step, busy {dec_b.busy_ms:.3f} ms "
          f"(idle {1 - dec_b.busy_ms / rest:.1%} of the timed "
          f"{rest:.3f} ms)", flush=True)
    del p16, p32, x, got, got32, st, out
    _release(torch)


def _lm_federation(torch, dev, seed: int = SEED, arch: str = SERVE_ARCH):
    """``launch/train.py simulate``'s federation through the port: the
    reduced ``arch``, LM_WORKERS workers on SyntheticLM sequences split
    by ``sequence_split``, batch sizes from (16, 8); the weights drawn on
    the CPU from ``seed`` and placed on ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import BatchIterator
    from repro_torch.data.synthetic import SyntheticLM, sequence_split
    from repro_torch.fed.worker import Worker, make_worker_configs
    from repro_torch.models import build_model
    m = build_model(get_config(arch).reduced())
    toks = SyntheticLM(n_sequences=LM_SEQUENCES, seq_len=LM_SEQ_LEN,
                       vocab=m.cfg.vocab, seed=seed).generate()
    splits = sequence_split(len(toks), LM_WORKERS, seed=seed)
    cfgs = make_worker_configs(LM_WORKERS, [len(s) for s in splits],
                               seed=seed, batch_menu=(16, 8))
    workers = [Worker(cfg=cfgs[k],
                      loader=BatchIterator((toks[splits[k]],),
                                           cfgs[k].batch_size, seed=k),
                      loss_and_grad=m.loss_and_grad)
               for k in range(LM_WORKERS)]
    params = m.init(torch.Generator().manual_seed(seed), device=dev)
    return m, toks, workers, params


def phase_fed_lm(torch, dev, arch: str = SERVE_ARCH) -> dict:
    """The reduced ``arch`` federated through ``run_fedpc``: the wire
    kernels #1 and #2 on the model zoo's tree. Two runs on the card
    (bitwise equal), the first's rounds each held to
    ``core.fedpc.master_round`` over its own local models as trees
    (``_second_oracle``: #1 and #2 at this path's shapes), one on the CPU
    (the plain versions: same pilots); a captured training step of an LM
    worker replayed against the same step called eagerly."""
    import numpy as np

    from repro_torch.core import flat as fl
    from repro_torch.core import protocol as proto
    from repro_torch.data.pipeline import BatchIterator
    from repro_torch.fed.simulator import FedSimulator
    from repro_torch.fed.worker import Worker
    from repro_torch.utils import tree_size
    runs, own = [], {"uplink_stacked": 0, "master": 0}
    kept: list = []
    for run in range(2):
        m, toks, workers, params = _lm_federation(torch, dev, arch=arch)
        if not run:
            layout = fl.layout_of(params)
        d = _drive(torch, FedSimulator(workers, params, device=dev), ROUNDS,
                   capture=None if run else kept)
        want = proto.fedpc_bytes_per_round(proto.model_size_bytes(params),
                                           LM_WORKERS)
        for k, n in _check_run(torch, d.res, d.launches,
                               {k: ROUNDS for k in own}, [want] * ROUNDS,
                               workers, f"federated LM {arch}").items():
            own[k] += n
        runs.append(d.res)
    _same_runs(torch, *runs, f"federated LM {arch} card run twice")
    oracle = [_second_oracle(torch, k, layout) for k in kept]
    _, _, cworkers, cparams = _lm_federation(torch, torch.device("cpu"),
                                             arch=arch)
    cres = FedSimulator(cworkers, cparams, device="cpu").run_fedpc(ROUNDS)
    check(cres.pilot_history == runs[0].pilot_history,
          f"federated LM {arch}: pilots card {runs[0].pilot_history} cpu "
          f"{cres.pilot_history}")
    check(np.allclose(runs[0].costs, cres.costs, rtol=1e-3),
          f"federated LM {arch}: costs card {runs[0].costs} cpu "
          f"{cres.costs}")
    # A uniform LM worker (64 sequences at batch 16): its captured step.
    cfg = workers[1].cfg
    w = Worker(cfg=cfg, loader=BatchIterator((toks[:64],), 16, seed=0),
               loss_and_grad=m.loss_and_grad)
    w.opt_state = w.opt.init(params)
    steps = _graph_equals_eager(torch, w, params, dev)
    print(f"federated LM: {m.cfg.name} reduced, {tree_size(params):,} "
          f"params, {LM_WORKERS} workers, {LM_SEQUENCES} x {LM_SEQ_LEN} "
          f"tokens; two card runs bitwise equal; card and CPU agree, pilots "
          f"{cres.pilot_history}, costs card "
          f"{[round(c, 5) for c in runs[0].costs]} cpu "
          f"{[round(c, 5) for c in cres.costs]}; core.fedpc.master_round "
          f"over each round's {LM_WORKERS} local models as trees == "
          f"round_step's kernels #1/#2 (rows {layout.rows:,}): the same "
          f"pilot, new params within 2 ulps + 1e-8, max abs diff "
          f"{', '.join(f'round {t} {e:.3e}' for t, e in oracle)}; an LM "
          f"worker's graph replay == its eager step over {steps} steps, "
          f"bitwise", flush=True)
    del kept, oracle
    _release(torch)
    return own


def _bitwise(torch, a, b) -> tuple[bool, float]:
    """(bitwise equal, largest absolute difference): floats compared as
    their int32 bits, integers as values."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False, float("inf")
    if a.dtype == torch.float32:
        return (torch.equal(a.view(torch.int32), b.view(torch.int32)),
                float((a - b).abs().max()))
    return torch.equal(a, b), float((a.long() - b.long()).abs().max())


def phase_check_unfused(torch, dev) -> dict:
    """The one-worker uplinks (#3, #4, #5), the encode (#11, #12), pack and
    unpack (#13) and the unfused master (#14) against their plain versions
    on the card, bitwise: at the main-path shapes (one worker's view of
    R = ROWS / 4 rows; the master over N = 10 workers) and small ones; #13
    on all 256 byte values, unpack on 1, 3 and 8 rows of random bytes, pack
    on random int8 codes, #14 at N = 1, 10, 33 on ternary and on random
    int8 codes. Returns the largest absolute difference per kernel at the
    main-path shape."""
    from repro_torch.core.ternary import ternarize, ternarize_round1
    from repro_torch.kernels import fused_wire as fw
    from repro_torch.kernels import master_update as mu
    from repro_torch.kernels import pack2bit as pk
    from repro_torch.kernels import ternary_encode as te
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    r_main = ROWS // 4
    errs = dict.fromkeys(("uplink", "uplink_round1", "uplink_traced",
                          "encode", "encode_round1", "pack", "unpack",
                          "master_update"), 0.0)
    cases = dict.fromkeys(errs, 0)

    def record(kind, got, want, where, main):
        ok, diff = _bitwise(torch, got, want)
        check(ok, f"{kind} differs from plain at {where}")
        if main:
            errs[kind] = max(errs[kind], diff)
        cases[kind] += 1

    alpha = torch.tensor(0.01, device=dev)
    for n, r in ((N_WORKERS, r_main), (3, 8), (1, 2)):
        main = r == r_main
        q, p1, p2, beta, w, _k = _inputs(torch, n, r, gen, dev)
        q0 = q[0]
        record("uplink_round1", fw.ternary_pack_round1(q0, p1, 0.01),
               fw.ternary_pack_round1_plain(q0, p1, 0.01), f"R={r}", main)
        record("uplink", fw.ternary_pack(q0, p1, p2, 0.2),
               fw.ternary_pack_plain(q0, p1, p2, 0.2), f"R={r}", main)
        for t in (1, 2, 3):
            tt = torch.tensor(t, dtype=torch.int32, device=dev)
            for k in range(n):                 # beta_k sliced from a vector
                record("uplink_traced",
                       fw.ternary_pack_any(q[k], p1, p2, tt, beta[k], alpha),
                       fw.ternary_pack_any_plain(q[k], p1, p2, tt, beta[k],
                                                 alpha),
                       f"R={r} t={t} worker {k}", main)
        f0, f1, f2 = (x.reshape(4 * r, 128) for x in (q0, p1, p2))
        codes = te.ternary_encode(f0, f1, f2, 0.2)
        record("encode", codes, ternarize(f0, f1, f2, 0.2), f"R={r}", main)
        record("encode_round1", te.ternary_encode_round1(f0, f1, 0.01),
               ternarize_round1(f0, f1, 0.01), f"R={r}", main)
        packed = pk.pack2bit(codes.view(r, 512))
        record("pack", packed, pk.pack2bit_plain(codes.view(r, 512)),
               f"R={r}", main)
        record("unpack", pk.unpack2bit(packed), pk.unpack2bit_plain(packed),
               f"R={r}", main)
        tern = torch.stack([te.ternary_encode(x.reshape(4 * r, 128), f1, f2,
                                              0.2) for x in q])
        record("master_update", mu.master_update(f0, tern, w, f1, f2),
               mu.master_update_plain(f0, tern, w, f1, f2), f"N={n} R={r}",
               main)
        del q, p1, p2, codes, packed, tern
    every = torch.arange(256, dtype=torch.uint8, device=dev).repeat(32)
    every = every.view(64, 128)
    record("unpack", pk.unpack2bit(every), pk.unpack2bit_plain(every),
           "all 256 bytes", False)
    check(torch.equal(pk.pack2bit(pk.unpack2bit(every)), every),
          "pack(unpack(b)) != b over all 256 bytes")
    for r in (1, 3, 8):
        b = torch.randint(0, 256, (r, 128), generator=gen, device=dev,
                          dtype=torch.uint8)
        record("unpack", pk.unpack2bit(b), pk.unpack2bit_plain(b),
               f"{r} rows of random bytes", False)
    for lo, hi in ((-1, 3), (-128, 128)):
        c = torch.randint(lo, hi, (64, 512), generator=gen, device=dev,
                          dtype=torch.int8)
        record("pack", pk.pack2bit(c), pk.pack2bit_plain(c),
               f"codes in [{lo}, {hi})", False)
    for n in (1, N_WORKERS, 33):
        q, p1, p2, _beta, w, _k = _inputs(torch, n, 16, gen, dev)
        f0, f1, f2 = (x.reshape(64, 128) for x in (q[0], p1, p2))
        for lo, hi in ((-1, 2), (-128, 128)):
            tern = torch.randint(lo, hi, (n, 64, 128), generator=gen,
                                 device=dev, dtype=torch.int8)
            record("master_update", mu.master_update(f0, tern, w, f1, f2),
                   mu.master_update_plain(f0, tern, w, f1, f2),
                   f"N={n} codes in [{lo}, {hi})", False)
    torch.cuda.synchronize()
    print("kernels: " + ", ".join(f"{k} ({v} cases)" for k, v in
                                   cases.items())
          + " bitwise equal to their plain versions (unpack on all 256 "
          "bytes, pack on random int8, master_update at N = 1, 10, 33)",
          flush=True)
    return errs


def _leaf_checks(torch, dev, leaves: dict, n_workers: int) -> None:
    """The arbitrary-shape ``ops`` functions on the card against the same
    calls on CPU copies (the plain versions), bitwise; ``leaves`` maps a
    name to (q of each worker, P^{t-1}, P^{t-2}) of one shape."""
    from repro_torch.kernels import ops
    for name, (qs, p1, p2) in leaves.items():
        outs = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            qd = [x.to(d) for x in qs]
            a, b = p1.to(d), p2.to(d)
            codes = [ops.ternary_encode(x, a, b, 0.2) for x in qd]
            packed = ops.pack2bit(codes[0])
            w = torch.linspace(0.0, 0.1, n_workers, device=d)
            outs[where] = [codes[0], ops.ternary_encode_round1(qd[0], a,
                                                                0.01),
                            packed, ops.unpack2bit(packed, codes[0].numel()),
                            ops.ternary_pack(qd[0], a, b, 0.2),
                            ops.ternary_pack_round1(qd[0], a, 0.01),
                            ops.master_update(qd[0], torch.stack(codes), w, a,
                                              b)]
        for i, (x, y) in enumerate(zip(outs["card"], outs["cpu"])):
            check(_bitwise(torch, x.cpu(), y)[0],
                  f"ops output {i} of {name} differs from the plain version")
        n = qs[0].numel()
        check(torch.equal(outs["card"][2], outs["card"][4]),
              f"{name}: fused uplink differs from pack2bit(encode)")
        check(outs["card"][2].numel() == -(-n // 4), f"{name}: byte count")
        if n % 4:       # the zero pad's fields in the last byte are code 0
            tail = int(outs["card"][2][-1]) >> (2 * (n % 4))
            check(tail == 0b01010101 >> (2 * (n % 4)),
                  f"{name}: pad fields of the last byte are not code 0")
    shapes = ", ".join(f"{k} {tuple(v[1].shape)}" for k, v in leaves.items())
    print(f"shapes: ops.ternary_encode(_round1), pack2bit, unpack2bit, "
          f"ternary_pack(_round1) and master_update over {n_workers} workers "
          f"on {shapes} bitwise equal to their plain versions; pad fields "
          f"code 0", flush=True)


def phase_worker_rounds(torch, dev, captured: list) -> dict:
    """At full width, on each round's own inputs from the plain slice
    (``captured``: per round ``_drive``'s capture of ``round_step``, the
    flat layout last), bitwise:

    - the per-worker static round: ten ``WirePath.uplink`` launches (#5 at
      t = 1, #4 after), stacked, then ``WirePath.master`` (#2) == the
      batched round's bytes and new buffer;
    - the per-worker traced round: ten ``WirePath.uplink_traced`` (#3) at
      a device t with beta_k sliced from a per-worker vector, under
      sync-debug "error", then the master == the batched round;
    - the unfused round: per worker ``ops.ternary_encode`` (#11; #12 at
      t = 1), ``ops.pack2bit`` and ``ops.unpack2bit`` (#13), then one
      ``ops.master_update`` (#14, t > 1) with ``core.update.
      masked_weights``: bytes == #1's, codes back == codes, new buffer ==
      #2's; at t = 1 Eq. (3) by ``core.update.master_update_round1``
      (plain, no kernel) within rtol 1e-5, atol 1e-6 of #2's.

    Each path's launches are counted from 0 and must be one uplink a
    worker and one master, or three launches a worker and one master.
    Then the ``ops`` functions on the MLP's leaves and odd shapes. Returns
    the launches of each new kernel over the three paths."""
    import numpy as np

    from repro_torch.core import flat as fl
    from repro_torch.core import update as cu
    from repro_torch.fed import rounds as rd
    from repro_torch.kernels import ops
    layout = captured[-1]
    wire = rd.WirePath()
    cfg = wire.cfg
    n = N_WORKERS
    m = ROWS * 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    betas = torch.rand((n,), generator=gen, device=dev) * 0.3
    totals: dict[str, int] = {}

    def counted(label: str, expect: dict, fn):
        torch.cuda.synchronize()
        _zero_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in _read_counts().items() if v}
        check(got == expect, f"{label}: launches {got}, expected {expect}")
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
        return out

    def same(a, b, what: str) -> None:
        check(_bitwise(torch, a, b)[0], what)

    r1_gap = 0.0
    for t, (state, bufs, _, sizes, _, info) in enumerate(captured[:-1],
                                                         start=1):
        p1, p2, k = state.buf_p1, state.buf_p2, info["k_star"]
        tt = torch.tensor(t, dtype=torch.int32, device=dev)
        shares = sizes.float() / sizes.float().sum()
        w = wire.weights(shares, k, tt)

        def static():
            packed = torch.stack([wire.uplink(bufs[j], p1, p2, t=t)
                                  for j in range(n)])
            return packed, wire.master(bufs, k, packed, w, p1, p2, t=tt)
        up = "uplink_round1" if t == 1 else "uplink"
        packed, new = counted(f"static round {t}", {up: n, "master": 1},
                              static)
        want_new, want_packed = wire.round_from_stacked(bufs, k, w, p1, p2,
                                                        t=tt)
        same(packed, want_packed, f"static round {t}: bytes")
        same(new, want_new, f"static round {t}: new buffer")

        wb = wire.weights(shares, k, tt, betas=betas)

        def traced():
            torch.cuda.set_sync_debug_mode("error")
            try:
                pk_ = torch.stack([wire.uplink_traced(bufs[j], p1, p2, t=tt,
                                                      beta=betas[j])
                                   for j in range(n)])
                return pk_, wire.master(bufs, k, pk_, wb, p1, p2, t=tt)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        packed_b, new_b = counted(f"traced round {t}",
                                  {"uplink_traced": n, "master": 1}, traced)
        want_new_b, want_packed_b = wire.round_from_stacked(
            bufs, k, wb, p1, p2, t=tt, betas=betas)
        same(packed_b, want_packed_b, f"traced round {t}: bytes")
        same(new_b, want_new_b, f"traced round {t}: new buffer")

        pilot = bufs.index_select(0, k.reshape(1))[0]

        def unfused():
            if t == 1:
                codes = [ops.ternary_encode_round1(bufs[j], p1, cfg.alpha1)
                         for j in range(n)]
            else:
                codes = [ops.ternary_encode(bufs[j], p1, p2, cfg.beta)
                         for j in range(n)]
            wire_bytes = [ops.pack2bit(c) for c in codes]
            back = torch.stack([ops.unpack2bit(b, m) for b in wire_bytes])
            out = None
            if t > 1:
                wm = cu.masked_weights(shares, torch.full(
                    (n,), cfg.beta, device=dev), k)
                out = ops.master_update(pilot, back.view(n, ROWS, 128), wm,
                                        p1, p2)
            return codes, wire_bytes, back, out
        expect = {"encode_round1" if t == 1 else "encode": n, "pack": n,
                  "unpack": n}
        if t > 1:
            expect["master_update"] = 1
        codes, wire_bytes, back, new_u = counted(f"unfused round {t}",
                                                 expect, unfused)
        for j in range(n):
            same(wire_bytes[j], want_packed[j].reshape(-1),
                 f"unfused round {t}: worker {j}'s bytes differ from #1's")
            same(back[j], codes[j].reshape(-1),
                 f"unfused round {t}: worker {j}'s codes do not come back")
        if t > 1:
            same(new_u, want_new, f"unfused round {t}: new buffer != #2's")
        else:
            for j in range(n):
                same(wire_bytes[j], packed[j].reshape(-1),
                     f"unfused round 1: worker {j}'s bytes differ from #5's")
            new_u = cu.master_update_round1(pilot, back.view(n, ROWS, 128),
                                            shares, k, cfg.alpha0)
            r1_gap = float((new_u - want_new).abs().max())
            check(bool(torch.allclose(new_u, want_new, rtol=1e-5,
                                      atol=1e-6)),
                  f"unfused round 1 (plain Eq. (3)) off #2's by {r1_gap}")
        del codes, wire_bytes, back, new_u, packed, packed_b, new, new_b
    print(f"worker rounds: full width, rounds 1-{ROUNDS} of the plain slice: "
          f"per-worker static round ({n} uplinks + master) and per-worker "
          f"traced round (beta_k from a per-worker vector, no host sync) == "
          f"the batched round, bytes and new buffer; unfused round (encode, "
          f"pack, unpack a worker + master_update) == the fused round, bytes "
          f"and new buffer, codes unpacked == codes encoded; round 1's plain "
          f"Eq. (3) within {r1_gap:.3g} of #2's; launches {totals}",
          flush=True)

    # The ops functions on the MLP's own leaves (round 2's models), and on
    # sizes with n % 4 != 0 and n % 512 != 0.
    state, bufs = captured[1][:2]
    p1, p2 = state.buf_p1, state.buf_p2
    trees = [fl.unflatten_tree(b, layout) for b in (*bufs[:3], p1, p2)]
    leaves = {}
    for name in ("layer0.w", "layer2.w", "layer2.b"):
        a, b = name.split(".")
        leaves[name] = ([tr[a][b] for tr in trees[:3]], trees[3][a][b],
                        trees[4][a][b])
    for size, shape in ((999, (999,)), (105, (3, 5, 7))):
        leaves[str(shape)] = ([x.reshape(-1)[:size].reshape(shape)
                               for x in bufs[:3]],
                              p1.reshape(-1)[:size].reshape(shape),
                              p2.reshape(-1)[:size].reshape(shape))
    check(np.prod(leaves["layer0.w"][1].shape) == N_FEATURES * HIDDEN[0],
          "unexpected first weight")
    _leaf_checks(torch, dev, leaves, 3)
    return totals


_queue: dict = {}       # the sleep's rate, its length and the L2 scrub's time


def _median_ms(torch, fn, queued: bool = False,
               calls: int = QUEUED) -> float:
    """Median over REPEATS of one call's time in CUDA events. By default
    one call from an idle card: the wrapper's host time up to its launch
    counts. ``queued``: ``calls`` calls enqueued behind a ``torch.cuda._sleep``
    that keeps the card busy meanwhile, so the events time the device
    alone, each call after a read of SCRUB_BYTES that leaves none of its
    operands in the 50 MB L2 cache; the scrub's own time is taken off.
    The host must queue the calls within 0.8 of the sleep: where it does
    not (a busy host), the sleep is doubled and that repeat timed again,
    at most SLEEP_DOUBLINGS times before the timing fails."""
    if queued and not _queue:
        scrub = torch.empty(SCRUB_BYTES // 4, dtype=torch.int32,
                            device="cuda")
        _queue["read"] = lambda: scrub.max()
        _queue["cycles"] = SLEEP_CYCLES
        _queue["ms_per_cycle"] = _median_ms(
            torch, lambda: torch.cuda._sleep(SLEEP_CYCLES)) / SLEEP_CYCLES
        _queue["host_share"] = 0.0
        _queue["scrub_ms"] = _median_ms(torch, lambda: None, queued=True)
    fn()
    torch.cuda.synchronize()
    times = []
    calls = calls if queued else 1
    for _ in range(REPEATS):
        for doubling in range(SLEEP_DOUBLINGS + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(_queue["cycles"])
            t0 = time.perf_counter()
            a.record()
            for _ in range(calls):
                if queued:
                    _queue["read"]()
                fn()
            b.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            b.synchronize()
            if not queued:
                break
            sleep_ms = _queue["cycles"] * _queue["ms_per_cycle"]
            if host_ms < 0.8 * sleep_ms:
                _queue["host_share"] = max(_queue["host_share"],
                                           host_ms / sleep_ms)
                break
            check(doubling < SLEEP_DOUBLINGS,
                  f"queued timing: the host took {host_ms:.2f} ms to queue "
                  f"{calls} calls, the sleep lasts {sleep_ms:.2f} ms")
            _queue["cycles"] *= 2
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times) - _queue.get("scrub_ms", 0.0) * queued


def _kernel_ms(torch, fn) -> tuple[float, float]:
    """(device time per launch with the launches queued, time of one call
    from the host) of a kernel's wrapper."""
    return _median_ms(torch, fn, queued=True), _median_ms(torch, fn)


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
    saved = _read_counts()
    rows, kernel_ms = [], {}
    for kind, (nbytes, ops, kern, plain, name, replaces) in work.items():
        ms, call_ms = _kernel_ms(torch, kern)
        plain_ms = _median_ms(torch, plain)
        kernel_ms[kind] = call_ms
        bytes_ms = nbytes / rate * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"time: {name} {ms:.4f} ms on the device ({call_ms:.4f} ms a "
              f"call from the host; plain {plain_ms:.4f} ms); bound "
              f"{bound_ms:.4f} ms = {nbytes / 1e6:.1f} MB at "
              f"{rate / 1e12:.2f} TB/s; {bound_ms / ms:.1%} of bound; "
              f"achieved {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s", flush=True)
        rows.append({
            "name": name, "row": 1 if kind == "uplink_stacked" else 2,
            "route": "cuda",
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
    _restore_counts(saved)                         # timing launches not counted
    return rows


def uplink_masked_int_ops(n: int, elems: int, bits: int, rr: bool,
                          masks: bool, expansions: int, folds: int = 2
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
    folds into the last xor, and ``u >> 16`` of a mix32 is the shift its
    last step already made. Per element: the RR counter hash (9, 6); the
    mask counter hash per element pair at 16 bits (4.5, 3 per element),
    shared with RR at 32 or (9, 6) without it. Per worker and element: the
    weight multiply (1, 0) and, with RR, a stream word (9, 6), a compare
    (1, 1), a mod 3 (a multiply-high, a shift, a multiply-add: 3, 1) and a
    select (1, 0). Per stream expansion (``expansions``: active unordered
    pairs when each pair is expanded once and folded into both workers,
    ``folds`` = 2; active entries of the sign matrix when each worker
    expands its own row, ``folds`` = 1): at 16 bits a stream word of two
    elements (4.5, 3 per element) and a multiply-add per element and fold;
    at 32 bits per element a stream word (9, 6) and a multiply-add per
    fold. Float operations are left out."""
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
        per_word = (3.0, 4.5) if bits == 16 else (6.0, 9.0)
        alu += expansions * elems * per_word[0]
        total += expansions * elems * (per_word[1] + folds)
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
    active = int((signs != 0).sum())               # ordered: the row fold's
    pairs = int((signs.triu(1) != 0).sum())        # unordered: the least
    tt = torch.tensor(2, dtype=torch.int32, device=dev)
    m = r * 512                                    # elements per view
    f32 = 4
    saved = _read_counts()
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
        alu, total = uplink_masked_int_ops(n, m, bits, True, True, pairs)
        row_alu, row_total = uplink_masked_int_ops(n, m, bits, True, True,
                                                   active, folds=1)
        work = {
            "uplink_masked": (
                up_bytes, int_bound_ms(alu, total),
                f"{alu / 1e9:.2f} G ALU-only / {total / 1e9:.2f} G int ops "
                f"({pairs} pairs expanded once)",
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
        kernel_ms, device_ms = {}, {}
        for kind, (nbytes, ops_ms, ops_text, kern, plain, name,
                   replaces) in work.items():
            ms, call_ms = _kernel_ms(torch, kern)
            plain_ms = _median_ms(torch, plain)
            kernel_ms[kind], device_ms[kind] = call_ms, ms
            bytes_ms = nbytes / rate * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            by = "bytes" if bytes_ms >= ops_ms else "operations"
            print(f"time: {name} {bits}-bit {ms:.4f} ms on the device "
                  f"({call_ms:.4f} ms a call from the host; plain "
                  f"{plain_ms:.4f} ms); bound {bound_ms:.4f} ms by {by}: "
                  f"{nbytes / 1e6:.1f} MB at {rate / 1e12:.2f} TB/s = "
                  f"{bytes_ms:.4f} ms, {ops_text} = {ops_ms:.4f} ms; "
                  f"{bound_ms / ms:.1%} of bound; achieved "
                  f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s", flush=True)
            if bits == 16:
                rows.append({
                    "name": name, "row": 6 if kind == "uplink_masked" else 7,
                    "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/masked_wire.cu",
                    "replaces": replaces, "launches": launches[kind],
                    "max_abs_err": errs[kind], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": None})
        # The row-fold kernel at the same shape, in this run: the pair
        # kernel's yardstick, and the bound it was held to before.
        by_rows = mw._ternary_pack_masked_rows(*args, **kw)
        check(torch.equal(pvm.as_u64(by_rows), pvm.as_u64(words)),
              f"{bits}-bit row-fold and pair kernels differ at N = {n}")
        del by_rows
        pair_ms = device_ms["uplink_masked"]
        rows_ms = _median_ms(torch, lambda: mw._ternary_pack_masked_rows(
            *args, **kw), queued=True)
        old_bound = max(up_bytes / rate * 1e3,
                        int_bound_ms(row_alu, row_total))
        new_bound = max(up_bytes / rate * 1e3, int_bound_ms(alu, total))
        print(f"time: ternary_pack_masked {bits}-bit on the device, same "
              f"run: pair kernel {pair_ms:.4f} ms, row-fold kernel "
              f"{rows_ms:.4f} ms ({rows_ms / pair_ms:.2f}x); bound "
              f"{new_bound:.4f} ms with each of the {pairs} active pairs "
              f"expanded once ({alu / 1e9:.2f} G ALU-only / "
              f"{total / 1e9:.2f} G int ops), {old_bound:.4f} ms by the "
              f"row fold's {active} expansions ({row_alu / 1e9:.2f} G / "
              f"{row_total / 1e9:.2f} G)", flush=True)
        # Where the uplink's time goes: the same launch without RR, without
        # masks, and without either.
        parts = []
        for rr_on, masks_on in ((True, False), (False, True),
                                (False, False)):
            kw_part = dict(rr_threshold=thr if rr_on else 0, word_bits=bits,
                           use_masks=masks_on)
            part_ms = _median_ms(torch, lambda: mw.ternary_pack_masked(
                *args, **kw_part), queued=True)
            part_bound = max(
                (up_bytes - (0 if masks_on else keys.numel() * 8)) / rate
                * 1e3, int_bound_ms(*uplink_masked_int_ops(
                    n, m, bits, rr_on, masks_on, pairs)))
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
    _restore_counts(saved)                         # timing launches not counted
    return rows


def phase_times_tree(torch, dev, rate: float, launches: dict,
                     errs: dict) -> list[dict]:
    """The tree's and the repair's kernels, the masked master over C = 3
    rows and their plain versions at the main-path shapes (N = 10 leaves;
    the plain tree's fanout 2 and uint32 words for ``partial_sum`` and the
    masks-off levels; the masked tree's fanout 4 and 16-bit words; the
    repair of round 1 of ``FAULTS``), and each tree round's whole wire
    beside its kernels."""
    from repro_torch.core.tree import TreeSpec
    from repro_torch.fed import faults as ft
    from repro_torch.fed import rounds as rd
    from repro_torch.kernels import fused_wire as fw
    from repro_torch.kernels import masked_wire as mw
    from repro_torch.kernels import partial_sum as ps
    from repro_torch.privacy import masking as pvm
    from repro_torch.privacy import recovery as pvr
    from repro_torch.privacy.spec import PrivacySpec
    n, r = N_WORKERS, ROWS // 4
    m = r * 512                                    # elements per view
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    q, p1, p2, beta, w, k = _inputs(torch, n, r, gen, dev)
    bufs = q.view(n, ROWS, 128)
    f1, f2 = p1.view(ROWS, 128), p2.view(ROWS, 128)
    tt = torch.tensor(2, dtype=torch.int32, device=dev)
    t1 = torch.tensor(1, dtype=torch.int32, device=dev)
    saved = _read_counts()
    spec = PrivacySpec(dp_epsilon=DP_EPSILON, recovery_threshold=2,
                       enforce=False)
    fan = MASKED_TREE_FANOUT
    g = -(-n // fan)
    g1 = -(-n // TREE_FANOUT)                       # the plain tree's level 1
    # The main path's operands: plain leaves, masked leaves with
    # tree-scoped signs, the level-1 keys and signs, round 1's repair.
    tree_wire = rd.WirePath(privacy=spec, tree=TreeSpec(fan),
                            faults=ft.FaultPlan(**FAULTS))
    packed = fw.ternary_pack_stacked(q, p1, p2, tt, beta, 0.01)
    wq24 = pvm.quantize_weights(w, rd.TREE_PLAIN_FIXPOINT_BITS)
    y, _wq = tree_wire.uplink_masked(bufs, f1, f2, t=t1, w=w, betas=beta)
    keys = pvm.pair_stream_keys(pvm.tree_level_seed(0, 1), g, t1)
    signs = pvm.tree_pair_signs(g, g, device=dev)
    active = int((signs != 0).sum())
    top = ps.masked_partial_sum(y, keys, signs, fanout=fan, sibling=g)
    alive = ft.FaultPlan(**FAULTS).alive(t1, n)
    alive_eff, _dead = pvr.effective_masks(None, alive, 2, fan, n)
    rkeys, rcoeff = repair_operands(torch, dev)
    live_pairs = int((rcoeff != 0).sum())
    pairs = rkeys.shape[0]
    row0 = top[0].contiguous()
    rep = row0.clone()                  # repaired in place, as the tree does
    spare = torch.empty_like(row0)
    smult = spec.scale_mult
    sum_wq = pvm.to_words(pvm.as_u64(_wq).sum(), 32)
    # (bytes, ALU-only ops, all int ops, kernel, plain, name, replaces,
    # source, kind, what). Integer ops as nvcc compiles them (the masked
    # uplink's model, chip_smoke.uplink_masked_int_ops): a counter hash or
    # a stream word is 9 ops, 6 ALU-only; at 16 bits one hash or stream
    # word serves two elements, and a stream word's signed fold costs two
    # multiply-adds (5.5 ops a element, 3 ALU-only); a 2-bit field decode
    # is a shift and a mask (ALU-only) and a multiply-add.
    work = {
        "partial_sum": (
            n * m // 4 + 4 * n + g1 * 4 * m, 2 * n * m, 3 * n * m,
            lambda: ps.partial_sum(packed, wq24, fanout=TREE_FANOUT,
                                   word_bits=32),
            lambda: ps.partial_sum_plain(packed, wq24, fanout=TREE_FANOUT,
                                         word_bits=32),
            "partial_sum", "src/repro/kernels/partial_sum.py:179",
            "partial_sum.cu", f"{n} packed leaves into {g1} uint32 partials"),
        "masked_partial_sum": (
            n * 2 * m + g * 2 * m + 8 * g * g,
            (3 * g + 3 * active) * m, (4.5 * g + 5.5 * active + n) * m,
            lambda: ps.masked_partial_sum(y, keys, signs, fanout=fan,
                                          sibling=g),
            lambda: ps.masked_partial_sum_plain(y, keys, signs, fanout=fan,
                                                sibling=g),
            "masked_partial_sum", "src/repro/kernels/partial_sum.py:229",
            "partial_sum.cu",
            f"{n} 16-bit leaf words into {g} masked partials, {active} "
            f"active pairs"),
        "mask_repair": (
            2 * 2 * m + 8 * pairs, (3 + 3 * live_pairs) * m,
            (4.5 + 5.5 * live_pairs) * m,
            lambda: mw.mask_repair(rep, rkeys, rcoeff, out=rep),
            lambda: mw.mask_repair_plain(row0, rkeys, rcoeff),
            "mask_repair", "src/repro/kernels/masked_wire.py:503",
            "masked_wire.cu",
            f"16-bit words, {pairs} pairs, {live_pairs} with a "
            f"coefficient, in place"),
    }
    rows, kernel_ms = [], {}
    for kind, (nbytes, alu, total, kern, plain, name, replaces, src,
               what) in work.items():
        ms, call_ms = _kernel_ms(torch, kern)
        plain_ms = _median_ms(torch, plain)
        kernel_ms[kind] = call_ms
        bytes_ms = nbytes / rate * 1e3
        ops_ms = int_bound_ms(alu, total)
        bound_ms = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        extra = ""
        if kind == "mask_repair":
            # Its other forms, and the floors this timing allows the same
            # row: a read and a write (copy_), a write alone (fill_).
            forms = {
                "out of place": lambda: mw.mask_repair(row0, rkeys, rcoeff),
                "write-only": lambda: mw.mask_repair(None, rkeys, rcoeff,
                                                     out=spare),
                "copy_ floor": lambda: torch.empty_like(row0).copy_(row0),
                "fill_ floor": lambda: spare.fill_(0)}
            floors = {f: _median_ms(torch, fn, queued=True)
                      for f, fn in forms.items()}
            extra = "; on the device " + ", ".join(
                f"{f} {t:.4f} ms" for f, t in floors.items()) + (
                f"; {floors['copy_ floor'] / ms:.1%} of the copy_ floor")
        print(f"time: {name} ({what}) {ms:.4f} ms on the device "
              f"({call_ms:.4f} ms a call from the host; plain {plain_ms:.4f} "
              f"ms); bound {bound_ms:.4f} ms by {by}: {nbytes / 1e6:.1f} MB "
              f"at {rate / 1e12:.2f} TB/s = {bytes_ms:.4f} ms, "
              f"{alu / 1e9:.2f} G ALU-only / {total / 1e9:.2f} G int ops = "
              f"{ops_ms:.4f} ms; {bound_ms / ms:.1%} of bound{extra}",
              flush=True)
        rows.append({
            "name": name, "row": {"partial_sum": 9, "masked_partial_sum": 10,
                                  "mask_repair": 8}[kind],
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[kind],
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None})

    # The masked master at the tree's root: C = g word rows.
    c3_bytes = g * 2 * m + 4 + 8 + 3 * m * 4 + 4 + m * 4
    c3_ms, c3_call = _kernel_ms(torch, lambda: mw.masked_master_update(
        q, k, top, sum_wq, p1, p2, tt, 0.01, smult))
    c3_plain = _median_ms(torch, lambda: mw.masked_master_update_plain(
        q, k, top, sum_wq, p1, p2, tt, 0.01, smult))
    c3_bound = max(c3_bytes / rate * 1e3,
                   int_bound_ms((g + 6) * m, (g + 6) * m))
    print(f"time: masked_master_update 16-bit over C = {g} rows {c3_ms:.4f} "
          f"ms on the device ({c3_call:.4f} ms a call from the host; plain "
          f"{c3_plain:.4f} ms); bound {c3_bound:.4f} ms by bytes: "
          f"{c3_bytes / 1e6:.1f} MB; {c3_bound / c3_ms:.1%} of bound",
          flush=True)

    # The plain tree's interior levels (masks off, uint32, fanout 2: 5
    # partials into 3, then 3 into 2), one round's two launches together,
    # and the one PyTorch call that sums ragged sibling groups of their
    # int32 view: an out-of-place index_add into zeros.
    p5 = ps.partial_sum(packed, wq24, fanout=TREE_FANOUT, word_bits=32)
    p3 = ps.masked_partial_sum(p5, *rd._no_masks(3, dev), fanout=TREE_FANOUT,
                               sibling=TREE_FANOUT, use_masks=False)
    off = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    lib_note = []
    for c_in, words in ((5, p5), (3, p3)):
        gg = -(-c_in // TREE_FANOUT)
        kz, sz = rd._no_masks(gg, dev)
        kw = dict(fanout=TREE_FANOUT, sibling=TREE_FANOUT, use_masks=False)
        want = ps.masked_partial_sum(words, kz, sz, **kw)
        ms, call_ms = _kernel_ms(torch, lambda: ps.masked_partial_sum(
            words, kz, sz, **kw))
        plain_ms = _median_ms(torch, lambda: ps.masked_partial_sum_plain(
            words, kz, sz, **kw))
        zeros = torch.zeros((gg, r, 512), dtype=torch.int32, device=dev)
        idx = torch.arange(c_in, device=dev) // TREE_FANOUT
        flat = words.view(torch.int32)

        def lib_call():
            return torch.index_add(zeros, 0, idx, flat)
        try:
            same = torch.equal(lib_call(), want.view(torch.int32))
            lib_ms = (_median_ms(torch, lib_call, queued=True) if same
                      else None)
            lib_note.append(f"{c_in} into {gg}: index_add "
                            + (f"{lib_ms:.4f} ms" if same else
                               "differs from the kernel's words"))
        except RuntimeError as exc:
            lib_ms = None
            lib_note.append(f"{c_in} into {gg}: index_add does not run "
                            f"({str(exc).splitlines()[0]})")
        nbytes = (c_in + gg) * 4 * m
        print(f"time: masked_partial_sum, masks off, uint32, {c_in} into "
              f"{gg} (fanout {TREE_FANOUT}) {ms:.4f} ms on the device "
              f"({call_ms:.4f} ms a call from the host; plain {plain_ms:.4f} "
              f"ms); bound {nbytes / rate * 1e3:.4f} ms by bytes: "
              f"{nbytes / 1e6:.1f} MB; {lib_note[-1]}", flush=True)
        off["ms"] += ms
        off["plain_ms"] += plain_ms
        off["bound_ms"] += nbytes / rate * 1e3
        off["library_ms"] = (None if lib_ms is None or off["library_ms"] is
                             None else off["library_ms"] + lib_ms)
        del want, zeros
    rows.append({
        "name": "masked_partial_sum (masks off: 5 into 3 and 3 into 2, "
                "one plain tree round's two launches)",
        "row": 10, "route": "cuda", "source": "src/repro_torch/kernels/csrc/"
                                   "partial_sum.cu",
        "replaces": "src/repro/kernels/partial_sum.py:229",
        "launches": launches["masked_partial_sum_off"],
        "max_abs_err": errs["masked_partial_sum_off"], **off,
        "bound_by": "bytes"})
    # The view-sum that sums sibling groups where C is a multiple of the
    # fanout (12 16-bit words into 3), on the words and on a signed view.
    w12 = _rand_words(torch, (12, r, 512), 16, gen, dev)
    kz, sz = rd._no_masks(3, dev)
    k12 = _median_ms(torch, lambda: ps.masked_partial_sum(
        w12, kz, sz, fanout=4, sibling=3, use_masks=False), queued=True)
    want12 = pvm.as_u64(ps.masked_partial_sum(w12, kz, sz, fanout=4,
                                              sibling=3, use_masks=False))
    calls = {"words.view(3, 4, R, 512).sum(1) on the uint16 words":
             lambda: w12.view(3, 4, r, 512).sum(1),
             "the same on their int16 view with dtype=int16":
             lambda: w12.view(torch.int16).view(3, 4, r, 512).sum(
                 1, dtype=torch.int16)}
    lib = []
    for what, call in calls.items():
        try:
            out = call()
            same = torch.equal(pvm.as_u64(out) & 0xFFFF, want12)
            lib.append(f"{what} {_median_ms(torch, call, queued=True):.4f} "
                       f"ms ({out.dtype}"
                       f", the kernel's words mod 2**16: {same})")
        except RuntimeError as exc:
            lib.append(f"{what} does not run ({str(exc).splitlines()[0]})")
    print(f"time: 12 16-bit words into 3, masks off, on the device: kernel "
          f"{k12:.4f} ms; "
          + "; ".join(lib), flush=True)

    # Each tree round's whole wire beside the sum of its kernels.
    plain_tree = rd.WirePath(tree=TreeSpec(TREE_FANOUT))
    p2r = ps.masked_partial_sum(p3, *rd._no_masks(2, dev),
                                fanout=TREE_FANOUT, sibling=2,
                                use_masks=False)
    parts = {
        "uplink": _median_ms(torch, lambda: fw.ternary_pack_stacked(
            q, p1, p2, tt, beta, 0.01)),
        "level 1": _median_ms(torch, lambda: ps.partial_sum(
            packed, wq24, fanout=TREE_FANOUT, word_bits=32)),
        "levels 2-3": sum(_median_ms(torch, lambda: ps.masked_partial_sum(
            x, *rd._no_masks(gg, dev), fanout=TREE_FANOUT,
            sibling=TREE_FANOUT, use_masks=False))
            for x, gg in ((p5, 3), (p3, 2))),
        "root": _median_ms(torch, lambda: mw.masked_master_update(
            q, k, p2r, pvm.to_words(pvm.as_u64(wq24).sum(), 32), p1, p2, tt,
            0.01, 2.0 ** -rd.TREE_PLAIN_FIXPOINT_BITS)),
    }
    wire_ms = _median_ms(torch, lambda: plain_tree.round_from_stacked(
        bufs, k, w, f1, f2, t=tt, betas=beta))
    both = sum(parts.values())
    print(f"time: plain tree round_from_stacked (fanout {TREE_FANOUT}) "
          f"{wire_ms:.4f} ms at t=2 vs its kernels {both:.4f} ms "
          f"(+{wire_ms - both:.4f} ms): "
          + ", ".join(f"{a} {b:.4f}" for a, b in parts.items()), flush=True)
    up_ms = _median_ms(torch, lambda: tree_wire.uplink_masked(
        bufs, f1, f2, t=t1, w=w, betas=beta))
    # The fault path's parts beside the kernels, on the device (queued,
    # L2-scrubbed): the dead leaves' zeroing; on the flat wire the same
    # select written straight into rows 1..N of the master's N + 1 rows,
    # beside the copy of all N rows (torch.cat) it replaced.
    keep = alive_eff[:, None, None] > 0
    operand = torch.empty((n + 1, r, 512), dtype=y.dtype, device=dev)
    zero = rd._signed(y).new_zeros(())
    on_device = {
        "dead-row zeroing": lambda: rd._signed(y).where(keep, 0),
        "the same select into rows 1..N of the flat operand":
            lambda: torch.where(keep, rd._signed(y), zero,
                                out=rd._signed(operand[1:])),
        "the copy of all N rows it replaced (torch.cat)":
            lambda: torch.cat([rd._signed(y[0])[None], rd._signed(y[1:])])}
    part_ms = {a: _median_ms(torch, fn, queued=True)
               for a, fn in on_device.items()}
    parts = {"uplink (with its keys)": up_ms,
             "level 1": kernel_ms["masked_partial_sum"],
             "repair in place": kernel_ms["mask_repair"], "root": c3_call}
    wire_ms = _median_ms(torch, lambda: tree_wire.round_from_stacked(
        bufs, k, w, f1, f2, t=t1, betas=beta, alive=alive))
    both = sum(parts.values())
    print(f"time: masked tree round_from_stacked with repair (fanout {fan}, "
          f"16-bit, round 1 of the plan) {wire_ms:.4f} ms vs its kernels "
          f"{both:.4f} ms (+{wire_ms - both:.4f} ms): "
          + ", ".join(f"{a} {b:.4f}" for a, b in parts.items())
          + f"; inside the rest, on the device: dead-row zeroing "
          f"{part_ms['dead-row zeroing']:.4f} ms; the root's first row is "
          f"repaired in place, no copy", flush=True)
    # The flat masked wire under the same plan: N + 1 rows at the master.
    flat_wire = rd.WirePath(privacy=spec, faults=ft.FaultPlan(**FAULTS))
    f_eff, f_dead = pvr.effective_masks(None, alive, 2, None, n)
    f_pairs = flat_wire._leaf_pairs(n, t1, None, dev)
    fkeys, fcoeff = flat_wire._repair(*f_pairs, f_eff, f_dead)
    fy, fwq = flat_wire.uplink_masked(bufs, f1, f2, t=t1, w=w, betas=beta)
    f_sum = pvm.to_words(pvm.as_u64(fwq).sum(), 32)
    parts = {
        "uplink (with its keys)": _median_ms(
            torch, lambda: flat_wire.uplink_masked(bufs, f1, f2, t=t1, w=w,
                                                   betas=beta)),
        "repair term, write-only": _median_ms(
            torch, lambda: mw.mask_repair(None, fkeys, fcoeff,
                                          out=operand[0])),
        f"master over C = {n + 1} rows": _median_ms(
            torch, lambda: mw.masked_master_update(q, k, operand, f_sum, p1,
                                                   p2, tt, 0.01, smult))}
    wire_ms = _median_ms(torch, lambda: flat_wire.round_from_stacked(
        bufs, k, w, f1, f2, t=t1, betas=beta, alive=alive))
    both = sum(parts.values())
    print(f"time: flat masked round_from_stacked with repair (16-bit, "
          f"round 1 of the plan, {fkeys.shape[0]} pairs, "
          f"{int((fcoeff != 0).sum())} with a coefficient) {wire_ms:.4f} ms "
          f"vs its kernels {both:.4f} ms (+{wire_ms - both:.4f} ms): "
          + ", ".join(f"{a} {b:.4f}" for a, b in parts.items())
          + "; inside the rest, on the device: " + ", ".join(
              f"{a} {b:.4f} ms" for a, b in part_ms.items()
              if a != "dead-row zeroing"), flush=True)
    del operand, fy
    _restore_counts(saved)                         # timing launches not counted
    return rows


def phase_times_unfused(torch, dev, rate: float, launches: dict,
                        errs: dict) -> list[dict]:
    """The one-worker uplinks, the encode, pack, unpack and the unfused
    master, and their plain versions, at the main-path shapes (one worker's
    view of m = ROWS·128 elements; the master over N = 10 workers' codes),
    beside their bounds; the two-call PyTorch composition of #14; and the
    per-worker round's wire (11 launches) against the batched round's (2)."""
    from repro_torch.core.ternary import ternarize, ternarize_round1
    from repro_torch.fed import rounds as rd
    from repro_torch.kernels import fused_wire as fw
    from repro_torch.kernels import master_update as mu
    from repro_torch.kernels import pack2bit as pk
    from repro_torch.kernels import ternary_encode as te
    saved = _read_counts()
    n, r = N_WORKERS, ROWS // 4
    m = r * 512                                    # elements per view
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    q, p1, p2, beta, w, k = _inputs(torch, n, r, gen, dev)
    tt = torch.tensor(2, dtype=torch.int32, device=dev)
    alpha = torch.tensor(0.01, device=dev)
    q0 = q[0]
    f0, f1, f2 = (x.reshape(ROWS, 128) for x in (q0, p1, p2))
    codes = te.ternary_encode(f0, f1, f2, 0.2)
    packed = pk.pack2bit(codes.view(r, 512))
    tern = torch.stack([te.ternary_encode(x.reshape(ROWS, 128), f1, f2, 0.2)
                        for x in q])
    f32 = 4
    csrc = "src/repro_torch/kernels/csrc/"
    none_why = "none: no PyTorch call"
    # kind: (table row, bytes, float ops, int ops, kernel, plain, name,
    # replaces, source, library note). Bytes at t = 2: every input read
    # once (a device scalar too), every output written once.
    work = {
        "uplink_traced": (
            3, 3 * m * f32 + 3 * 4 + m // 4, 4 * m, 0,
            lambda: fw.ternary_pack_any(q0, p1, p2, tt, beta[0], alpha),
            lambda: fw.ternary_pack_any_plain(q0, p1, p2, tt, beta[0], alpha),
            "ternary_pack_any", "src/repro/kernels/fused_wire.py:246",
            "fused_wire.cu", none_why + " ternarizes and packs 2-bit fields"),
        "uplink": (
            4, 3 * m * f32 + m // 4, 4 * m, 0,
            lambda: fw.ternary_pack(q0, p1, p2, 0.2),
            lambda: fw.ternary_pack_plain(q0, p1, p2, 0.2),
            "ternary_pack", "src/repro/kernels/fused_wire.py:205",
            "fused_wire.cu", none_why + " ternarizes and packs 2-bit fields"),
        "uplink_round1": (
            5, 2 * m * f32 + m // 4, m, 0,
            lambda: fw.ternary_pack_round1(q0, p1, 0.01),
            lambda: fw.ternary_pack_round1_plain(q0, p1, 0.01),
            "ternary_pack_round1", "src/repro/kernels/fused_wire.py:228",
            "fused_wire.cu", none_why + " ternarizes and packs 2-bit fields"),
        "encode": (
            11, 3 * m * f32 + m, 4 * m, 0,
            lambda: te.ternary_encode(f0, f1, f2, 0.2),
            lambda: ternarize(f0, f1, f2, 0.2),
            "ternary_encode", "src/repro/kernels/ternary_encode.py:45",
            "ternary_encode.cu", none_why + " computes the Eq. (5) code"),
        "encode_round1": (
            12, 2 * m * f32 + m, m, 0,
            lambda: te.ternary_encode_round1(f0, f1, 0.01),
            lambda: ternarize_round1(f0, f1, 0.01),
            "ternary_encode_round1",
            "src/repro/kernels/ternary_encode.py:63", "ternary_encode.cu",
            none_why + " computes the Eq. (4) code"),
        "pack": (
            13, m + m // 4, 0, 3 * m,
            lambda: pk.pack2bit(codes.view(r, 512)),
            lambda: pk.pack2bit_plain(codes.view(r, 512)),
            "pack2bit", "src/repro/kernels/pack2bit.py:47", "pack2bit.cu",
            none_why + " packs 2-bit fields"),
        "unpack": (
            # Per packed byte: an extract, the three shifts and two
            # three-input logic ops of the spread, an add and an xor.
            13, m // 4 + m, 0, 2 * m,
            lambda: pk.unpack2bit(packed), lambda: pk.unpack2bit_plain(packed),
            "unpack2bit", "src/repro/kernels/pack2bit.py:65", "pack2bit.cu",
            none_why + " unpacks 2-bit fields"),
        "master_update": (
            14, n * m + 3 * m * f32 + n * f32 + m * f32, (2 * n + 2) * m, 0,
            lambda: mu.master_update(f0, tern, w, f1, f2),
            lambda: mu.master_update_plain(f0, tern, w, f1, f2),
            "master_update", "src/repro/kernels/master_update.py:35",
            "master_update.cu", None),
    }
    rows = []
    for kind, (row, nbytes, fops, iops, kern, plain, name, replaces, src,
               lib_note) in work.items():
        ms, call_ms = _kernel_ms(torch, kern)
        plain_ms = _median_ms(torch, plain)
        bytes_ms = nbytes / rate * 1e3
        ops_ms = max(fops / FP32_OPS_PER_S * 1e3, int_bound_ms(iops, iops))
        bound_ms = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        lib_ms = None
        if kind == "unpack":
            # Not the same function, so not the library column: the time
            # of writing the unpack's output alone, timed alike.
            codes_out = torch.empty((r, 512), dtype=torch.int8, device=dev)
            fill_ms = _median_ms(torch, lambda: codes_out.fill_(1),
                                 queued=True)
            lib_note += (f"; a fill_ of its {m / 1e6:.1f} MB of codes alone "
                         f"{fill_ms:.4f} ms on the device")
        if kind == "master_update":
            # The library yardstick: two PyTorch calls (a tensordot over
            # the workers, then addcmul), beside the float conversion and
            # the step they need; the library column takes one call, so
            # it stays empty.
            def lib_call():
                return torch.addcmul(f0, torch.tensordot(w, tern.float(), 1),
                                     f1 - f2, value=-1)
            close = bool(torch.allclose(lib_call(), kern(), rtol=1e-5,
                                        atol=1e-6))
            lib_note = (f"two calls (tensordot + addcmul, with the codes' "
                        f"float conversion and p1 - p2) "
                        f"{_median_ms(torch, lib_call, queued=True):.4f} ms "
                        f"on the device, within rtol 1e-5 of the kernel: "
                        f"{close}")
        print(f"time: {name} {ms:.4f} ms on the device ({call_ms:.4f} ms a "
              f"call from the host; plain {plain_ms:.4f} ms); bound "
              f"{bound_ms:.4f} ms by {by}: {nbytes / 1e6:.1f} MB at "
              f"{rate / 1e12:.2f} TB/s = {bytes_ms:.4f} ms, ops "
              f"{ops_ms:.4f} ms; {bound_ms / ms:.1%} of bound; achieved "
              f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s; library: {lib_note}",
              flush=True)
        rows.append({
            "name": name, "row": row, "route": "cuda", "source": csrc + src,
            "replaces": replaces, "launches": launches.get(kind, 0),
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms})

    # One round's wire a worker at a time (10 uplinks + the master: 11
    # launches) against the batched round's (2), at t = 2.
    wire = rd.WirePath()
    bufs = q.view(n, ROWS, 128)
    b1, b2 = p1.view(ROWS, 128), p2.view(ROWS, 128)
    wp = wire.weights(torch.full((n,), 1.0 / n, device=dev), k, tt)

    def per_worker():
        stacked = torch.stack([wire.uplink(bufs[j], b1, b2, t=2)
                               for j in range(n)])
        return wire.master(bufs, k, stacked, wp, b1, b2, t=tt)

    def per_worker_traced():
        stacked = torch.stack([wire.uplink_traced(bufs[j], b1, b2, t=tt,
                                                  beta=beta[j])
                               for j in range(n)])
        return wire.master(bufs, k, stacked, wp, b1, b2, t=tt)
    def batched():
        return wire.round_from_stacked(bufs, k, wp, b1, b2, t=tt)
    for how, queued in (("a call from the host", False),
                        ("on the device", True)):
        one = _median_ms(torch, per_worker, queued)
        one_t = _median_ms(torch, per_worker_traced, queued)
        both = _median_ms(torch, batched, queued)
        print(f"time: per-worker round wire at t=2 ({n} uplinks + stack + "
              f"master, {n + 1} launches), {how}: {one:.4f} ms, traced "
              f"{one_t:.4f} ms, against the batched round_from_stacked "
              f"(2 launches) {both:.4f} ms: batching saves "
              f"{one - both:.4f} ms ({one / both:.2f}x)", flush=True)
    _restore_counts(saved)
    return rows


# -- distributed slice: the mesh runtime, F·M gloo ranks on one card -------

DIST_MESHES = ((10, 1), (4, 2))   # the paper's ten nodes; a model axis of 2
DIST_ROUNDS = (1, 3)              # both Eq. (3)/(4)/(5) branches
DIST_TIMEOUT = 300                # seconds a mesh's ranks may take
DIST_STRATEGIES = ("fedpc", "fedpc_packed", "fedpc_reduce", "fedavg")
DIST_DP = dict(dp_epsilon=DP_EPSILON)
DIST_M32 = dict(modulus_bits=32, fixpoint_bits=24)
DIST_E2E = ("--fed-workers", "4", "--model-shards", "2", "--rounds", "3")
# The kernels a mesh rank launches: #2 at Nq = 1, #3, #6 at N = 1, #8.
MESH_KINDS = ("master", "uplink_traced", "uplink_masked_16",
              "uplink_masked_32", "mask_repair")


class DistCase(NamedTuple):
    key: str
    strategy: str
    privacy: dict | None          # PrivacySpec keywords; None = plain wire
    fanout: int | None            # the masked tree's
    faults: bool                  # under FaultPlan(**FAULTS)
    shard_wire: bool              # False: every rank runs the whole buffer
    mask: str                     # "het": betas + mask; "none"; "alive"


def _dist_cases(F: int, M: int) -> list:
    """The syncs a mesh runs at each round. Both meshes: every strategy
    with betas and a participation mask, the masked wire at 16 bits with
    DP off and on and at 32 bits. Without a model axis (the paper's ten
    nodes): 32 bits with DP too, and the flat masked wire under the fault
    plan beside the survivors-only sync. With one: masks off (DP off and
    on) and the exact modes on the replicated wire (every rank the whole
    buffer: the (F, 1) computation). Where F is a power of two (the mesh
    tree folds ``fanout`` ranks a level), the masked tree at fanout 2. One
    sync a run audits itself (``enforce``, the default: the (4, 2) mesh's
    16-bit wire); the others skip the audit, which is host work on
    ``meta`` tensors."""
    quiet = {"enforce": False}
    cases = [DistCase(s, s, None, None, False, True, "het")
             for s in DIST_STRATEGIES]
    masked = [("m16", {} if M > 1 else quiet), ("m16_dp", {**DIST_DP, **quiet}),
              ("m32", {**DIST_M32, **quiet})]
    if M == 1:
        masked.append(("m32_dp", {**DIST_M32, **DIST_DP, **quiet}))
    else:
        masked += [("m16_off", {"mask_seed": None, **quiet}),
                   ("m16_dp_off", {"mask_seed": None, **DIST_DP, **quiet})]
    cases += [DistCase(k, "fedpc", kw, None, False, True, "het")
              for k, kw in masked]
    if F & (F - 1) == 0:
        cases.append(DistCase("tree2", "fedpc", quiet, 2, False, True, "het"))
    if M == 1:
        rec = {"recovery_threshold": 2, **quiet}
        cases += [DistCase("faults", "fedpc", rec, None, True, True, "none"),
                  DistCase("survivors", "fedpc", rec, None, False, True,
                           "alive")]
    else:
        cases += [DistCase(s + "_rep", s, None, None, False, False, "het")
                  for s in ("fedpc", "fedpc_packed")]
        cases += [DistCase(k + "_rep", "fedpc", kw, None, False, False,
                           "het")
                  for k, kw in (("m16", quiet), ("m32", {**DIST_M32,
                                                         **quiet}))]
    return cases


def _dist_models(torch, dev, workers, dims: tuple) -> tuple:
    """The mesh phase's models on ``dev``: P^0 (the MLP of ``dims`` =
    (features, classes, hidden widths) drawn from SEED), P^{-1} = P^0 +
    0.01·N(0, 1) and each of ``workers``' local models, P^0 + 0.01·N(0, 1)
    from its own seed."""
    from repro_torch.models.mlp import init_mlp_classifier
    from repro_torch.utils import tree_map
    params = init_mlp_classifier(torch.Generator().manual_seed(SEED), *dims,
                                 device=dev)

    def nudged(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tree_map(lambda x: x + 0.01 * torch.randn(
            x.shape, generator=gen, device=dev), params)
    return params, nudged(SEED + 1), {k: nudged(SEED + 10 + k)
                                      for k in workers}


def _dist_public(torch, dev, F: int) -> dict:
    """The round's public (F,) values: sizes, costs, betas, the
    participation mask (worker 1 sits out) and last round's costs."""
    return {"sizes": torch.linspace(50.0, 200.0, F, device=dev),
            "costs": torch.linspace(0.9, 0.5, F, device=dev),
            "betas": torch.linspace(0.1, 0.35, F, device=dev),
            "mask": (torch.arange(F, device=dev) != 1).float(),
            "prev": torch.ones(F, device=dev)}


def _dist_rank(rank: int, world: int, F: int, M: int, store: str,
               out: str, backend: str, devices: tuple, dims: tuple) -> None:
    """One rank of a mesh (a spawned process on ``devices[rank]``):
    every sync of ``_dist_cases`` at both rounds, each under sync-debug
    "error" but for its staged transport calls; checks what one rank can
    (``_dist_checks``); writes its digests, launches and timings to
    ``out/rank<r>.json``, and on rank 0 of the (10, 1) mesh the packed
    and FedAvg rounds' new buffers, for the single-process comparison."""
    import hashlib
    import torch
    import torch.distributed as dist
    from repro_torch.core import flat as fl
    from repro_torch.core.tree import TreeSpec
    from repro_torch.fed import collectives as col
    from repro_torch.fed.distributed import build_fed_sync
    from repro_torch.fed.faults import FaultPlan
    from repro_torch.kernels import fused_wire, masked_wire
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.privacy import recovery as pvr
    from repro_torch.privacy.spec import PrivacySpec
    from repro_torch.utils import tree_leaves, tree_map
    dev = torch.device(devices[rank])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="file://" + store,
                            world_size=world, rank=rank)
    try:
        mesh = make_debug_mesh(F, M)
        f = mesh.axes["data"].index
        params, prev, locs = _dist_models(torch, dev, [f], dims)
        local = locs.pop(f)
        pub = _dist_public(torch, dev, F)
        layout = fl.layout_of(params)
        zeros = tree_map(torch.zeros_like, params)
        mult = {1: 0.01, 3: float(max((a - b).abs().max() for a, b in zip(
            tree_leaves(params), tree_leaves(prev))))}
        cases = _dist_cases(F, M)
        syncs = {}
        for c in cases:
            kw = {}
            if c.privacy is not None:
                kw["privacy"] = PrivacySpec(**c.privacy)
            if c.fanout:
                kw["tree"] = TreeSpec(fanout=c.fanout)
            if c.faults:
                kw["faults"] = FaultPlan(**FAULTS)
            if c.mask == "het":
                kw["betas"] = pub["betas"]
            syncs[c.key] = build_fed_sync(None, mesh, "data", c.strategy,
                                          shard_wire=c.shard_wire,
                                          device=dev, **kw)

        def state_at(t):
            return {"params": params,
                    "params_prev": prev if t > 1 else zeros,
                    "prev_costs": (pub["prev"] if t > 1 else
                                   torch.full((F,), float("inf"),
                                              device=dev)),
                    "round": torch.tensor(t, dtype=torch.int32, device=dev)}

        def masks_at(state):
            alive = FaultPlan(**FAULTS).alive(state["round"], F)
            eff, dead = pvr.effective_masks(None, alive, 2, None, F)
            return {"het": pub["mask"], "none": None, "alive": eff}, dead

        if backend == "nccl":
            # NCCL makes a group's communicator, and each send/recv pair's,
            # at its first call: make them before the checked rounds
            state = state_at(DIST_ROUNDS[0])
            masks, _ = masks_at(state)
            for c in cases:
                syncs[c.key](local, pub["costs"], pub["sizes"], state,
                             masks[c.mask])
        report = {"digests": {}, "rounds": {}, "repaired": 0}
        counters = (fused_wire.LAUNCHES, masked_wire.LAUNCHES)
        for t in DIST_ROUNDS:
            state = state_at(t)
            masks, dead = masks_at(state)
            if "faults" in syncs:
                report["repaired"] += int(dead.sum())
            got = {}
            for c in cases:
                before = [dict(cnt) for cnt in counters]
                col.reset_stats()
                if cuda:
                    torch.cuda.synchronize()
                # the ranks start each sync together: a rank's host work
                # after the last one (its digest) stays out of the timing
                dist.barrier()
                t0 = time.perf_counter()
                if cuda:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    new, aux = syncs[c.key](local, pub["costs"],
                                            pub["sizes"], state,
                                            masks[c.mask])
                finally:
                    if cuda:
                        torch.cuda.set_sync_debug_mode(0)
                if cuda:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launched = {k: v - b[k] for cnt, b in zip(counters, before)
                            for k, v in cnt.items() if v != b[k]}
                flat = fl.flatten_tree(new, layout)
                check(bool(torch.isfinite(flat).all()),
                      f"mesh {F}x{M} {c.key} t={t}: not finite")
                got[c.key] = flat
                report["digests"][f"{c.key}_t{t}"] = hashlib.blake2b(
                    flat.cpu().numpy().tobytes(), digest_size=16).hexdigest()
                report["rounds"][f"{c.key}_t{t}"] = {
                    "wall_s": wall, "k_star": int(aux["k_star"]),
                    "launches": launched, **col.STATS}
            _dist_checks(torch, got, pub, F, M, t, mult[t])
            if (F, M) == DIST_MESHES[0] and rank == 0:
                for key in ("fedpc_packed", "fedavg"):
                    torch.save(got[key].cpu(), f"{out}/{key}_t{t}.pt")
            del got
        with open(f"{out}/rank{rank}.json", "w") as fh:
            json.dump(report, fh)
    finally:
        dist.destroy_process_group()


def _dist_checks(torch, got: dict, pub: dict, F: int, M: int, t: int,
                 mult: float) -> None:
    """What one rank checks of one round: bitwise where the wire is
    exact, ``fedpc_reduce`` within its f16 bound of the int8 gather."""
    def same(a, b, what):
        if a in got and b in got:
            check(torch.equal(got[a].view(torch.int32),
                              got[b].view(torch.int32)),
                  f"mesh {F}x{M} t={t}: {what}: {a} != {b}")

    same("m16", "m16_off", "masks on != masks off")
    same("m16_dp", "m16_dp_off", "masks on != masks off with DP")
    check(not torch.equal(got["m16"], got["m16_dp"]),
          f"mesh {F}x{M} t={t}: DP changed nothing")
    same("faults", "survivors", "repaired != survivors-only")
    same("tree2", "m16", "the masked tree != the flat masked wire")
    for key in ("fedpc", "fedpc_packed", "m16", "m32"):
        same(key, key + "_rep", "sharded != replicated")
    # fedpc_reduce beside the int8 gather's exact f32 fold: F f16 terms
    # and F - 1 f16 sums, each off by at most 2^-11 of what it rounds
    p = pub["sizes"] / pub["sizes"].sum()
    wsum = float((p * (pub["betas"] if t > 1 else 1.0)).abs().sum())
    diff = (got["fedpc_reduce"] - got["fedpc"]).abs()
    bound = (F + 1) * 2.0 ** -11 * wsum * mult + 2 * _ulp(torch,
                                                          got["fedpc"])
    check(bool((diff <= bound).all()),
          f"mesh {F}x{M} t={t}: reduce off gather by {float(diff.max())}")


def _ulp(torch, x):
    """The spacing of float32 at each entry of ``x``."""
    return torch.nextafter(x.abs(), torch.full_like(x, float("inf"))) \
        - x.abs()


def _dist_dims() -> tuple:
    return (N_FEATURES, N_CLASSES, HIDDEN)


def _dist_run(F: int, M: int, out: str, backend: str,
              devices: tuple) -> list:
    """Spawn a mesh's F·M ranks, rank r on ``devices[r]``, under
    ``backend`` and wait for them, at most DIST_TIMEOUT seconds (then
    every rank is stopped); returns each rank's report."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    ctx = mp.start_processes(_dist_rank, args=(F * M, F, M,
                                               f"{out}/rendezvous", out,
                                               backend, devices,
                                               _dist_dims()),
                             nprocs=F * M, join=False, start_method="spawn")
    deadline = time.perf_counter() + DIST_TIMEOUT
    try:
        while not ctx.join(timeout=1):
            check(time.perf_counter() < deadline,
                  f"mesh {F}x{M}: ranks still running after {DIST_TIMEOUT} s")
    except ProcessException as exc:
        raise SmokeError(f"mesh {F}x{M}: a rank failed:\n{exc}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    reports = []
    for r in range(F * M):
        with open(f"{out}/rank{r}.json") as fh:
            reports.append(json.load(fh))
    return reports


def _dist_report(F: int, M: int, reports: list, label: str) -> tuple:
    """Check that every rank's new models equal rank 0's, and sum the
    ranks' launches: those of the sharded wire by the kind of the mesh's
    kernel row (#6 split by word width), those of the replicated wire
    (every rank the whole buffer: another shape) apart. Returns them and
    a line a sync, and the seconds the syncs took (the median rank's,
    summed)."""
    first = reports[0]
    for r, rep in enumerate(reports):
        check(rep["digests"] == first["digests"],
              f"{label}: rank {r}'s new models differ from rank 0's")
    cases = {c.key: c for c in _dist_cases(F, M)}
    sharded: dict = {}
    whole: dict = {}
    for rep in reports:
        for key, rr in rep["rounds"].items():
            c = cases[key.rsplit("_t", 1)[0]]
            into = sharded if c.shard_wire else whole
            for kind, n in rr["launches"].items():
                if kind == "uplink_masked":
                    kind += f"_{(c.privacy or {}).get('modulus_bits', 16)}"
                into[kind] = into.get(kind, 0) + n
    by_key: dict = {}
    for key in first["rounds"]:
        walls = [rep["rounds"][key]["wall_s"] for rep in reports]
        comm = [rep["rounds"][key]["seconds"] for rep in reports]
        by_key.setdefault(key.rsplit("_t", 1)[0], []).append((
            statistics.median(walls), statistics.median(comm),
            first["rounds"][key]))
    lines = []
    for base, runs in by_key.items():
        one = runs[0][2]
        lines.append(
            f"{label} {base}: round "
            f"{' / '.join(f'{r[0] * 1e3:.1f}' for r in runs)} ms at t = "
            f"{' / '.join(map(str, DIST_ROUNDS))} (the median over the "
            f"ranks; the first call of a sync audits itself where it "
            f"enforces), transport "
            f"{' / '.join(f'{r[1] * 1e3:.1f}' for r in runs)} ms "
            f"({one['calls']} calls, {one['staged']} staged through host "
            f"memory = host syncs; protocol {one['protocol_bytes']:,} B, "
            f"link {one['link_bytes']:,} B a rank); launches "
            f"{one['launches'] or 'none'}; pilots "
            f"{[r[2]['k_star'] for r in runs]}")
    return sharded, whole, lines, sum(r[0] for runs in by_key.values()
                                      for r in runs)


def _dist_single(torch, dev, F: int) -> dict:
    """The (F, 1) mesh's rounds computed in one process on the F locals:
    the packed round by ``WirePath.round_from_stacked`` (#1 + #2), and
    FedAvg's weighted sum in worker order with its f32 bound, 2(F − 1)
    units of 2^-24 of Σ_k |w_k x_k| (two summation orders) and an ulp."""
    from repro_torch.core import flat as fl
    from repro_torch.core.goodness import select_pilot
    from repro_torch.fed import rounds as rd
    params, prev, locs = _dist_models(torch, dev, range(F), _dist_dims())
    pub = _dist_public(torch, dev, F)
    layout = fl.layout_of(params)
    bufs = torch.stack([fl.flatten_tree(locs[k], layout) for k in range(F)])
    del locs
    p1 = fl.flatten_tree(params, layout)
    wire = rd.WirePath()
    wm = pub["sizes"] * pub["mask"]
    wts = wm / wm.sum()
    avg = torch.zeros_like(p1)
    terms = torch.zeros_like(p1)
    for k in range(F):
        avg = avg + bufs[k] * wts[k]
        terms = terms + (bufs[k] * wts[k]).abs()
    out = {"fedavg": (avg, 2 * (F - 1) * 2.0 ** -24 * terms
                      + _ulp(torch, avg))}
    for t in DIST_ROUNDS:
        tt = torch.tensor(t, dtype=torch.int32, device=dev)
        p2 = fl.flatten_tree(prev, layout) if t > 1 else torch.zeros_like(p1)
        prev_costs = (pub["prev"] if t > 1
                      else torch.full((F,), float("inf"), device=dev))
        k, _ = select_pilot(pub["costs"], prev_costs, pub["sizes"], tt,
                            pub["mask"])
        w = wire.weights(pub["sizes"] / pub["sizes"].sum(), k, tt,
                         betas=pub["betas"], mask=pub["mask"])
        out[t], _ = wire.round_from_stacked(bufs, k, w, p1, p2, t=tt,
                                            betas=pub["betas"])
    return out


def phase_distributed_slice(torch, dev) -> dict:
    """The mesh runtime (``fed.distributed``) at full width: the (10, 1)
    and (4, 2) meshes of gloo ranks on this card, every case of
    ``_dist_cases`` at rounds 1 and 3; the (10, 1) packed round against
    the single-process round on the same ten locals, bitwise; then
    ``launch/train.py distributed`` (fedpc-paper at its registered size,
    F = 4, M = 2, 3 rounds) and ``simulate`` (3 rounds). Returns the
    ranks' launches on their slabs by mesh and kernel row
    (``_dist_report``)."""
    import tempfile
    import numpy as np
    t_phase = time.perf_counter()
    launches: dict = {}
    lines = []
    with tempfile.TemporaryDirectory(prefix="mesh") as tmp:
        for F, M in DIST_MESHES:
            out = f"{tmp}/{F}x{M}"
            Path(out).mkdir()
            t0 = time.perf_counter()
            reports = _dist_run(F, M, out, "gloo", (str(dev),) * (F * M))
            spawn_s = time.perf_counter() - t0
            first = reports[0]
            mine, whole, more, sync_s = _dist_report(
                F, M, reports, f"distributed: {F}x{M}")
            launches[(F, M)] = mine
            lines += more
            check(first["repaired"] > 0 or M > 1, f"mesh {F}x{M}: the "
                  f"fault plan killed no worker")
            print(f"distributed: mesh {F}x{M}: {F * M} gloo ranks on "
                  f"{torch.cuda.get_device_name(0)}, {len(more)} syncs x "
                  f"{len(DIST_ROUNDS)} rounds in {spawn_s:.1f} s, the "
                  f"syncs {sync_s:.1f} s of it (the rest spawning the ranks "
                  f"and building their models and syncs); every rank's new "
                  f"models equal; "
                  f"{first['repaired']} faulted workers repaired; the "
                  f"ranks launched {mine} on their slabs"
                  + (f", and {whole} on the replicated wire (every rank "
                     f"the whole buffer: the (4, 1) shapes, not in this "
                     f"mesh's kernel rows)" if whole else ""), flush=True)
            if (F, M) == DIST_MESHES[0]:
                single = _dist_single(torch, dev, F)
                avg, bound = single.pop("fedavg")
                worst = 0.0
                for t in DIST_ROUNDS:
                    mesh = torch.load(f"{out}/fedpc_packed_t{t}.pt").to(dev)
                    want = single[t].reshape(mesh.shape)
                    differ = mesh.view(torch.int32) != want.view(torch.int32)
                    zeros = differ & (mesh == 0) & (want == 0)
                    check(not bool(differ.any()),
                          f"(10, 1) packed t={t}: {int(differ.sum())} "
                          f"entries differ from the single-process round "
                          f"({int(zeros.sum())} of them signed zeros)")
                    mesh = torch.load(f"{out}/fedavg_t{t}.pt").to(dev)
                    diff = (mesh - avg.reshape(mesh.shape)).abs()
                    check(bool((diff <= bound.reshape(mesh.shape)).all()),
                          f"(10, 1) fedavg t={t} off the single-process sum "
                          f"by {float(diff.max())}")
                    worst = max(worst, float(diff.max()))
                del single, mesh, want, avg, bound
                print(f"distributed: (10, 1) fedpc_packed == single-process "
                      f"round_from_stacked on the same ten locals, bitwise, "
                      f"rounds {DIST_ROUNDS}; fedavg within its f32 bound of "
                      f"the sum in worker order (largest difference "
                      f"{worst:.3g})", flush=True)
            _release(torch)
    for line in lines:
        print(line, flush=True)
    # Both CLI modes at once, as two subprocesses.
    env = dict(os.environ, PYTHONPATH=str(SRC))
    on = ("--device", dev.type)
    t0 = time.perf_counter()
    procs = {mode: (args, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", mode, *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for mode, args in (("distributed", ("--backend", "gloo",
                                            "--full-size", *DIST_E2E, *on)),
                           ("simulate", ("--rounds", "3", *on)))}
    try:
        for mode, (args, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=DIST_TIMEOUT)
            check(proc.returncode == 0, f"launch.train {mode} failed:\n"
                  f"{stderr[-3000:]}")
            costs = [float(c) for c in re.findall(r"cost[= ](\d+\.\d+)",
                                                  stdout)]
            check(costs and all(np.isfinite(costs)),
                  f"launch.train {mode}: no finite cost in {stdout!r}")
            print(f"distributed: launch.train {mode} {' '.join(args)} done "
                  f"{time.perf_counter() - t0:.1f} s after both started: "
                  + "; ".join(stdout.strip().splitlines()), flush=True)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"distributed: phase in {time.perf_counter() - t_phase:.1f} s on "
          f"{_smi()}; the ranks launched {launches}", flush=True)
    return launches


def phase_times_dist(torch, dev, rate: float, launches: dict) -> list[dict]:
    """The kernels a mesh rank launches, at each mesh's slab: #3 (one
    worker's uplink at a device round), #2 with the pilot's buffer apart
    (Nq = 1) beside the F gathered packed slabs, #6 at N = 1 with the
    rank's (1, F) key and sign row (the row-fold kernel) at 16 and 32
    bits with RR, and #8 on the reduced 16-bit slab with the fault plan's
    repair pairs. Each is held bitwise to its plain version, then timed
    beside its bound. ``launches`` maps a mesh to its ranks' launches."""
    from repro_torch.core import flat as fl
    from repro_torch.fed.faults import FaultPlan
    from repro_torch.kernels import fused_wire as fw
    from repro_torch.kernels import masked_wire as mw
    from repro_torch.models.mlp import init_mlp_classifier
    from repro_torch.privacy import dp as pdp
    from repro_torch.privacy import masking as pvm
    from repro_torch.privacy import recovery as pvr
    from repro_torch.privacy.spec import PrivacySpec
    params = init_mlp_classifier(torch.Generator().manual_seed(SEED),
                                 N_FEATURES, N_CLASSES, HIDDEN, device="meta")
    saved = _read_counts()
    rows = []
    f32 = 4
    for F, M in DIST_MESHES:
        sr = fl.layout_of(params, shards=M).shard_rows
        r, m = sr // 4, sr // 4 * 512
        gen = torch.Generator(device=dev).manual_seed(SEED + 20 + F)
        q, p1, p2, beta, _, _ = _inputs(torch, 1, r, gen, dev)
        q = q[0]
        tt = torch.tensor(3, dtype=torch.int32, device=dev)
        a1 = torch.tensor(0.01, device=dev)
        b0 = beta[0].contiguous()
        packed = torch.randint(0, 256, (F, r, 128), generator=gen,
                               device=dev, dtype=torch.uint8)
        w = torch.rand((F,), generator=gen, device=dev) / F
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        pilot = q[None]
        idx, m_idx = F - 2, M - 1
        keys = pvm.pair_stream_keys_row(0, idx, F, tt, m_idx)[None]
        signs = pvm.pair_signs_row(idx, F, device=dev)[None]
        rrk = pdp.rr_stream_key(1, tt, idx, m_idx).reshape(1)
        active = int((signs != 0).sum())
        plan = FaultPlan(**FAULTS)
        for t_rep in DIST_ROUNDS:
            trep = torch.tensor(t_rep, dtype=torch.int32, device=dev)
            eff, dead = pvr.effective_masks(None, plan.alive(trep, F), 2,
                                            None, F)
            if int(dead.sum()):
                break
        rkeys, rcoeff = pvr.repair_coefficients(
            pvm.pair_stream_keys(0, F, trep, m_idx),
            pvm.pair_signs(F, device=dev), eff, dead,
            *pvr.repair_pair_index(F, None, dev))
        live = int((rcoeff != 0).sum())
        pairs = rkeys.shape[0]
        words = pvm.to_words(torch.randint(0, 1 << 16, (r, 512),
                                           generator=gen, device=dev), 16)
        spec16 = PrivacySpec(dp_epsilon=DP_EPSILON, enforce=False)
        spec32 = PrivacySpec(dp_epsilon=DP_EPSILON, enforce=False,
                             **DIST_M32)
        small = 4 * f32
        work = [
            ("uplink_traced", 3, "ternary_pack_any",
             "src/repro/kernels/fused_wire.py:246", "fused_wire.cu",
             f"one rank's slab, R = {r:,}",
             3 * m * f32 + m // 4 + 3 * f32, ("f32", 4 * m),
             lambda: fw.ternary_pack_any(q, p1, p2, tt, b0, a1),
             lambda: fw.ternary_pack_any_plain(q, p1, p2, tt, b0, a1)),
            ("master", 2, "packed_master_update",
             "src/repro/kernels/fused_wire.py:335", "fused_wire.cu",
             f"the pilot apart (Nq = 1) beside {F} gathered slabs, "
             f"R = {r:,}",
             3 * m * f32 + F * m // 4 + F * f32 + f32 + 8 + m * f32,
             ("f32", 3 * F * m + 3 * m),
             lambda: fw.packed_master_update(pilot, zero, packed, w, p1, p2,
                                             tt, 0.01),
             lambda: fw.packed_master_update_plain(pilot, zero, packed, w, p1,
                                                   p2, tt, 0.01))]
        for bits, spec in ((16, spec16), (32, spec32)):
            kw = dict(rr_threshold=spec.rr_threshold, word_bits=bits)
            wq = pvm.quantize_weights(w[idx:idx + 1], spec.fixpoint_bits)
            args = (q[None], p1, p2, tt, b0.reshape(1), 0.01, wq, keys,
                    signs, rrk)
            work.append((
                f"uplink_masked_{bits}", 6, "ternary_pack_masked",
                "src/repro/kernels/masked_wire.py:299", "masked_wire.cu",
                f"one rank, N = 1, L = {F} ({active} active), {bits}-bit, RR",
                3 * m * f32 + m * bits // 8 + 8 * F + small,
                ("int", *uplink_masked_int_ops(1, m, bits, True, True, active,
                                               folds=1)),
                lambda args=args, kw=kw: mw.ternary_pack_masked(*args, **kw),
                lambda args=args, kw=kw: mw.ternary_pack_masked_plain(
                    *args, **kw)))
        if M == 1:                      # the mesh that runs the fault plan
            work.append((
                "mask_repair", 8, "mask_repair",
                "src/repro/kernels/masked_wire.py:503", "masked_wire.cu",
                f"the reduced 16-bit slab, {pairs} pairs, {live} with a "
                f"coefficient (round {t_rep}), out of place",
                2 * 2 * m + 8 * pairs,
                ("int", (3 + 3 * live) * m, (4.5 + 5.5 * live) * m),
                lambda: mw.mask_repair(words, rkeys, rcoeff),
                lambda: mw.mask_repair_plain(words, rkeys, rcoeff)))
        for (kind, row, name, replaces, src, what, nbytes, ops, kern,
             plain) in work:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if got.dtype.is_floating_point:
                same = torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
                err = float((got - want).abs().max())
            else:
                same = torch.equal(pvm.as_u64(got), pvm.as_u64(want))
                err = float((pvm.as_u64(got) - pvm.as_u64(want)).abs().max())
            check(same, f"mesh {F}x{M}: {name} ({what}) differs from its "
                  f"plain version")
            del got, want
            ms, call_ms = _kernel_ms(torch, kern)
            plain_ms = _median_ms(torch, plain)
            bytes_ms = nbytes / rate * 1e3
            ops_ms = (ops[1] / FP32_OPS_PER_S * 1e3 if ops[0] == "f32"
                      else int_bound_ms(ops[1], ops[2]))
            bound_ms = max(bytes_ms, ops_ms)
            by = "bytes" if bytes_ms >= ops_ms else "operations"
            print(f"time: {name} ({what}; mesh {F}x{M}) {ms:.4f} ms on the "
                  f"device ({call_ms:.4f} ms a call from the host; plain "
                  f"{plain_ms:.4f} ms); bound {bound_ms:.4f} ms by {by}: "
                  f"{nbytes / 1e6:.1f} MB = {bytes_ms:.4f} ms, ops "
                  f"{ops_ms:.4f} ms; {bound_ms / ms:.1%} of bound; bitwise "
                  f"to plain", flush=True)
            rows.append({
                "name": f"{name} (mesh {F}x{M}: {what})", "row": row,
                "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": replaces,
                "launches": launches[(F, M)].get(kind, 0),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
        del q, p1, p2, packed, words
        _release(torch)
    _restore_counts(saved)                         # timing launches not counted
    return rows


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("FAIL: run from the root of the repository (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    start = time.perf_counter()
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
        errs.update(phase_check_tree(torch, dev))
        errs["master_masked"] = max(errs["master_masked"],
                                    errs["master_masked_tree"])
        errs.update(phase_check_unfused(torch, dev))
        captured: list = []
        launches = phase_slice(torch, dev, captured)
        worker_rounds = phase_worker_rounds(torch, dev, captured)
        del captured
        scan = phase_scan_slice(torch, dev)
        baselines = phase_baselines_slice(torch, dev, rate)
        launches.update(phase_masked_slice(torch, dev))
        for kind, n in (*scan.items(), *baselines.items()):
            launches[kind] += n
        phase_masked_wire(torch, dev)
        tree = phase_tree_slice(torch, dev)
        masked_tree = phase_masked_tree_slice(torch, dev)
        phase_tree_wire(torch, dev)
        telemetry = phase_telemetry_slice(torch, dev)
        privacy = phase_privacy_slice(torch, dev)
        for kind in ("uplink_masked", "master_masked"):
            launches[kind] += telemetry[kind] + privacy[kind]
        phase_model_serving(torch, dev, rate)
        for kind, n in phase_fed_lm(torch, dev).items():
            launches[kind] += n
        phase_model_serving(torch, dev, rate, MOE_ARCH)
        phase_model_serving(torch, dev, rate, XLSTM_ARCH)
        phase_mamba_mixer(torch, dev, rate)
        for kind, n in phase_fed_lm(torch, dev, MOE_ARCH).items():
            launches[kind] += n
        mesh = phase_distributed_slice(torch, dev)
        for (F, M), mine in mesh.items():     # the fault plan runs at M = 1
            check(set(mine) <= set(MESH_KINDS) and all(
                mine.get(k) for k in MESH_KINDS[:5 if M == 1 else 4]),
                f"mesh {F}x{M}: the ranks launched {mine}, each of "
                f"{MESH_KINDS} expected")
        rows = phase_times(torch, dev, rate, launches, errs)
        rows += phase_times_masked(torch, dev, rate, launches, errs)
        rows += phase_times_tree(torch, dev, rate, {
            "partial_sum": tree["partial_sum"],
            "masked_partial_sum": masked_tree["masked_partial_sum"]
            + telemetry["masked_partial_sum"]
            + privacy["masked_partial_sum"],
            "mask_repair": masked_tree["mask_repair"]
            + telemetry["mask_repair"] + privacy["mask_repair"],
            "masked_partial_sum_off": tree["masked_partial_sum"]}, errs)
        rows += phase_times_unfused(torch, dev, rate, worker_rounds, errs)
        rows += phase_times_dist(torch, dev, rate, mesh)
        rows.sort(key=lambda row: row["row"])
        print(f"time: queued timings behind a sleep of "
              f"{_queue['cycles'] * _queue['ms_per_cycle']:.2f} ms "
              f"({_queue['cycles']} cycles); the host queued "
              f"{QUEUED} calls in at most {_queue['host_share']:.1%} of it",
              flush=True)
        print(f"chip_smoke: every phase passed in "
              f"{time.perf_counter() - start:.1f} s on {_smi()}", flush=True)
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
