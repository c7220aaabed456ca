"""Telemetry smoke: a tiny traced federation, end to end.

``python -m repro_torch.telemetry.smoke [--device cpu] [--out PATH]`` runs
the JAX package's smoke federation (4 workers, 3 rounds, the masked
16-bit wire through a fanout-2 tree under dropout faults with seed-share
recovery) through the scan driver, writes its telemetry as a JSONL trace,
reads it back (``summarize`` derives every round's bytes again through the
``core.protocol`` models) and prints the ``byte cross-check OK`` line.
It runs on CUDA unless ``--device`` says otherwise; any schema or byte
divergence exits non-zero.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core.fedpc import FedPCConfig
from repro_torch.core.tree import TreeSpec
from repro_torch.data.pipeline import federated_loaders
from repro_torch.data.synthetic import SyntheticClassification
from repro_torch.fed.faults import FaultPlan
from repro_torch.fed.simulator import FedSimulator
from repro_torch.fed.worker import Worker, make_worker_configs
from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_and_grad
from repro_torch.privacy.spec import PrivacySpec
from repro_torch.telemetry import trace as tmt

N = 4
PER = 64                 # samples per worker; the 32-batch menu divides it


def make_sim(seed: int = 0, device=None) -> FedSimulator:
    """The smoke federation: masked 16-bit wire, fanout-2 tree, dropout
    faults and seed-share recovery all on at once."""
    task = SyntheticClassification(n_samples=N * PER, n_features=16,
                                   n_classes=5, seed=0)
    x, y = task.generate()
    splits = [np.arange(k * PER, (k + 1) * PER) for k in range(N)]
    loaders = federated_loaders((x, y), splits, seed=seed,
                                batch_menu=(32,))
    cfgs = make_worker_configs(N, [PER] * N, seed=seed, batch_menu=(32,))
    workers = [Worker(cfg=cfgs[k], loader=loaders[k],
                      loss_and_grad=mlp_loss_and_grad) for k in range(N)]
    params = init_mlp_classifier(torch.Generator().manual_seed(0), 16, 5,
                                 hidden=(32,), device=device)
    cfg = FedPCConfig(
        n_workers=N,
        privacy=PrivacySpec(mask_seed=5, modulus_bits=16,
                            recovery_threshold=2),
        tree=TreeSpec(fanout=2),
        faults=FaultPlan(seed=5, drop_before_uplink=0.1,
                         drop_after_uplink=0.15, straggler=0.05))
    return FedSimulator(workers, params, fed_cfg=cfg, device=device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Traced-federation smoke.")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "fed_trace.jsonl"),
                    help="trace output path")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    res = make_sim(device=args.device).run_fedpc_scan(rounds=args.rounds)
    if res.telemetry is None:
        raise RuntimeError("the scan driver produced no telemetry")
    n_events = res.telemetry.write(args.out)
    # Read back from disk: summarize() derives each round's bytes again
    # from its counts and raises TelemetryMismatch on a divergence.
    summary = tmt.summarize(tmt.read_trace(args.out))
    if (summary.bytes_per_round != res.telemetry.bytes_per_round
            or summary.recovery_bytes_per_round
            != res.telemetry.recovery_bytes_per_round):
        raise tmt.TelemetryMismatch("the trace read back differs in bytes")
    print(f"telemetry smoke: {n_events} events -> {args.out}")
    print(summary.crosscheck_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
