"""Quickstart on PyTorch: the FedPC protocol, the twin of quickstart.py.

Three hospitals jointly train a classifier without any of them revealing
weights or gradients — only the pilot-of-the-round uploads a model; everyone
else uploads 2-bit evolution codes (Eqs. 1, 3, 4, 5 of the paper). The wire
runs through the port's CUDA kernels on the card; ``--device cpu`` runs
their plain PyTorch versions instead.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.data.pipeline import federated_loaders
from repro_torch.data.synthetic import SyntheticClassification, \
    random_share_split
from repro_torch.fed.simulator import FedSimulator
from repro_torch.fed.worker import Worker, make_worker_configs
from repro_torch.models.mlp import init_mlp_classifier, mlp_accuracy, \
    mlp_loss_and_grad


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    device = ap.parse_args().device

    # --- private data: three silos of different size ----------------------
    x, y = SyntheticClassification(n_samples=1800, n_features=24,
                                   n_classes=6, seed=0).generate()
    xtr, ytr, xte, yte = x[:1500], y[:1500], x[1500:], y[1500:]
    splits = random_share_split(ytr, n_workers=3, seed=1)
    print("silo sizes:", [len(s) for s in splits])

    # --- workers with PRIVATE hyper-parameters (batch size, lr decay, ...) -
    loaders = federated_loaders((xtr, ytr), splits, seed=2)
    cfgs = make_worker_configs(3, [len(s) for s in splits], seed=3)
    workers = [Worker(cfg=cfgs[k], loader=loaders[k],
                      loss_and_grad=mlp_loss_and_grad) for k in range(3)]

    # --- federated training ----------------------------------------------
    params = init_mlp_classifier(torch.Generator().manual_seed(0), 24, 6,
                                 device=device)
    sim = FedSimulator(workers, params,
                       eval_fn=lambda p: mlp_accuracy(p, xte, yte),
                       device=device)
    res = sim.run_fedpc(rounds=15, eval_every=5)

    print("\nround costs:", [f"{c:.3f}" for c in res.costs])
    print("pilot per round:", res.pilot_history)
    print("eval accuracy:", [(t, f"{a:.3f}") for t, a in res.eval_history])
    print(f"bytes/round: {res.bytes_per_round[0]/1e3:.1f} KB "
          f"(FedAvg would be {2 * 3 * res.bytes_per_round[0] / (3 + 1 + 2/16) / 1e3:.1f} KB)")
    print("\nuplink kinds seen by the master:",
          sorted({k for (_, _, k, _) in sim.ledger.events}))


if __name__ == "__main__":
    main()
