"""End-to-end driver on PyTorch: federated training of a transformer LM
with FedPC; the twin of federated_llm_training.py.

Trains a reduced-config model from the model zoo (default: the qwen3-14b
family, ~1.4M params at reduced size) across N simulated workers on
synthetic LM data, comparing FedPC and FedAvg cost and bytes. The wire
runs through the port's CUDA kernels on the card; ``--device cpu`` runs
their plain PyTorch versions instead.

Run:  PYTHONPATH=src python examples/federated_llm_training_torch.py \
          --arch qwen3-14b --workers 4 --rounds 30 [--device cpu]
"""
import argparse

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.synthetic import SyntheticLM, sequence_split
from repro_torch.fed.simulator import FedSimulator
from repro_torch.fed.worker import Worker, make_worker_configs
from repro_torch.models import build_model


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--sequences", type=int, default=256)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full (not reduced) config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    m = build_model(cfg)
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"vocab={cfg.vocab}")

    toks = SyntheticLM(n_sequences=args.sequences, seq_len=args.seq_len,
                       vocab=cfg.vocab, seed=0).generate()
    splits = sequence_split(len(toks), args.workers, seed=1)
    cfgs = make_worker_configs(args.workers, [len(s) for s in splits],
                               seed=2, batch_menu=(16, 8))

    def workers():
        return [Worker(cfg=cfgs[k],
                       loader=BatchIterator((toks[splits[k]],),
                                            cfgs[k].batch_size, seed=k),
                       loss_and_grad=m.loss_and_grad)
                for k in range(args.workers)]

    fleet = workers()
    params = m.init(torch.Generator().manual_seed(0), device=args.device)
    res = FedSimulator(fleet, params, device=args.device).run_fedpc(
        rounds=args.rounds)

    print(f"cost: {res.costs[0]:.4f} -> {res.costs[-1]:.4f} over "
          f"{args.rounds} rounds")
    print(f"total bytes (FedPC): {res.total_bytes/1e6:.1f} MB")
    print(f"total local train steps across workers: "
          f"{sum(w.step for w in fleet)}")

    # baseline comparison on fresh workers
    res_avg = FedSimulator(workers(), params, device=args.device).run_fedavg(
        rounds=args.rounds)
    print(f"FedAvg cost: {res_avg.costs[0]:.4f} -> {res_avg.costs[-1]:.4f}; "
          f"bytes {res_avg.total_bytes/1e6:.1f} MB "
          f"({100*(1 - res.total_bytes/res_avg.total_bytes):.1f}% saved by "
          f"FedPC)")

    if args.ckpt:
        path = save_checkpoint(args.ckpt, res.params, step=args.rounds,
                               metadata={"arch": cfg.name, "algo": "fedpc"})
        print("checkpoint:", path)


if __name__ == "__main__":
    main()
