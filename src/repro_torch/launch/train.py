"""Training launcher of the port, the twin of the JAX package's
``launch/train.py``.

Two modes:

* ``simulate``    — the paper's testbed: N in-process workers on the
  model zoo (reduced by default), FedPC / FedAvg / Phong et al., synthetic
  LM data, through ``FedSimulator``.
* ``distributed`` — the mesh runtime (``fed.distributed.build_fed_step``):
  an (F fed × M model) mesh of ``torch.distributed`` ranks, each fed
  worker's model tensor-parallel over its ``--model-shards`` M ranks
  (DTensors placed by ``param_specs`` on the worker's model group). It
  spawns the F·M processes itself (start method ``spawn``) unless
  ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``) is there.
  ``--backend`` is required: ``nccl`` puts rank r on card ``LOCAL_RANK``
  (one card a rank), ``gloo`` puts every rank on card 0 (or on the CPU
  with ``--device cpu``), the model axis's collectives staged through
  host memory.

Both run on the card unless given ``--device cpu``, and raise without one.

Examples::

  PYTHONPATH=src python -m repro_torch.launch.train simulate \\
      --arch qwen3-14b --workers 4 --rounds 20
  PYTHONPATH=src python -m repro_torch.launch.train distributed \\
      --backend gloo --fed-workers 4 --model-shards 2 --rounds 3
  torchrun --nproc-per-node 4 -m repro_torch.launch.train distributed \\
      --backend nccl --fed-workers 4 --model-shards 1
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def _device(name: str | None):
    from repro_torch.utils import resolve_device
    return resolve_device(None if name in (None, "cuda") else name)


def _simulate(args) -> int:
    import torch
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import BatchIterator
    from repro_torch.data.synthetic import SyntheticLM, sequence_split
    from repro_torch.fed.simulator import FedSimulator
    from repro_torch.fed.worker import Worker, make_worker_configs
    from repro_torch.models import build_model

    dev = _device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    m = build_model(cfg)
    toks = SyntheticLM(n_sequences=args.sequences, seq_len=args.seq_len,
                       vocab=cfg.vocab, seed=args.seed).generate()
    splits = sequence_split(len(toks), args.workers, seed=args.seed)
    wcfgs = make_worker_configs(args.workers, [len(s) for s in splits],
                                seed=args.seed, batch_menu=(16, 8))
    workers = [Worker(cfg=wcfgs[k],
                      loader=BatchIterator((toks[splits[k]],),
                                           wcfgs[k].batch_size, seed=k),
                      loss_and_grad=m.loss_and_grad)
               for k in range(args.workers)]
    params = m.init(torch.Generator().manual_seed(args.seed), device=dev)
    sim = FedSimulator(workers, params, evade_streak=args.evade_streak,
                       device=dev)
    res = getattr(sim, f"run_{args.algo}")(args.rounds)
    print(f"[train] {args.algo} on {cfg.name}: cost {res.costs[0]:.4f} -> "
          f"{res.costs[-1]:.4f}, bytes {res.total_bytes / 1e6:.2f} MB",
          flush=True)
    if args.ckpt:
        print("[train] saved:", save_checkpoint(
            args.ckpt, res.params, step=args.rounds,
            metadata={"arch": cfg.name, "algo": args.algo}), flush=True)
    return 0


def _rank(rank: int, world: int, init_method: str, args) -> None:
    """One rank of the distributed run."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.fed.distributed import build_fed_step, fed_state_init
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import build_model

    dev = _device(args.device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local if args.backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(args.backend, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        F = args.fed_workers
        mesh = make_debug_mesh(F, args.model_shards)
        f = mesh.axes["data"].index
        cfg = get_config(args.arch)
        if not args.full_size:
            cfg = cfg.reduced()
        m = build_model(cfg)
        params = m.init(torch.Generator().manual_seed(args.seed), device=dev)
        state = fed_state_init(params, F)
        opt = m.optimizer.init(params)
        sizes = torch.tensor([100.0 + 25 * k for k in range(F)], device=dev)
        fed_step = build_fed_step(m, mesh, "data", args.strategy,
                                  local_steps=args.local_steps, lr=args.lr,
                                  device=dev)
        rng = np.random.default_rng(args.seed)
        for r in range(args.rounds):
            toks = rng.integers(0, cfg.vocab, (F, args.local_steps,
                                               args.local_batch,
                                               args.seq_len))
            batch = {"tokens": torch.from_numpy(toks[f]).to(dev)}
            state, opt, metrics = fed_step(state, opt, batch, sizes)
            if rank == 0:
                print(f"[train] round {r + 1}: "
                      f"cost={float(metrics['cost_mean']):.4f} "
                      f"pilot={int(metrics['k_star'])}", flush=True)
    finally:
        dist.destroy_process_group()


def _distributed(args) -> int:
    _device(args.device)                  # no card and no --device cpu: raise
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        _rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
              "env://", args)
        return 0
    import torch.multiprocessing as mp
    world = args.fed_workers * args.model_shards
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(world, "file://" + os.path.join(
            d, "rendezvous"), args), nprocs=world, start_method="spawn")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)

    sim = sub.add_parser("simulate")
    sim.add_argument("--arch", default="fedpc-paper")
    sim.add_argument("--algo", default="fedpc",
                     choices=["fedpc", "fedavg", "phong"])
    sim.add_argument("--workers", type=int, default=4)
    sim.add_argument("--rounds", type=int, default=10)
    sim.add_argument("--seq-len", type=int, default=64)
    sim.add_argument("--sequences", type=int, default=192)
    sim.add_argument("--seed", type=int, default=0)
    sim.add_argument("--evade-streak", type=int, default=0)
    sim.add_argument("--full-size", action="store_true")
    sim.add_argument("--ckpt", default=None)
    sim.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    dist = sub.add_parser("distributed")
    dist.add_argument("--arch", default="fedpc-paper")
    dist.add_argument("--strategy", default="fedpc_packed",
                      choices=["fedpc", "fedpc_packed", "fedpc_reduce",
                               "fedavg"])
    dist.add_argument("--backend", required=True, choices=["gloo", "nccl"])
    dist.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dist.add_argument("--fed-workers", type=int, default=4)
    dist.add_argument("--model-shards", type=int, default=2,
                      help="M: the ranks a fed worker's model is "
                           "tensor-parallel over")
    dist.add_argument("--rounds", type=int, default=3)
    dist.add_argument("--local-steps", type=int, default=2)
    dist.add_argument("--local-batch", type=int, default=2)
    dist.add_argument("--seq-len", type=int, default=32)
    dist.add_argument("--lr", type=float, default=0.02)
    dist.add_argument("--seed", type=int, default=0)
    dist.add_argument("--full-size", action="store_true")

    args = ap.parse_args(argv)
    return (_simulate(args) if args.mode == "simulate"
            else _distributed(args))


if __name__ == "__main__":
    sys.exit(main())
