"""Worker-side local training (Algorithm 2, line 1).

Each worker owns a private data shard and private hyper-parameters (batch
size, learning rate and its decay, local epochs, optimizer), the private
information Theorem 2's privacy argument relies on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import BatchIterator
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim.schedules import step_decay
from repro_torch.utils import PyTree, tree_leaves

EPOCH_MENU = (1, 2)               # local epochs per round
OPT_MENU = ("momentum", "adam", "sgd")


@dataclass
class WorkerConfig:
    worker_id: int
    batch_size: int
    lr0: float = 0.01
    lr_decay: float = 0.5
    lr_decay_every: int = 1000     # derived from local dataset size (paper)
    local_epochs: int = 1
    optimizer: str = "momentum"
    seed: int = 0
    # Private Eq. (5) significance threshold beta_k; None = no private draw
    # (the federation's shared beta applies).
    beta: float | None = None


def make_worker_configs(n_workers: int, shard_sizes: list[int],
                        seed: int = 0, batch_menu=(128, 64, 32),
                        beta_menu=None) -> list[WorkerConfig]:
    """Draw private hyper-parameters per worker, following §5.1 — the same
    draws as the JAX package from the same seed: batch size from a menu,
    lr 0.01 with size-dependent step decay, 1–2 local epochs, momentum or
    adam, and with ``beta_menu`` a per-worker threshold beta_k."""
    rng = np.random.default_rng(seed)
    cfgs = []
    for k in range(n_workers):
        bs = int(rng.choice(batch_menu))
        bs = min(bs, max(shard_sizes[k], 1))
        steps_per_epoch = max(shard_sizes[k] // bs, 1)
        cfgs.append(WorkerConfig(
            worker_id=k,
            batch_size=bs,
            lr0=0.01,
            lr_decay=0.5,
            lr_decay_every=max(10 * steps_per_epoch, 1),
            local_epochs=int(rng.choice(EPOCH_MENU)),
            optimizer=str(rng.choice(OPT_MENU[:2])),
            seed=seed * 1000 + k,
            beta=(float(rng.choice(beta_menu)) if beta_menu is not None
                  else None),
        ))
    return cfgs


@dataclass
class Worker:
    """Stateful in-process worker for the simulator (the paper's testbed)."""
    cfg: WorkerConfig
    loader: BatchIterator
    loss_and_grad: Callable            # (params, batch) -> ((loss, aux), grads)
    opt: opt_mod.Optimizer = field(init=False)
    opt_state: Optional[PyTree] = None
    step: int = 0

    def __post_init__(self):
        self.opt = opt_mod.get(self.cfg.optimizer)
        self.lr_fn = step_decay(self.cfg.lr0, self.cfg.lr_decay,
                                self.cfg.lr_decay_every)

    def train_round_device(self, params: PyTree
                           ) -> tuple[PyTree, torch.Tensor]:
        """Run ``local_epochs`` epochs from the given global params; return
        (local params Q_k, cost C_k). The cost stays a device scalar: no
        host sync. The optimizer state is private and persists across
        rounds."""
        if self.opt_state is None:
            self.opt_state = self.opt.init(params)
        dev = tree_leaves(params)[0].device
        total_loss = torch.zeros((), dtype=torch.float32, device=dev)
        n_batches = 0
        for _ in range(self.cfg.local_epochs):
            for batch in self.loader.epoch():
                lr = float(self.lr_fn(self.step))
                batch = tuple(torch.from_numpy(a).to(dev) for a in batch)
                (loss, _aux), grads = self.loss_and_grad(params, batch)
                updates, self.opt_state = self.opt.update(
                    grads, self.opt_state, params, lr)
                params = opt_mod.apply_updates(params, updates)
                total_loss = total_loss + loss
                n_batches += 1
                self.step += 1
        return params, total_loss / max(n_batches, 1)
