"""Worker-side local training (Algorithm 2, line 1).

Each worker owns a private data shard and private hyper-parameters (batch
size, learning rate and its decay, local epochs, optimizer), the private
information Theorem 2's privacy argument relies on.

A worker's shard is staged once on the device it trains on, and each
round's batches are gathered there from indices drawn by its loader.
:meth:`Worker.scan_train` is the local-training recurrence both of the
simulator's drivers run: one optimizer step over static tensors, the lr
computed on the device from a device step, repeated once a batch. On CUDA
that step is captured once into a CUDA graph (per worker and batch shape)
and replayed, so a round of local training is one graph replay a batch
and no host sync. A ragged shard (the last batch shorter) takes the eager
per-batch loop instead, chosen by shape as the JAX package chooses.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import BatchIterator
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim.schedules import step_decay
from repro_torch.utils import PyTree, tree_leaves, tree_map

LR_MENU = (0.01,)                 # paper: initial lr 0.01 for everyone
EPOCH_MENU = (1, 2)               # local epochs per round
OPT_MENU = ("momentum", "adam", "sgd")
BETA_MENU = (0.1, 0.2, 0.3)       # heterogeneous per-worker beta_k choices
GRAPH_WARMUP = 3                  # eager steps on a side stream before capture


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


def _copy_into(dst: PyTree, src: PyTree) -> None:
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not s:
            d.copy_(s)


class TrainStep:
    """One optimizer step of a worker, in place over static tensors.

    The statics are the params, the optimizer state, the device step, the
    round's stacked batches ``(steps, batch, ...)``, the index ``i`` of
    the next batch and the running loss sum. A call gathers batch ``i``,
    computes the lr from the step, takes the loss and its gradient
    (``torch.autograd.grad``), applies the update and writes every result
    back into its static, so the same call can be captured into a CUDA
    graph (:meth:`capture`) and replayed with no host work. ``load`` fills
    the statics for a round; an input that already is the static (the
    optimizer state a worker keeps) is not copied.
    """

    def __init__(self, worker: "Worker", params: PyTree, opt_state: PyTree,
                 batches: tuple):
        clone = lambda x: x.detach().clone()          # noqa: E731
        self.lr_fn = worker.lr_fn
        self.loss_and_grad = worker.loss_and_grad
        self.opt = worker.opt
        self.params = tree_map(clone, params)
        self.opt_state = tree_map(clone, opt_state)
        self.batches = tuple(clone(b) for b in batches)
        dev = self.batches[0].device
        self.step = torch.zeros((), dtype=torch.int32, device=dev)
        self.i = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.total = torch.zeros((), dtype=torch.float32, device=dev)
        self.graph: torch.cuda.CUDAGraph | None = None

    def load(self, params: PyTree, opt_state: PyTree, step: torch.Tensor,
             batches: tuple) -> None:
        _copy_into((self.params, self.opt_state, self.step, self.batches),
                   (params, opt_state, step, batches))
        self.i.zero_()
        self.total.zero_()

    def __call__(self) -> None:
        batch = tuple(b.index_select(0, self.i)[0] for b in self.batches)
        lr = self.lr_fn(self.step)
        (loss, _aux), grads = self.loss_and_grad(self.params, batch)
        updates, opt_state = self.opt.update(grads, self.opt_state,
                                             self.params, lr)
        _copy_into(self.params, opt_mod.apply_updates(self.params, updates))
        _copy_into(self.opt_state, opt_state)
        self.step.add_(1)
        self.total.add_(loss)
        self.i.add_(1)

    def capture(self) -> None:
        """Warm the step up on a side stream, as PyTorch's graph recipe
        asks (the cuBLAS handles and the autograd state exist before the
        capture), then capture one call into :attr:`graph` on that stream.
        Unlike ``torch.cuda.graph``, this neither synchronizes the device
        nor empties the allocator's cache first: a federation captures a
        step per worker, and each emptied cache would be refilled by
        fresh device allocations. The warm-up changes the statics:
        ``load`` them before replaying. A failed capture raises."""
        dev = self.step.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                self()
            graph.capture_begin()
            try:
                self()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = graph

    def run(self, n_steps: int) -> None:
        """``n_steps`` steps from the loaded statics: graph replays when
        captured, eager calls otherwise."""
        for _ in range(n_steps):
            if self.graph is None:
                self()
            else:
                self.graph.replay()


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
        self._shards: dict = {}        # device -> the shard staged there
        self._steps: dict = {}         # (device, batch shapes) -> TrainStep

    @property
    def uniform_batches(self) -> bool:
        """True when every batch of an epoch has the same shape — the
        condition for stacking a round's batches into one ``scan_train``."""
        return self.loader.n % self.loader.batch_size == 0

    def shard(self, device: torch.device) -> tuple:
        """The loader's arrays as tensors on ``device``, copied there once."""
        device = torch.device(device)
        if device not in self._shards:
            self._shards[device] = tuple(torch.from_numpy(a).to(device)
                                         for a in self.loader.arrays)
        return self._shards[device]

    def round_indices(self) -> np.ndarray:
        """One round's batch schedule, ``(steps, batch)`` sample indices:
        ``local_epochs`` epochs of the loader's rng, as
        :meth:`stack_round_batches` draws them."""
        return np.stack([sel for _ in range(self.cfg.local_epochs)
                         for sel in self.loader.epoch_indices()])

    def stack_round_batches(self) -> tuple:
        """Draw one round's batch schedule from the loader and stack it into
        the (steps, batch, ...) arrays ``scan_train`` consumes."""
        idx = self.round_indices()
        return tuple(a[idx] for a in self.loader.arrays)

    def gather(self, idx: torch.Tensor) -> tuple:
        """The stacked batches of a ``(steps, batch)`` index tensor,
        gathered from the shard staged on the indices' device."""
        flat = idx.reshape(-1)
        return tuple(a.index_select(0, flat).view(*idx.shape, *a.shape[1:])
                     for a in self.shard(idx.device))

    def train_step(self, params: PyTree, opt_state: PyTree,
                   batches: tuple) -> TrainStep:
        """This worker's :class:`TrainStep` for the batch shape of
        ``batches``, made at first use; on CUDA it is captured into a CUDA
        graph then."""
        dev = batches[0].device
        key = (dev, tuple((tuple(b.shape), b.dtype) for b in batches))
        if key not in self._steps:
            step = TrainStep(self, params, opt_state, batches)
            if dev.type == "cuda":
                step.capture()
            self._steps[key] = step
        return self._steps[key]

    def train_round(self, params: PyTree) -> tuple[PyTree, float]:
        """Run ``local_epochs`` epochs from the given global params; return
        (local params Q_k, cost C_k). The one ``float(...)`` here is the
        round's only device→host sync."""
        params, cost = self.train_round_device(params)
        return params, float(cost)

    def scan_train(self, params: PyTree, opt_state: PyTree,
                   step: torch.Tensor, batches: tuple
                   ) -> tuple[PyTree, PyTree, torch.Tensor, torch.Tensor]:
        """One round of local training over stacked batches (a tuple of
        ``(steps, batch, ...)`` tensors on the training device); ``step``
        is the 0-d int32 device step.

        This is THE local-training recurrence: ``train_round_device`` and
        the simulator's scan driver both run it, so the two drivers give
        the same bits. The step runs through :meth:`train_step`, a CUDA
        graph replay a batch on the card. Returns (params, opt_state,
        step, mean cost); the optimizer state is donated: what comes back
        is the step's own statics, updated in place by the next call.
        """
        n_steps = batches[0].shape[0]
        ts = self.train_step(params, opt_state, batches)
        ts.load(params, opt_state, step, batches)
        ts.run(n_steps)
        return (tree_map(torch.clone, ts.params), ts.opt_state,
                ts.step.clone(), ts.total / max(n_steps, 1))

    def train_round_device(self, params: PyTree
                           ) -> tuple[PyTree, torch.Tensor]:
        """``train_round`` without the host sync: the cost stays a device
        scalar. Uniform shards run :meth:`scan_train` over the round's
        batches, gathered on the device; ragged shards the eager per-batch
        loop (:meth:`train_round_eager`)."""
        if not self.uniform_batches:
            return self.train_round_eager(params)
        if self.opt_state is None:
            self.opt_state = self.opt.init(params)
        dev = tree_leaves(params)[0].device
        idx = torch.from_numpy(self.round_indices()).to(dev)
        params, self.opt_state, _, cost = self.scan_train(
            params, self.opt_state,
            torch.tensor(self.step, dtype=torch.int32, device=dev),
            self.gather(idx))
        self.step += idx.shape[0]
        return params, cost

    def train_round_eager(self, params: PyTree
                          ) -> tuple[PyTree, torch.Tensor]:
        """The per-batch loop: ``local_epochs`` epochs, one optimizer step
        a batch at the host step's lr, the batches gathered from the shard
        on the params' device (one copy of the round's indices)."""
        if self.opt_state is None:
            self.opt_state = self.opt.init(params)
        dev = tree_leaves(params)[0].device
        sels = [sel for _ in range(self.cfg.local_epochs)
                for sel in self.loader.epoch_indices()]
        total_loss = torch.zeros((), dtype=torch.float32, device=dev)
        if not sels:
            return params, total_loss
        shard = self.shard(dev)
        flat = torch.from_numpy(np.concatenate(sels)).to(dev)
        off = 0
        for sel in sels:
            idx = flat[off: off + len(sel)]
            off += len(sel)
            batch = tuple(a.index_select(0, idx) for a in shard)
            lr = float(self.lr_fn(self.step))
            (loss, _aux), grads = self.loss_and_grad(params, batch)
            updates, self.opt_state = self.opt.update(
                grads, self.opt_state, params, lr)
            params = opt_mod.apply_updates(params, updates)
            total_loss = total_loss + loss
            self.step += 1
        return params, total_loss / len(sels)
