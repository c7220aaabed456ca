"""Batching pipeline: per-worker iterators with private batch sizes.

A numpy copy of the JAX package's ``data/pipeline.py``: the paper's
workers choose their batch size privately from a menu and shuffle locally
each epoch, and the same seeds give the same batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class BatchIterator:
    """Epoch-based shuffling batch iterator over numpy arrays."""
    arrays: tuple            # tuple of arrays sharing dim 0
    batch_size: int
    seed: int = 0
    drop_remainder: bool = False

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.n = self.arrays[0].shape[0]
        if any(a.shape[0] != self.n for a in self.arrays):
            raise ValueError("arrays must share their first dimension")

    def epoch_indices(self) -> Iterator[np.ndarray]:
        """One epoch's batch index arrays (the rng draw of :meth:`epoch`);
        with ``drop_remainder`` the ragged last batch is left out."""
        order = self._rng.permutation(self.n)
        end = ((self.n // self.batch_size) * self.batch_size
               if self.drop_remainder else self.n)
        for s in range(0, max(end, 1), self.batch_size):
            sel = order[s: s + self.batch_size]
            if len(sel) == 0:
                break
            yield sel

    def epoch(self) -> Iterator[tuple]:
        for sel in self.epoch_indices():
            yield tuple(a[sel] for a in self.arrays)

    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return max(self.n // self.batch_size, 1)
        return -(-self.n // self.batch_size)


BATCH_MENU = (128, 64, 32)          # paper §5.1 (CIFAR-10)


def federated_loaders(arrays: tuple, splits: list[np.ndarray], seed: int = 0,
                      batch_menu: tuple = BATCH_MENU,
                      max_batch: Optional[int] = None
                      ) -> list[BatchIterator]:
    """One private loader per worker; batch size drawn from the paper's menu."""
    rng = np.random.default_rng(seed + 7919)
    loaders = []
    for k, idx in enumerate(splits):
        bs = int(rng.choice(batch_menu))
        if max_batch is not None:
            bs = min(bs, max_batch)
        bs = min(bs, max(len(idx), 1))
        loaders.append(
            BatchIterator(tuple(a[idx] for a in arrays), bs, seed=seed + k))
    return loaders
