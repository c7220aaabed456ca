"""Synthetic classification data and the paper's IID split (§5.2).

A numpy copy of the JAX package's ``data/synthetic.py``: the same seeds
give the same draws.

* ``SyntheticClassification`` — a teacher-MLP labelling problem standing
  in for CIFAR-10: class-balanced, learnable.
* ``SyntheticLM`` — Markov-teacher token streams for LM training.
* ``random_share_split`` — the paper's IID protocol: random shares
  (bounded away from extremes), class-stratified per worker (Fig. 2).
* ``dirichlet_split`` — the non-IID split of Table 4 (Fig. 5).
* ``sequence_split`` — LM sequences over workers (no labels to stratify).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticClassification:
    """Teacher-generated classification: x ~ N(0, I_d), y = argmax(teacher(x))."""
    n_samples: int = 4096
    n_features: int = 32
    n_classes: int = 10
    hidden: int = 64
    seed: int = 0

    def generate(self) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        w1 = rng.normal(0, 1.0 / np.sqrt(self.n_features),
                        (self.n_features, self.hidden))
        w2 = rng.normal(0, 1.0 / np.sqrt(self.hidden),
                        (self.hidden, self.n_classes))
        x = rng.normal(0, 1, (self.n_samples, self.n_features)).astype(
            np.float32)
        logits = np.tanh(x @ w1) @ w2
        y = np.argmax(logits + 0.1 * rng.normal(size=logits.shape), axis=-1)
        return x, y.astype(np.int32)


@dataclass
class SyntheticLM:
    """Markov-teacher token streams for LM training."""
    n_sequences: int = 512
    seq_len: int = 128
    vocab: int = 256
    seed: int = 0

    def generate(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        # Sparse row-stochastic transition matrix → learnable structure.
        trans = rng.gamma(0.3, 1.0, (self.vocab, self.vocab)).astype(
            np.float64)
        trans /= trans.sum(axis=1, keepdims=True)
        cum = np.cumsum(trans, axis=1)
        toks = np.zeros((self.n_sequences, self.seq_len), np.int32)
        state = rng.integers(0, self.vocab, self.n_sequences)
        for t in range(self.seq_len):
            toks[:, t] = state
            u = rng.random(self.n_sequences)
            state = np.array(
                [np.searchsorted(cum[s], uu) for s, uu in zip(state, u)],
                dtype=np.int64,
            ).clip(0, self.vocab - 1)
        return toks


def _bounded_shares(n_workers: int, rng, lo_frac: float = 0.3) -> np.ndarray:
    """Random shares summing to 1 with min share >= lo_frac/n — the paper's
    'avoid the extreme imbalance' control (§5.2.2)."""
    raw = rng.random(n_workers) + lo_frac
    return raw / raw.sum()


def random_share_split(y: np.ndarray, n_workers: int,
                       seed: int = 0) -> list[np.ndarray]:
    """IID/stratified split (Fig. 2): heterogeneous sizes, per-class balance
    inside each worker."""
    rng = np.random.default_rng(seed)
    shares = _bounded_shares(n_workers, rng)
    worker_idx: list[list[int]] = [[] for _ in range(n_workers)]
    for c in np.unique(y):
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        bounds = np.floor(np.cumsum(shares) * len(idx)).astype(int)
        prev = 0
        for k, b in enumerate(bounds):
            worker_idx[k].extend(idx[prev:b].tolist())
            prev = b
    return [np.asarray(sorted(w), dtype=np.int64) for w in worker_idx]


def dirichlet_split(y: np.ndarray, n_workers: int, alpha: float = 0.5,
                    seed: int = 0,
                    min_per_worker: int = 2) -> list[np.ndarray]:
    """Non-IID split of Table 4 (Fig. 5): per-class Dirichlet(alpha)
    shares; a worker left with fewer than ``min_per_worker`` samples takes
    them from the largest."""
    rng = np.random.default_rng(seed)
    worker_idx: list[list[int]] = [[] for _ in range(n_workers)]
    for c in np.unique(y):
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        p = rng.dirichlet([alpha] * n_workers)
        bounds = np.floor(np.cumsum(p) * len(idx)).astype(int)
        prev = 0
        for k, b in enumerate(bounds):
            worker_idx[k].extend(idx[prev:b].tolist())
            prev = b
    out = []
    for w in worker_idx:
        if len(w) < min_per_worker:  # keep every worker trainable
            donor = int(np.argmax([len(v) for v in worker_idx]))
            need = min_per_worker - len(w)
            w = w + worker_idx[donor][:need]
            worker_idx[donor] = worker_idx[donor][need:]
        out.append(np.asarray(sorted(w), dtype=np.int64))
    return out


def sequence_split(n_sequences: int, n_workers: int, seed: int = 0,
                   iid: bool = True, alpha: float = 0.5) -> list[np.ndarray]:
    """Split LM sequences (no labels to stratify on)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_sequences)
    shares = (_bounded_shares(n_workers, rng) if iid
              else rng.dirichlet([alpha] * n_workers))
    shares = np.maximum(shares, 2.0 / n_sequences)
    shares = shares / shares.sum()
    bounds = np.floor(np.cumsum(shares) * n_sequences).astype(int)
    out, prev = [], 0
    for b in bounds:
        out.append(np.sort(idx[prev:max(b, prev + 1)]))
        prev = max(b, prev + 1)
    return out
