"""Baselines the paper compares against (§5): FedAvg and Phong et al.

* FedAvg (McMahan et al., 2017): every round, all N workers train locally
  and upload full weights; the master takes the data-share weighted average.
* Phong & Phuong (2019), "weight transmission": the model travels
  *sequentially* through the workers — worker k trains, passes weights to
  worker k+1. One "epoch" = one full pass over all workers. No averaging.

Both exchange full weights (2·V·N bytes per epoch, ``core.protocol``),
the communication bar FedPC undercuts. Plain tensor ops: the reference
computes these outside any kernel too.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.utils import PyTree, tree_leaves, tree_map, \
    tree_weighted_sum


def _shares(sizes, device) -> torch.Tensor:
    """(N,) float32 ``sizes / sum(sizes)`` on ``device``."""
    sizes = torch.as_tensor(np.asarray(sizes, np.float32), device=device)
    return sizes / sizes.sum()


def fedavg_aggregate(local_params: Sequence[PyTree], sizes) -> PyTree:
    """Data-share weighted parameter average, ``w_0·t_0 + w_1·t_1 + …`` an
    op at a time (``utils.tree_weighted_sum``)."""
    w = _shares(sizes, tree_leaves(local_params[0])[0].device)
    return tree_weighted_sum(local_params, list(w))


def fedavg_aggregate_stacked(stacked: PyTree, sizes) -> PyTree:
    """FedAvg over a stacked (N, ...) worker axis on every leaf. The
    workers are summed strictly in order k = 0..N−1, as the JAX package's
    reduction over that axis sums them on the CPU (``Tensor.sum`` may
    split a short axis), so this equals :func:`fedavg_aggregate` bitwise."""
    w = _shares(sizes, tree_leaves(stacked)[0].device)

    def avg(x):
        xf = x.float()
        out = xf[0] * w[0]
        for k in range(1, xf.shape[0]):
            out = out + xf[k] * w[k]
        return out.to(x.dtype)
    return tree_map(avg, stacked)


def phong_sequential_round(
        params: PyTree,
        train_fns: Sequence[Callable[[PyTree], tuple[PyTree, object]]]
) -> tuple[PyTree, list]:
    """One Phong et al. epoch: the model visits each worker in order.

    ``train_fns[k]`` runs worker k's local training from the given weights
    and returns (new_params, cost). Returns the final params and the
    per-worker costs.
    """
    costs = []
    for fn in train_fns:
        params, cost = fn(params)
        costs.append(cost)
    return params, costs
