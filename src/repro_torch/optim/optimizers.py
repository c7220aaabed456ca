"""Minimal functional optimizers over trees of tensors.

The paper's workers use Momentum and Adam with private hyper-parameters;
the simulator gives each worker one of these. The API is the JAX
package's: ``init(params) -> state`` and ``update(grads, state, params,
lr) -> (updates, state)``, with the updates *added* to the params. State
accumulates in ``accum_dtype`` (float32 by default), and Adam's step
``count`` is a device int32, so an update never syncs with the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.utils import PyTree, tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple[PyTree, PyTree]]


class MomentumState(NamedTuple):
    velocity: PyTree


class AdamState(NamedTuple):
    mu: PyTree
    nu: PyTree
    count: torch.Tensor




def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return tree_map(lambda g: g * -lr, grads), state

    return Optimizer("sgd", init, update)


def _zeros_of(dtype: torch.dtype):
    return lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)


def momentum(decay: float = 0.9, nesterov: bool = False,
             accum_dtype: torch.dtype = torch.float32) -> Optimizer:
    """Heavy-ball momentum (Qian 1999) — the paper's ResNet optimizer.
    ``nesterov=True`` steps by ``-lr · (decay · v_new + g)`` instead of
    ``-lr · v_new``."""

    def init(params):
        return MomentumState(velocity=tree_map(_zeros_of(accum_dtype),
                                               params))

    def update(grads, state, params, lr):
        vel = tree_map(lambda v, g: decay * v + g.to(accum_dtype),
                       state.velocity, grads)
        if nesterov:
            upd = tree_map(
                lambda v, g, p: ((decay * v + g.to(accum_dtype))
                                 * -lr).to(p.dtype), vel, grads, params)
        else:
            upd = tree_map(lambda v, p: (v * -lr).to(p.dtype), vel, params)
        return upd, MomentumState(velocity=vel)

    return Optimizer("momentum", init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         accum_dtype: torch.dtype = torch.float32) -> Optimizer:
    """Adam (Kingma & Ba 2015) — the paper's U-Net optimizer."""

    def init(params):
        dev = tree_leaves(params)[0].device
        return AdamState(mu=tree_map(_zeros_of(accum_dtype), params),
                         nu=tree_map(_zeros_of(accum_dtype), params),
                         count=torch.zeros((), dtype=torch.int32, device=dev))

    def update(grads, state, params, lr):
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(accum_dtype),
                      state.mu, grads)
        nu = tree_map(
            lambda n, g: b2 * n + (1 - b2) * g.to(accum_dtype).square(),
            state.nu, grads)
        c = count.to(accum_dtype)
        mu_hat_scale = 1.0 / (1 - b1 ** c)
        nu_hat_scale = 1.0 / (1 - b2 ** c)
        upd = tree_map(
            lambda m, n, p: ((m * mu_hat_scale) * -lr
                             / ((n * nu_hat_scale).sqrt() + eps)).to(p.dtype),
            mu, nu, params)
        return upd, AdamState(mu=mu, nu=nu, count=count)

    return Optimizer("adam", init, update)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u, params, updates)


def get(name: str, **kw) -> Optimizer:
    table = {"sgd": sgd, "momentum": momentum, "adam": adam}
    return table[name](**kw)
