"""Compact MLP classifier — the model the FedPC simulator federates.

BatchNorm-free, like the paper's §5.2.1 choice (BatchNorm statistics would
leak the data distribution). Parameters are a nested dict
``{"layer<i>": {"w": (d_in, d_out), "b": (d_out,)}}``, the JAX package's
layout, so flat buffers of the two packages compare bitwise.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.models.layers import dense_init
from repro_torch.utils import resolve_device, value_and_grad


def init_mlp_classifier(generator: torch.Generator, n_features: int,
                        n_classes: int, hidden: Sequence[int] = (64, 64), *,
                        device=None) -> dict:
    """Random weights from ``generator``, zero biases, on ``device``
    (``None`` means CUDA)."""
    dev = resolve_device(device)
    dims = [n_features, *hidden, n_classes]
    return {
        f"layer{i}": {
            "w": dense_init(generator, dims[i], dims[i + 1]).to(dev),
            "b": torch.zeros((dims[i + 1],), dtype=torch.float32,
                             device=dev),
        }
        for i in range(len(dims) - 1)
    }


def mlp_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        p = params[f"layer{i}"]
        x = x @ p["w"] + p["b"]
        if i < n - 1:
            x = torch.tanh(x)
    return x


def mlp_loss(params: dict, batch: tuple) -> tuple[torch.Tensor, dict]:
    x, y = batch
    logits = mlp_logits(params, x)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, y.long()[:, None])[:, 0]
    return (lse - gold).mean(), {}


def mlp_accuracy(params: dict, x, y) -> float:
    """Top-1 accuracy on numpy or tensor data (one host sync)."""
    dev = params["layer0"]["w"].device
    with torch.no_grad():
        pred = mlp_logits(params, torch.as_tensor(x, device=dev)).argmax(-1)
        return float((pred == torch.as_tensor(y, device=dev)).float().mean())


def mlp_loss_and_grad(params: dict, batch: tuple
                      ) -> tuple[tuple[torch.Tensor, dict], dict]:
    """``((loss, aux), grads)`` with ``grads`` shaped like ``params``."""
    return value_and_grad(mlp_loss, params, batch)
