"""Carry parameters across from the JAX package.

``jax.random`` draws numbers that torch cannot reproduce, so a run that
must compute what the JAX package computes starts from the JAX package's
own initial weights, fetched as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import PyTree, resolve_device, tree_map


def params_from_numpy(tree: PyTree, device=None) -> PyTree:
    """A nested dict of numpy arrays → the same dict of tensors on
    ``device`` (``None`` means CUDA), dtypes and bits unchanged."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)
