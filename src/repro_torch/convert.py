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


def _tensor(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: carry the
        # 16-bit patterns across and reinterpret them.
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: PyTree, device=None) -> PyTree:
    """A nested dict of numpy arrays → the same dict of tensors on
    ``device`` (``None`` means CUDA), dtypes and bits unchanged; bfloat16
    arrays (``np.asarray`` of a JAX bfloat16 array) included."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a).to(dev), tree)
