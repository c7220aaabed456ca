"""Tree checkpoints: an ``.npz`` tensor store and a JSON manifest.

The JAX package's format, so a checkpoint written by either package loads
in the other. ``ckpt_<step:08d>.npz`` holds one array a leaf, keyed by the
leaf's path: dict keys (walked in sorted order), NamedTuple field names
and sequence indices joined by ``/`` (``buf_p1``, ``accountant/eps_sum``,
``telemetry/rounds``); a ``None`` field has no key. ``ckpt_<step>.json``
records the step, the sorted keys, each key's numpy dtype name and shape,
and the caller's metadata. ``npz`` cannot store bfloat16, so a bfloat16
leaf is stored as its ``uint16`` bits and its manifest dtype reads
``"bfloat16"``.

Loading is strict on what the caller expects: a key of ``like`` that the
file lacks, or a shape that differs, raises; keys ``like`` does not have
are ignored. Each leaf comes back in the dtype and on the device of
``like``'s leaf.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.utils import PyTree

# Unsigned torch types without a numpy twin on every torch version travel
# as the signed type of their width, bits unchanged.
_SIGNED = {torch.uint16: (torch.int16, np.uint16),
           torch.uint32: (torch.int32, np.uint32),
           torch.uint64: (torch.int64, np.uint64),
           torch.bfloat16: (torch.int16, np.uint16)}
_UNSIGNED = {np.dtype(np.uint16): (np.int16, torch.uint16),
             np.dtype(np.uint32): (np.int32, torch.uint32),
             np.dtype(np.uint64): (np.int64, torch.uint64)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_path(tree: PyTree, prefix: tuple = ()) -> list:
    """``(path, leaf)`` pairs in ``jax.tree_util`` order; ``None`` is no
    leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), c) for i, c in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    return [pl for k, c in items
            for pl in _flatten_with_path(c, prefix + (k,))]


def _rebuild(tree: PyTree, leaves) -> PyTree:
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*[_rebuild(c, leaves) for c in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(c, leaves) for c in tree)
    return next(leaves)


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """A leaf as the array ``npz`` stores and its manifest dtype name."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        return a, str(a.dtype)
    x = x.detach().cpu()
    if x.dtype in _SIGNED:
        signed, unsigned = _SIGNED[x.dtype]
        a = x.view(signed).numpy().view(unsigned)
        return a, "bfloat16" if x.dtype == torch.bfloat16 else str(a.dtype)
    a = x.numpy()
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype_name: str | None) -> torch.Tensor:
    """A stored array back as a CPU tensor of its recorded dtype."""
    if dtype_name == "bfloat16" and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype in _UNSIGNED:
        signed, dtype = _UNSIGNED[a.dtype]
        return torch.from_numpy(a.view(signed)).view(dtype)
    return torch.from_numpy(a)


def save_checkpoint(directory: str, tree: PyTree, step: int,
                    metadata: dict | None = None) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``directory``; returns
    the ``.npz`` path. Device tensors are copied to the host."""
    os.makedirs(directory, exist_ok=True)
    arrays, dtypes = {}, {}
    for key, leaf in _flatten_with_path(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    ckpt = os.path.join(directory, f"ckpt_{step:08d}")
    np.savez(ckpt + ".npz", **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "dtypes": dtypes,
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "metadata": metadata or {},
    }
    with open(ckpt + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return ckpt + ".npz"


def latest_step(directory: str) -> int | None:
    """The highest step checkpointed under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(f[len("ckpt_"):-len(".npz")])
        for f in os.listdir(directory)
        if f.startswith("ckpt_") and f.endswith(".npz")
    ]
    return max(steps) if steps else None


def load_checkpoint(directory: str, like: PyTree,
                    step: int | None = None) -> tuple[PyTree, dict]:
    """Restore into the structure of ``like`` (the latest step unless
    ``step``): every leaf of ``like`` must be a tensor whose key is in the
    file with the same shape; it comes back in that tensor's dtype and on
    its device. Returns ``(tree, manifest)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    ckpt = os.path.join(directory, f"ckpt_{step:08d}")
    with open(ckpt + ".json") as f:
        manifest = json.load(f)
    leaves = []
    with np.load(ckpt + ".npz") as data:
        for key, v in _flatten_with_path(like):
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(v.shape):
                raise ValueError(f"{key}: shape {arr.shape} != expected "
                                 f"{tuple(v.shape)}")
            t = _to_tensor(arr, manifest["dtypes"].get(key))
            leaves.append(t.to(device=v.device, dtype=v.dtype))
    return _rebuild(like, iter(leaves)), manifest
