"""Small shared utilities: nested-dict pytrees, shape math, device choice,
and op accounting of a program (:func:`program_op_counts`).

A "tree" here is a nested ``dict`` / ``list`` / ``tuple`` whose leaves are
tensors (or anything else that is not one of those containers). Dict keys
are walked in **sorted** order, as ``jax.tree_util`` does, so a model's
flat buffer lays its leaves out exactly as the JAX package does
(``layer0.b, layer0.w, layer1.b, ...``; ``layer10`` sorts before
``layer2``).

The JAX package's ``split_rngs`` has no counterpart here (a worker draws
from its own ``torch.Generator``), and its ``iter_jaxpr_eqns`` /
``jaxpr_primitive_counts`` have :func:`program_op_counts`.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable

import torch

PyTree = Any


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; raise when CUDA is absent rather than silently
    running on the CPU. An explicit ``"cpu"`` is honoured."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


# The walks below are module-level functions, not nested closures: a
# recursive closure is a reference cycle (the function holds the cell that
# holds it), which would keep the leaves it sees alive until the cyclic
# garbage collector runs.

def _flatten(node, leaves: list):
    if isinstance(node, dict):
        keys = sorted(node)
        return (dict, tuple(keys),
                tuple(_flatten(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        return (type(node), len(node),
                tuple(_flatten(c, leaves) for c in node))
    leaves.append(node)
    return None


def tree_flatten(tree: PyTree) -> tuple[list, Any]:
    """Leaves in ``jax.tree_util`` order and a hashable structure."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def tree_leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def _build(d, it):
    if d is None:
        return next(it)
    kind, meta, children = d
    built = [_build(c, it) for c in children]
    if kind is dict:
        return dict(zip(meta, built))
    if kind in (list, tuple):
        return kind(built)
    return kind(*built)            # a NamedTuple


def tree_unflatten(treedef, leaves) -> PyTree:
    return _build(treedef, iter(leaves))


def tree_map(fn: Callable, *trees: PyTree) -> PyTree:
    """``fn`` over the leaves of ``trees[0]`` and, beside each, the leaves
    of the other trees (of the same structure)."""
    leaves, treedef = tree_flatten(trees[0])
    others = [tree_flatten(r)[0] for r in trees[1:]]
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])


def value_and_grad(loss_fn: Callable, params: PyTree, batch
                   ) -> tuple[tuple[torch.Tensor, Any], PyTree]:
    """``((loss, aux), grads)`` of ``loss_fn(params, batch) -> (loss,
    aux)``, with ``grads`` shaped like ``params`` (``torch.autograd.grad``
    over detached copies of the leaves; ``aux`` detached): the form a
    ``Worker`` trains with."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    aux = tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor)
                   else a, aux)
    return (loss.detach(), aux), tree_unflatten(treedef, list(grads))


def tree_size(tree: PyTree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def tree_bytes(tree: PyTree) -> int:
    """Total bytes of a tree of tensors."""
    return sum(math.prod(x.shape) * x.element_size()
               for x in tree_leaves(tree))


def tree_ravel(tree: PyTree) -> tuple[torch.Tensor, Callable]:
    """The leaves raveled into one 1-D tensor, and the function that maps
    such a vector back to the tree, as ``jax.flatten_util.ravel_pytree``:
    leaves of one dtype are concatenated as they are and unraveled in the
    vector's dtype; leaves of several are promoted to a common dtype, and
    the vector they unravel from must have it (else ``TypeError``), each
    leaf cast back to its own."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        return (torch.zeros(0, dtype=torch.float32),
                lambda v: tree_unflatten(treedef, []))
    shapes = [tuple(l.shape) for l in leaves]
    sizes = [math.prod(s) for s in shapes]
    dtypes = [l.dtype for l in leaves]
    to = functools.reduce(torch.promote_types, dtypes)
    vec = torch.cat([l.reshape(-1).to(to) for l in leaves])
    single = all(dt == to for dt in dtypes)

    def unravel(v: torch.Tensor) -> PyTree:
        if not single and v.dtype != to:
            raise TypeError(f"unravel function given array of dtype "
                            f"{v.dtype}, but expected dtype {to}")
        parts = [p.reshape(s) for p, s in zip(torch.split(v, sizes), shapes)]
        if not single:
            parts = [p.to(dt) for p, dt in zip(parts, dtypes)]
        return tree_unflatten(treedef, parts)
    return vec, unravel


def tree_zeros_like(tree: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(a: PyTree, s) -> PyTree:
    return tree_map(lambda x: x * s, a)


def tree_weighted_sum(trees, weights) -> PyTree:
    """``w_0·t_0 + w_1·t_1 + …``, an op at a time in that order (FedAvg):
    each product and each sum rounded on its own, as the JAX package's
    eager ops round them, so the result does not depend on the device."""
    trees = list(trees)
    out = tree_scale(trees[0], weights[0])
    for t, w in zip(trees[1:], weights[1:]):
        out = tree_add(out, tree_scale(t, w))
    return out


def tree_allfinite(tree: PyTree) -> torch.Tensor:
    """0-d bool tensor on the leaves' device: every element of every leaf
    finite. No host sync."""
    return torch.stack([torch.isfinite(x).all()
                        for x in tree_leaves(tree)]).all()


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB", "PiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} EiB"


def human_count(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000.0:
            return f"{n:.2f}{unit}"
        n /= 1000.0
    return f"{n:.2f}Q"


def log2_int(x: int) -> int:
    """log2 of a power of two; ``AssertionError`` for any other positive
    integer, ``ValueError`` for one that is not positive."""
    l = int(math.log2(x))
    assert (1 << l) == x, f"{x} is not a power of two"
    return l


# -- op accounting (structural asserts in tests and the chip smoke) --------

#: The name a recording gives a copy from the device to the CPU
#: (``aten::_to_copy`` or ``aten::copy_`` onto the CPU).
TO_HOST = "to_host"

#: ATen ops that make the host wait for the device:
#: ``aten::_local_scalar_dense`` (``.item()``, ``int()``, ``float()``,
#: ``bool()`` of a tensor), ``aten::equal`` (a Python bool),
#: ``aten::nonzero`` and ``aten::masked_select`` (a result whose shape
#: depends on the data), and :data:`TO_HOST`, a copy to the CPU. A
#: device-resident round contains none of them.
HOST_SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::equal", "aten::nonzero",
    "aten::masked_select", TO_HOST,
})


def program_op_counts(fn: Callable, *args, **kwargs) -> dict:
    """``{op or launch: count}`` over one run of ``fn`` on the ``meta``
    specs of its tensor arguments (``kernels.seam.record``): each ATen op
    outside a kernel under its name (``aten::add``), each kernel launch
    under ``"launch:<kind>"`` (the wrapper's ``LAUNCHES`` key), and each
    host sync under its :data:`HOST_SYNC_OPS` name; a meta tensor has no
    value, so a host sync is counted and answered with a placeholder, not
    run. The counterpart of the JAX package's ``jaxpr_primitive_counts``,
    but an eager run: a loop counts once an iteration, and of a branch
    only the side taken."""
    from repro_torch.kernels import seam
    return seam.record(fn, *args, **kwargs)[0].counts()
