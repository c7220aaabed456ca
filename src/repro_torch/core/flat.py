"""FlatParams — the single-buffer wire representation of a model tree.

The wire path (Eq. (4)/(5) ternarization, §3.3 2-bit packing, Eq. (3)
master update) is elementwise over every parameter, so the whole tree is
flattened once into one zero-padded ``(rows, 128)`` float32 buffer and the
round's wire math runs as two kernel launches over it.

Leaves are raveled in ``repro_torch.utils.tree_leaves`` order (sorted dict
keys, the ``jax.tree_util`` order) and concatenated into ``n`` scalars,
zero-padded to ``rows * 128`` with ``rows % ROW_MULTIPLE == 0``. Every view
the kernels need is then aligned:

* ``(rows, 128)``      — float32 buffer;
* ``(rows // 4, 512)`` — the uplink kernel's input view (4 consecutive
  codes per output byte, the §3.3 byte order);
* ``(rows // 4, 128)`` — the packed uint8 wire buffer.

The zero padding is a fixed point of the wire path: ``q = p1 = p2 = 0``
ternarizes to code 0 and the master maps a zero tail to a zero tail.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.utils import PyTree, round_up, tree_flatten, \
    tree_leaves, tree_unflatten

LANES = 128
ROW_MULTIPLE = 32          # keeps rows, rows//4 aligned (see above)
PACK = 4                   # ternary codes per wire byte (§3.3)


class FlatLayout(NamedTuple):
    """Static description of how a tree maps into the flat buffer."""
    treedef: Any
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]   # start of each leaf in the flat vector
    n: int                     # total real scalars
    rows: int                  # padded buffer rows (rows % ROW_MULTIPLE == 0)
    shards: int = 1            # model-axis slabs (rows % (ROW_MULTIPLE*shards) == 0)

    @property
    def padded(self) -> int:
        return self.rows * LANES

    @property
    def shard_rows(self) -> int:
        """Rows of one model shard's (shard_rows, 128) slab."""
        return self.rows // self.shards


def layout_of(tree: PyTree, shards: int = 1) -> FlatLayout:
    """The FlatLayout of a tree. ``shards`` pads ``rows`` to a multiple of
    ``ROW_MULTIPLE * shards``, so that the buffer splits into ``shards``
    aligned slabs, one a model-axis rank of the distributed runtime."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    leaves, treedef = tree_flatten(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    rows = round_up(max(-(-off // LANES), 1), ROW_MULTIPLE * shards)
    return FlatLayout(treedef, shapes, dtypes, sizes, tuple(offsets), off,
                      rows, shards)


def flatten_tree(tree: PyTree, layout: FlatLayout) -> torch.Tensor:
    """Tree → padded (rows, 128) float32 buffer on the leaves' device."""
    leaves = tree_leaves(tree)
    buf = torch.zeros(layout.padded, dtype=torch.float32,
                      device=leaves[0].device)
    for l, o, s in zip(leaves, layout.offsets, layout.sizes):
        buf[o:o + s].copy_(l.reshape(-1))
    return buf.view(layout.rows, LANES)


def flatten_stacked(tree_F: PyTree, layout: FlatLayout) -> torch.Tensor:
    """Tree with (F, *shape) leaves → (F, rows, 128) float32 buffers."""
    leaves = tree_leaves(tree_F)
    f = leaves[0].shape[0]
    buf = torch.zeros((f, layout.padded), dtype=torch.float32,
                      device=leaves[0].device)
    for l, o, s in zip(leaves, layout.offsets, layout.sizes):
        buf[:, o:o + s].copy_(l.reshape(f, -1))
    return buf.view(f, layout.rows, LANES)


def unflatten_tree(buf: torch.Tensor, layout: FlatLayout) -> PyTree:
    """Padded (rows, 128) buffer → tree. Leaves of the buffer's own dtype
    are views into ``buf``: treat them as read-only."""
    flat = buf.reshape(-1)
    leaves = [flat[o:o + s].view(shape).to(dt)
              for o, s, shape, dt in zip(layout.offsets, layout.sizes,
                                         layout.shapes, layout.dtypes)]
    return tree_unflatten(layout.treedef, leaves)
