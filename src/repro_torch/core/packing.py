"""2-bit packing of ternary codes — the wire format of §3.3.

Code mapping (biased): t + 1 ∈ {0, 1, 2} → 2-bit field. Four fields pack
little-endian into one uint8: byte = c0 | c1<<2 | c2<<4 | c3<<6.

Shifts run in int32: CPU torch has no shift kernels for every unsigned
width.
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils import PyTree, round_up, tree_flatten, tree_unflatten

PACK_FACTOR = 4  # ternary codes per byte


def packed_size(n: int) -> int:
    """Bytes needed for n ternary codes."""
    return round_up(n, PACK_FACTOR) // PACK_FACTOR


def _shifts(device) -> torch.Tensor:
    return torch.arange(0, 8, 2, dtype=torch.int32, device=device)


def pack2bit(t: torch.Tensor) -> torch.Tensor:
    """int8 codes {-1,0,1} of any shape → 1-D uint8 of ``packed_size``
    bytes (zero codes pad the last byte). Any other int8 code packs as the
    JAX kernel's int32 sum of ``(c + 1)·4^j`` does: its low 8 bits."""
    flat = t.reshape(-1).to(torch.int32)
    pad = round_up(flat.numel(), PACK_FACTOR) - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    fields = (flat + 1).view(-1, PACK_FACTOR)
    return (fields << _shifts(t.device)).sum(-1).to(torch.uint8)


def unpack2bit(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack2bit`; returns the first ``n`` int8 codes."""
    b = packed.reshape(-1, 1).to(torch.int32)
    fields = (b >> _shifts(packed.device)) & 3
    return (fields.reshape(-1) - 1).to(torch.int8)[:n]


def pack_tree(t: PyTree) -> tuple[torch.Tensor, tuple]:
    """Pack a whole tree of ternary codes into one uint8 buffer.

    Returns (buffer, layout); the layout, (structure, leaf shapes), is the
    public architecture the receiver already has, so it unpacks with
    nothing else.
    """
    leaves, treedef = tree_flatten(t)
    flat = torch.cat([l.reshape(-1) for l in leaves]).to(torch.int8)
    return pack2bit(flat), (treedef, [tuple(l.shape) for l in leaves])


def unpack_tree(packed: torch.Tensor, layout: tuple) -> PyTree:
    """Inverse of :func:`pack_tree`."""
    treedef, shapes = layout
    sizes = [math.prod(s) for s in shapes]
    flat = unpack2bit(packed, sum(sizes))
    leaves, off = [], 0
    for s, size in zip(shapes, sizes):
        leaves.append(flat[off:off + size].reshape(s))
        off += size
    return tree_unflatten(treedef, leaves)
