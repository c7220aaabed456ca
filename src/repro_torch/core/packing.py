"""2-bit packing of ternary codes — the wire format of §3.3.

Code mapping (biased): t + 1 ∈ {0, 1, 2} → 2-bit field. Four fields pack
little-endian into one uint8: byte = c0 | c1<<2 | c2<<4 | c3<<6.

Shifts run in int32: CPU torch has no shift kernels for every unsigned
width.
"""
from __future__ import annotations

import torch

from repro_torch.utils import round_up

PACK_FACTOR = 4  # ternary codes per byte


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
