"""Order-exact oracles for the wire kernels, on flat tensors.

They share semantics with ``repro_torch.core.{ternary,packing}`` and with
the JAX package's ``repro/kernels/ref.py``, so parity tests compare bits,
not tolerances; the exceptions are :func:`packed_master_update_ref` and
:func:`master_update_ref`, which reduce over the workers with an einsum in
an order the backend picks and are held within float32 rounding.

The worker fold ``field·w_k − w_k`` and the Eq. (3) combine
``q − coeff·mult`` are each rounded **once**, as fused multiply-adds: the
CUDA master kernel computes them with ``__fmaf_rn``, and the JAX package's
CPU backend contracts the same expressions into FMAs under jit (the fold's
is exact for the wire's fields {0, 1, 2}). :func:`fma_f32` reproduces that
single rounding exactly on any device.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import pack2bit, unpack2bit
from repro_torch.core.ternary import ternarize, ternarize_round1


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """float32 ``a·b + c`` with one rounding, as an FMA gives it.

    ``a·b`` is exact in float64 (24 + 24 significand bits < 53). The sum
    is taken in float64 with round-to-odd — the two-sum error says whether
    it was inexact, and an inexact result with an even last bit is moved
    one ulp toward the error — so the final cast to float32 rounds the
    exact value correctly (round-to-odd with 29 spare bits avoids double
    rounding).
    """
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    bits = s.view(torch.int64)
    nudge = (err != 0) & ((bits & 1) == 0)
    away = (err > 0) == (s > 0)        # the error points away from zero
    bits = torch.where(nudge, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).float()


def ternary_encode_ref(q: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                       beta: float) -> torch.Tensor:
    """Eq. (5) on flat float32 tensors → int8 codes."""
    return ternarize(q, p1, p2, beta)


def ternary_encode_round1_ref(q: torch.Tensor, p0: torch.Tensor,
                              alpha: float) -> torch.Tensor:
    """Eq. (4) on flat float32 tensors → int8 codes."""
    return ternarize_round1(q, p0, alpha)


def pack2bit_ref(t: torch.Tensor) -> torch.Tensor:
    """int8 codes (..., 4k) → uint8 (..., k): biased 2-bit fields,
    little-endian, each shifted field and the sum kept to 8 bits."""
    fields = (t.to(torch.int32) + 1) & 0xFF
    g = fields.reshape(t.shape[:-1] + (t.shape[-1] // 4, 4))
    shifted = (g << torch.arange(0, 8, 2, dtype=torch.int32,
                                 device=t.device)) & 0xFF
    return (shifted.sum(-1) & 0xFF).to(torch.uint8)


def unpack2bit_ref(b: torch.Tensor) -> torch.Tensor:
    """uint8 (..., k) → int8 codes (..., 4k)."""
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=b.device)
    fields = (b.to(torch.int32)[..., None] >> shifts) & 3
    return (fields - 1).to(torch.int8).reshape(b.shape[:-1] + (-1,))


def ternary_pack_ref(q: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                     beta: float) -> torch.Tensor:
    """Fused-uplink oracle: Eq. (5) then §3.3 pack, flat uint8 out."""
    return pack2bit(ternarize(q, p1, p2, beta))


def ternary_pack_round1_ref(q: torch.Tensor, p0: torch.Tensor,
                            alpha: float) -> torch.Tensor:
    """Round-1 fused-uplink oracle: Eq. (4) then §3.3 pack."""
    return pack2bit(ternarize_round1(q, p0, alpha))


def packed_master_update_ref(q_pilot: torch.Tensor, packed: torch.Tensor,
                             w: torch.Tensor, p1: torch.Tensor,
                             p2: torch.Tensor, t, alpha0: float
                             ) -> torch.Tensor:
    """Eq. (3) over packed codes (N, bytes) uint8, the workers reduced with
    an einsum; both round branches, selected on ``t``."""
    tern = unpack2bit_ref(packed)
    coeff = torch.einsum("n,nm->m", w.float(), tern.float())
    step = (p1 - p2).float()
    t = torch.as_tensor(t, device=q_pilot.device)
    mult = torch.where(t <= 1, torch.full_like(step, alpha0), step)
    return (q_pilot.float() - coeff * mult).to(q_pilot.dtype)


def master_update_ref(q_pilot: torch.Tensor, tern: torch.Tensor,
                      w: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor
                      ) -> torch.Tensor:
    """Eq. (3), t > 1, on flat tensors: tern (N, M) int8, w (N,) the
    weights p_k·beta_k with the pilot's zeroed."""
    coeff = torch.einsum("n,nm->m", w.float(), tern.float())
    step = (p1 - p2).float()
    return (q_pilot.float() - coeff * step).to(q_pilot.dtype)


def packed_master_accum_ref(q_pilot: torch.Tensor, packed: torch.Tensor,
                            w: torch.Tensor, p1: torch.Tensor,
                            p2: torch.Tensor, t, alpha0: float
                            ) -> torch.Tensor:
    """Eq. (3) over packed codes, workers folded strictly in order
    k = 0..N−1 as an FMA-rounded ``w_k·field − w_k``, then one FMA-rounded
    combine.

    ``packed`` (N, bytes) uint8; ``q_pilot``/``p1``/``p2`` flat float of
    ``4·bytes`` scalars; ``mult`` is ``alpha0`` at t <= 1, else p1 − p2.
    """
    m = q_pilot.numel()
    coeff = torch.zeros(m, dtype=torch.float32, device=q_pilot.device)
    for k in range(packed.shape[0]):
        wk = w[k].float()
        fields = unpack2bit(packed[k], m).float() + 1.0
        coeff = coeff + fma_f32(fields, wk, -wk)
    step = (p1 - p2).float().reshape(-1)
    t = torch.as_tensor(t, device=q_pilot.device)
    mult = torch.where(t <= 1, torch.full_like(step, alpha0), step)
    out = fma_f32(-coeff, mult, q_pilot.float().reshape(-1))
    return out.to(q_pilot.dtype).view(q_pilot.shape)
