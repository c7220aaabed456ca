"""Initializers of the port's models."""
from __future__ import annotations

import math

import torch

_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))   # Φ(−2)
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))    # Φ(2)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: std ``1/sqrt(d_in)``, cut at ±2 std.

    Drawn on the generator's device by inverting the normal CDF over
    [Φ(−2), Φ(2)]. ``jax.random`` draws other numbers from the same seed,
    so tests that compare with the JAX package carry its weights across
    (``repro_torch.convert``).
    """
    u = torch.rand((d_in, d_out), generator=generator,
                   device=generator.device, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (_LO + u * (_HI - _LO)) - 1.0)
    return (z.clamp(-2.0, 2.0) / math.sqrt(d_in)).to(dtype)
