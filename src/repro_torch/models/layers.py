"""Primitive layers: init helpers, norms, rotary embeddings (incl. M-RoPE).

The counterpart of the JAX package's ``models/layers.py``. Norms and
rotations compute in float32 and cast back to the input's dtype, as the
reference does. Initializers draw from a ``torch.Generator`` on its own
device, in chunks of at most ``CHUNK`` values so that a large leaf needs
no temporaries of its own size; ``jax.random`` draws other numbers, so a
test that compares with the JAX package carries its weights across
(``repro_torch.convert``). A ``None`` generator draws nothing: the leaves
come out on the ``meta`` device, shapes and dtypes only (the full-size
trees are counted so).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))   # Φ(−2)
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))    # Φ(2)
CHUNK = 1 << 24        # values drawn a call (float64 temporaries: 128 MiB)


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def draw_device(generator) -> torch.device:
    """Where ``generator`` draws: its own device, ``meta`` for ``None``."""
    return torch.device("meta") if generator is None else generator.device


def _fill(out: torch.Tensor, draw) -> torch.Tensor:
    """Fill ``out`` (contiguous) a chunk at a time: ``draw(n)`` gives the
    next ``n`` values in float32 or float64."""
    if out.is_meta:
        return out
    flat = out.view(-1)
    for s in range(0, flat.numel(), CHUNK):
        n = min(CHUNK, flat.numel() - s)
        flat[s:s + n] = draw(n)
    return out


def trunc_normal(generator, shape: tuple, div: float,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A standard normal cut at ±2, divided by ``div``, in ``dtype``.

    Drawn on the generator's device by inverting the normal CDF over
    [Φ(−2), Φ(2)], in float64, a chunk of at most ``CHUNK`` values at a
    time (a leaf of up to ``CHUNK`` values is one draw).
    """
    def draw(n):
        u = torch.rand((n,), generator=generator, device=generator.device,
                       dtype=torch.float64)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * (_LO + u * (_HI - _LO)) - 1.0)
        return (z.clamp(-2.0, 2.0) / div).to(dtype)

    out = torch.empty(shape, dtype=dtype, device=draw_device(generator))
    return _fill(out, draw)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: std ``1/sqrt(d_in)``, cut at ±2 std."""
    return trunc_normal(generator, (d_in, d_out), math.sqrt(d_in), dtype)


def normal_init(generator, shape: tuple, std: float,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal init with std ``std``, drawn in float32."""
    def draw(n):
        return (std * torch.randn((n,), generator=generator,
                                  device=generator.device,
                                  dtype=torch.float32)).to(dtype)

    out = torch.empty(shape, dtype=dtype, device=draw_device(generator))
    return _fill(out, draw)


def uniform_init(generator, shape: tuple, lo: float, hi: float
                 ) -> torch.Tensor:
    """Uniform in [lo, hi), float32."""
    def draw(n):
        return lo + (hi - lo) * torch.rand((n,), generator=generator,
                                           device=generator.device)

    out = torch.empty(shape, dtype=torch.float32,
                      device=draw_device(generator))
    return _fill(out, draw)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal init with std 0.02, drawn in float32."""
    return normal_init(generator, (vocab, d), 0.02, dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(theta, expo)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int → cos/sin (..., head_dim//2) fp32."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, dh); cos/sin (..., S, dh//2) broadcast over heads.

    Rotate-half convention: pairs are (x[..., :half], x[..., half:]).
    """
    half = x.shape[-1] // 2
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: tuple[int, ...]):
    """Qwen2-VL M-RoPE. positions (3, B, S) — temporal/height/width ids.

    The head_dim//2 frequency slots are partitioned into ``sections``
    (t, h, w); each partition rotates by its own position component.
    Returns cos/sin (B, S, head_dim//2).
    """
    if positions.shape[0] != 3 or sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE needs (3, B, S) positions and sections "
                         f"summing to {head_dim // 2}, got "
                         f"{tuple(positions.shape)} and {sections}")
    dev = positions.device
    inv = rope_freqs(head_dim, theta, dev)                   # (half,)
    ang = positions.float()[..., None] * inv                 # (3, B, S, half)
    slot = torch.arange(head_dim // 2, device=dev)           # (half,)
    sec_ids = (slot >= sections[0]).long() + (
        slot >= sections[0] + sections[1]).long()
    picked = sum(torch.where(sec_ids == c, ang[c], 0.0) for c in range(3))
    return torch.cos(picked), torch.sin(picked)


def sinusoidal_at(pos, d: int, device=None) -> torch.Tensor:
    """Sinusoidal embedding at a scalar position (an int or a 0-d tensor,
    read on the device, never on the host) → (d,) fp32."""
    if isinstance(pos, torch.Tensor):
        device = pos.device
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    denom = torch.pow(10000.0, 2 * dim / d)
    ang = (pos.float() if isinstance(pos, torch.Tensor)
           else torch.full((), float(pos), device=device)) / denom
    out = torch.zeros((d,), dtype=torch.float32, device=device)
    out[0::2] = torch.sin(ang)
    out[1::2] = torch.cos(ang)
    return out


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal table (n, d)."""
    pos = np.arange(n)[:, None].astype(np.float64)
    dim = np.arange(d // 2)[None, :].astype(np.float64)
    ang = pos / (10000.0 ** (2 * dim / d))
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out
