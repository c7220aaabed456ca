"""Counter-based random bits with the JAX package's numbers.

The JAX package draws its participation masks with ``jax.random`` (the
default threefry implementation, partitionable). This module computes the
same functions on tensors, so that ``participation_seed=s`` samples the
same workers in both packages:

* ``PRNGKey(s)`` is the pair ``(s >> 32, s & 0xFFFFFFFF)``;
* ``fold_in(k, d)`` is Threefry-2x32 of ``k`` over the one counter pair
  ``(0, d)``;
* ``split(k, n)`` is Threefry-2x32 over the counter pairs ``(0, i)``,
  ``i < n``, each output pair a key;
* ``random_bits32(k, n)`` is ``hi ^ lo`` of Threefry-2x32 over the same
  counters;
* ``permutation(k, n)`` sorts ``arange(n)`` stably by fresh 32-bit keys,
  ``ceil(3·ln n / ln(2³²−1))`` times (one round up to n = 1,625, two
  above), each round keyed by the second half of a ``split``.

A key is a (2,) int64 tensor holding two 32-bit words. Torch on the CPU
has no ``uint32`` add or shift, so every word is an int64 kept below 2³²
by ``& 0xFFFFFFFF``. Everything runs on the key's device with no host
sync: a round index held on the device can key a draw.
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_EXPONENT = 3                        # jax.random._shuffle's sort rounds


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)`` under
    ``key``: int64 words below 2³², any matching shapes."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = (x0 + ks[0]) & _M32
    b = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:   # noqa: N802
    """The key of ``jax.random.PRNGKey(seed)`` for a seed in [0, 2⁶⁴)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``data`` a Python int or a 0-d
    integer tensor (a device round index: no sync)."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    a, b = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([a, b])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key, torch.zeros_like(i), i)
    return torch.stack([a, b], dim=1)


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as int64 words."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key, torch.zeros_like(i), i)
    return a ^ b


def shuffle_rounds(n: int) -> int:
    """How many stable sorts ``jax.random.permutation`` makes of ``n``."""
    return int(math.ceil(_EXPONENT * math.log(max(1, n))
                         / math.log(_M32)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as an int64 tensor."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        order = torch.sort(random_bits32(sub, n), stable=True).indices
        x = x[order]
    return x
