"""Local-DP ternary randomized response on the 2-bit wire codes.

The natural 3-ary randomized response over the biased fields {0, 1, 2}
(code + 1): with probability ``1 - p`` report the true field, else a
uniform draw from all three. Per round and coordinate this is pure
eps-DP with ``eps = ln((3 - 2p) / p)``.

One uint32 per element decides both: the flip compares its low 16 bits
with a threshold (``PrivacySpec.rr_threshold``, so ``p`` lives on a
1/65536 grid), the replacement is its high 16 bits mod 3. The word is a
counter stream like the pairwise masks: worker ``k``'s word at flat element
``e`` is ``mix32(mix32(e) + rr_key_k)``, with full 32-bit words per element
at either wire modulus. The CUDA uplink draws it in registers from the
(n,) key vector; these functions are the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.privacy.masking import (M16, M32, RR_DOMAIN, as_u64,
                                         index_hash64, mix32_64, stream_key,
                                         to_words)


def rr_stream_key(seed, t, worker_idx, shard_idx=0) -> torch.Tensor:
    """One worker's uint32 RR stream key for (round, shard)."""
    return stream_key(seed, worker_idx, t, shard_idx, domain=RR_DOMAIN)


def rr_stream_keys(seed, t, n: int, shard_idx=0, *, device=None
                   ) -> torch.Tensor:
    """The (n,) per-worker RR key vector of one round, on the device of
    ``t`` (or ``device``)."""
    dev = t.device if isinstance(t, torch.Tensor) else device
    return rr_stream_key(seed, t, torch.arange(n, device=dev), shard_idx)


def rr_bits64(keys: torch.Tensor, size: int) -> torch.Tensor:
    """(n, size) int64 RR words of the workers whose (n,) keys are given."""
    h = index_hash64(size, 32, device=keys.device)
    return mix32_64((h[None, :] + as_u64(keys)[:, None]) & M32)


def rr_bits(seed, t, n: int, shape: tuple, *, device=None) -> torch.Tensor:
    """The cohort's RR word planes, uint32 ``(n, *shape)``."""
    keys = rr_stream_keys(seed, t, n, device=device)
    return to_words(rr_bits64(keys, math.prod(shape)), 32).reshape(
        (n,) + tuple(shape))


def rr_bits_worker(seed, t, worker_idx, shape: tuple, shard_idx=0
                   ) -> torch.Tensor:
    """One worker's RR word plane over its model-shard slab, uint32
    ``shape``: the distributed form, keyed by (round, worker, model
    shard). The stream is a shard's own (its element indices depend on the
    shard count), so meshes with other model axes agree bitwise only with
    DP off."""
    key = torch.as_tensor(rr_stream_key(seed, t, worker_idx, shard_idx))
    return to_words(rr_bits64(key.reshape(1), math.prod(shape))[0],
                    32).reshape(tuple(shape))


def rr_fields64(fields: torch.Tensor, bits: torch.Tensor,
                threshold: int) -> torch.Tensor:
    """:func:`rr_fields` on int64 values."""
    flip = (bits & M16) < threshold
    return torch.where(flip, (bits >> 16) % 3, fields)


def rr_fields(fields: torch.Tensor, bits: torch.Tensor,
              threshold: int) -> torch.Tensor:
    """3-ary RR on uint32 fields {0, 1, 2}: where ``bits & 0xFFFF <
    threshold`` the field becomes ``(bits >> 16) % 3``; threshold 0 is the
    identity. Returns uint32."""
    return to_words(rr_fields64(as_u64(fields), as_u64(bits),
                                int(threshold)), 32)
