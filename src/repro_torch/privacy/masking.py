"""Pairwise additive masks for secure aggregation — stateless, per-round.

Every unordered worker pair ``(k, l)``, ``k < l``, shares a key; each
round both derive the same mask stream, worker ``k`` adds it and worker
``l`` subtracts it (mod 2**modulus_bits). The net mask of worker ``k`` is

    M_k = sum_{l > k} m_kl - sum_{l < k} m_lk        (mod 2**modulus_bits)

and ``sum_k M_k = 0`` exactly, whatever the order of the sum.

The streams are counter-based: the mask word of pair ``(k, l)`` at flat
element index ``e`` is ``mix32(mix32(e') + key_kl)`` with ``e' = e`` at the
32-bit modulus and ``e' = e >> 1`` at the 16-bit one, where one 32-bit
word feeds two consecutive elements (low half at even ``e``, high at odd).
The CUDA uplink regenerates the streams in registers from the ``(n, n)``
key matrix; the functions here compute the same words in plain PyTorch as
the reference.

Arithmetic: CPU PyTorch has no add, shift or reduction for ``uint16`` /
``uint32``, so every word is computed in ``int64`` holding its unsigned
value and masked with ``& 0xFFFFFFFF`` after each step. A product of two
32-bit values can pass 2**63 and wrap in ``int64``; its low 32 bits, the
only ones kept, are right all the same. Public functions return real
``torch.uint32`` / ``torch.uint16`` tensors, bitwise equal to the JAX
package's ``repro.privacy.masking``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# Domain-separation salts and the per-level mixing constants of the key
# chain (the JAX package's values).
MASK_DOMAIN = 0x9E3779B9
RR_DOMAIN = 0x3C6EF372
FAULT_DOMAIN = 0x94D049BB
RECOVERY_DOMAIN = 0xBF58476D
_SALT_STREAM = 0x85EBCA6B
_SALT_ROUND = 0xC2B2AE35
_SALT_SHARD = 0x27D4EB2F
_SALT_TREE_LEVEL = 0x165667B1

M32 = 0xFFFFFFFF
M16 = 0xFFFF


# -- int64 word arithmetic, shared by the reference and the plain twins ----

def as_u64(x):
    """``x`` as its uint32 value: a Python int stays one, a tensor becomes
    ``int64`` (uint16/uint32 words read as unsigned, signed values wrap as
    ``jnp.asarray(x, jnp.uint32)`` wraps them)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).to(torch.int64) & M32
        if x.dtype == torch.uint16:
            return x.view(torch.int16).to(torch.int64) & M16
        return x.to(torch.int64) & M32
    return int(x) & M32


def word_bits_of(words: torch.Tensor) -> int:
    """The modulus a wire-word tensor carries: 16 (uint16) or 32 (uint32)."""
    if words.dtype == torch.uint16:
        return 16
    if words.dtype == torch.uint32:
        return 32
    raise ValueError(f"wire words must be uint16 or uint32, got "
                     f"{words.dtype}")


def to_words(x: torch.Tensor, word_bits: int) -> torch.Tensor:
    """int64 values → ``torch.uint16`` / ``torch.uint32`` words, keeping
    the low ``word_bits`` bits (through the signed type of the same width,
    whose casts every backend has)."""
    if word_bits == 16:
        x = x & M16
        return torch.where(x >= 1 << 15, x - (1 << 16), x).to(
            torch.int16).view(torch.uint16)
    x = x & M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(
        torch.int32).view(torch.uint32)


def mix32_64(x):
    """The lowbias32 finalizer on int64 tensors or Python ints holding
    uint32 values; the result is such a value too."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32      # may wrap int64; low 32 bits are exact
    return x ^ (x >> 16)


def _as_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), x, dtype=torch.int64, device=device)


def _device(*xs, device=None) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu") if device is None else torch.device(device)


def key64(seed, stream_id, t, shard_idx=0, *, domain: int = MASK_DOMAIN):
    """:func:`stream_key` on int64 values (tensors broadcast)."""
    k = mix32_64(as_u64(seed) ^ domain)
    k = mix32_64((k + as_u64(stream_id) * _SALT_STREAM) & M32)
    k = mix32_64((k + as_u64(t) * _SALT_ROUND) & M32)
    return mix32_64((k + as_u64(shard_idx) * _SALT_SHARD) & M32)


def index_hash64(size: int, word_bits: int, base: int = 0, *,
                 device=None) -> torch.Tensor:
    """:func:`index_hash` as int64 values."""
    if word_bits == 16:
        e = torch.arange(size // 2, dtype=torch.int64, device=device)
        return mix32_64((base // 2 + e) & M32)
    e = torch.arange(size, dtype=torch.int64, device=device)
    return mix32_64((base + e) & M32)


def halves16_64(u: torch.Tensor) -> torch.Tensor:
    """:func:`halves16` on int64 values."""
    return torch.stack([u & M16, u >> 16], dim=-1).reshape(
        u.shape[:-1] + (2 * u.shape[-1],))


# -- the JAX package's functions --------------------------------------------

def mix32(x) -> torch.Tensor:
    """The lowbias32 finalizer, uint32 → uint32."""
    return to_words(_as_tensor(mix32_64(as_u64(x))), 32)


def stream_key(seed, stream_id, t, shard_idx=0, *,
               domain: int = MASK_DOMAIN, device=None) -> torch.Tensor:
    """Per-(stream, round, shard) uint32 key of a counter stream. Any
    input may be a tensor (the device round index ``t`` among them);
    tensors broadcast and fix the result's device."""
    dev = _device(seed, stream_id, t, shard_idx, device=device)
    k = key64(seed, stream_id, t, shard_idx, domain=domain)
    return to_words(_as_tensor(k, dev), 32)


def mask_stream(key, hashed_idx) -> torch.Tensor:
    """Stream word(s) at pre-hashed counter(s): ``mix32(mix32(e) + key)``."""
    dev = _device(key, hashed_idx)
    u = mix32_64((as_u64(hashed_idx) + as_u64(key)) & M32)
    return to_words(_as_tensor(u, dev), 32)


def halves16(u: torch.Tensor) -> torch.Tensor:
    """The 16-bit halves of uint32 words interleaved along the last axis,
    low half first: (..., w) → (..., 2w) uint32 values below 2**16."""
    return to_words(halves16_64(as_u64(u)), 32)


def stream_values(key, hashed_idx, word_bits: int) -> torch.Tensor:
    """Mask values of one stream as uint32: full words at 32 bits,
    interleaved 16-bit halves at 16 (``hashed_idx`` then holds
    ``mix32(e >> 1)`` over half the elements)."""
    u = mask_stream(key, hashed_idx)
    return halves16(u) if word_bits == 16 else u


def index_hash(size: int, word_bits: int, base: int = 0, *,
               device=None) -> torch.Tensor:
    """The counter hash of elements ``[base, base + size)``: ``mix32(e)``
    per element at 32 bits, ``mix32(e >> 1)`` per element pair at 16
    (``base`` even; ``size // 2`` entries)."""
    return to_words(index_hash64(size, word_bits, base, device=device), 32)


def pair_index(i, j, n: int):
    """Symmetric id ``min·n + max`` of the unordered pair {i, j}."""
    if isinstance(i, torch.Tensor) or isinstance(j, torch.Tensor):
        i, j = torch.as_tensor(i), torch.as_tensor(j)
        return torch.minimum(i, j) * n + torch.maximum(i, j)
    return min(i, j) * n + max(i, j)


def pair_incidence(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(C, i_idx, j_idx)``: the (n, P) signed incidence matrix of the
    pairs ``i < j`` (+1 at the lower endpoint, −1 at the upper) and the
    (P,) endpoints."""
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    c = np.zeros((n, len(pairs)), np.int32)
    for col, (i, j) in enumerate(pairs):
        c[i, col] = 1
        c[j, col] = -1
    i_idx = np.asarray([i for i, _ in pairs], np.int32)
    j_idx = np.asarray([j for _, j in pairs], np.int32)
    return c, i_idx, j_idx


def pair_stream_keys(seed, n: int, t, shard_idx=0, *, device=None
                     ) -> torch.Tensor:
    """The (n, n) symmetric uint32 matrix of round ``t``'s pair keys (the
    diagonal is derived, and its sign is always 0), built on the device of
    ``t`` (or ``device``) from ``arange``: no host copy, no sync."""
    dev = _device(t, device=device)
    idx = torch.arange(n, device=dev)
    pid = pair_index(idx[:, None], idx[None, :], n)
    return to_words(key64(seed, pid, t, shard_idx), 32)


def pair_signs(n: int, *, participation=None, device=None) -> torch.Tensor:
    """The (n, n) antisymmetric int32 sign matrix: +1 where ``i < j``, −1
    where ``i > j``, 0 on the diagonal; with ``participation`` a pair is
    active only when both endpoints are sampled."""
    dev = _device(participation, device=device)
    idx = torch.arange(n, device=dev)
    i, j = idx[:, None], idx[None, :]
    signs = (i < j).to(torch.int32) - (i > j).to(torch.int32)
    if participation is not None:
        m = (torch.as_tensor(participation, device=dev) > 0).to(torch.int32)
        signs = signs * (m[:, None] * m[None, :])
    return signs


def tree_level_seed(seed: int, level: int) -> int:
    """Mask seed of tree level ``level`` (0 = the leaves) as its uint32
    value: level 0 keeps the root seed, every higher level mixes a level
    salt, ``mix32(seed + level·SALT mod 2**32)``, so a level's pair
    streams are independent of the leaves' with the same pair id."""
    if level == 0:
        return as_u64(seed)
    return mix32_64((as_u64(seed) + level * _SALT_TREE_LEVEL) & M32)


def tree_pair_signs(n: int, sibling: int, *, participation=None,
                    device=None) -> torch.Tensor:
    """:func:`pair_signs` scoped to contiguous sibling groups of size
    ``sibling``: a pair's masks are active only when both endpoints share
    a parent (``i // sibling == j // sibling``), so each node's net mask
    cancels inside its parent's partial sum."""
    signs = pair_signs(n, participation=participation, device=device)
    idx = torch.arange(n, device=signs.device)
    same = (idx[:, None] // sibling) == (idx[None, :] // sibling)
    return signs * same.to(torch.int32)


def tree_activity(mask, fanout: int) -> torch.Tensor:
    """Fold a (w,) participation/activity mask one tree level up: a node
    is active iff any of its (at most ``fanout``) children is. Returns
    (ceil(w / fanout),) float32 0/1."""
    m = (torch.as_tensor(mask) > 0).to(torch.float32)
    w = m.shape[0]
    g = -(-w // fanout)
    m = torch.nn.functional.pad(m, (0, g * fanout - w))
    return m.view(g, fanout).amax(dim=1)


def net_words64(keys: torch.Tensor, signs: torch.Tensor, size: int,
                word_bits: int) -> torch.Tensor:
    """(K, size) int64 signed stream sums ``Σ_l signs[k, l]·stream(keys[k,
    l])`` (before the modulus) over elements ``[0, size)``, lane by lane of
    the (K, L) key matrix as the kernels fold them: every worker's net mask
    in the masked uplink, a tree node's in the partial sum, the repair term
    (K = 1, coefficients for signs)."""
    k, lanes = keys.shape
    keys64 = as_u64(keys)
    signs64 = signs.to(torch.int64)
    h = index_hash64(size if word_bits == 32 else 2 * ((size + 1) // 2),
                     word_bits, device=keys.device)
    acc = torch.zeros((k, size), dtype=torch.int64, device=keys.device)
    for lane in range(lanes):
        u = mix32_64((h[None, :] + keys64[:, lane, None]) & M32)
        if word_bits == 16:
            u = halves16_64(u)
        acc += signs64[:, lane, None] * u[:, :size]
    return acc


def net_masks(seed, n: int, t, shape: tuple, *, word_bits: int = 32,
              participation=None, shard_idx=0, device=None) -> torch.Tensor:
    """Every worker's net mask of round ``t``, ``(n, *shape)`` in the wire
    dtype, summing to zero mod 2**word_bits over the active workers
    (non-participants get 0). The reference of the in-kernel streams.

    It accumulates pair by pair in int64, so only one pair's stream and
    the (n, size) sum are ever held: it fits at a full model's size.
    """
    dev = _device(t, participation, device=device)
    size = math.prod(shape)
    total = torch.zeros((n, size), dtype=torch.int64, device=dev)
    if n >= 2:
        h = index_hash64(size if word_bits == 32 else 2 * ((size + 1) // 2),
                         word_bits, device=dev)
        active = None
        if participation is not None:
            active = (torch.as_tensor(participation, device=dev) > 0).to(
                torch.int64)
        for i in range(n):
            for j in range(i + 1, n):
                key = key64(seed, i * n + j, t, shard_idx)
                vals = mix32_64((h + key) & M32)
                if word_bits == 16:
                    vals = halves16_64(vals)
                vals = vals[:size]
                if active is not None:
                    vals = vals * (active[i] * active[j])
                total[i] += vals
                total[j] -= vals
    return to_words(total, word_bits).reshape((n,) + tuple(shape))


def quantize_weights(w: torch.Tensor, fixpoint_bits: int) -> torch.Tensor:
    """Public Eq. (3) weights → uint32 fixed point ``round(w·2**bits)``,
    ties to even as ``jnp.round``."""
    scale = float(1 << fixpoint_bits)
    wq = torch.round(w.to(torch.float32) * scale).to(torch.int64)
    return to_words(wq, 32)
