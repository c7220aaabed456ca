"""Bonawitz-style dropout recovery: seed secret-sharing and mask repair.

The pairwise masks cancel only over the set they were derived for. A
worker that dies after committing its masked uplink (or whose uplink never
arrives) leaves the aggregate, but each surviving sibling ``l`` already
folded ``sign(l, k)·m_kl`` into its words, so the survivors' modular sum
carries the dead worker's uncancelled masks. Both halves of the fix:

* **Control plane — Shamir shares of the pair seeds** (host, numpy). Each
  worker's row of pair stream keys, restricted to its sibling group, is
  dealt as t-of-n Shamir shares over GF(2^16) to its siblings; after a
  death any ``threshold`` survivors reconstruct the dead worker's keys
  (:func:`recover_worker_keys`), and reconstructing a live worker's raises
  :class:`~repro_torch.core.privacy.LeakageError`. The reconstructed keys
  equal the ``pair_stream_keys`` row bitwise, which is what lets the round
  use the derived keys directly.

* **Data plane — the repair term** (device tensors, no host sync).
  Dropping dead rows leaves ``-Σ_{l alive} sign(k, l)·m_kl`` in the
  survivors; the repair adds ``Σ_{k dead, l alive} sign(k, l)·m_kl`` mod
  2**modulus_bits once, at the root (``kernels.masked_wire.mask_repair``).
  :func:`effective_masks` applies the graceful-degradation rule: a sibling
  group that suffered a death and kept fewer than ``threshold`` survivors
  cannot reconstruct, so the whole group is zeroed.

A copy of the JAX package's ``repro.privacy.recovery``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.privacy import audit as pv_audit
from repro_torch.privacy import masking as pvm

GF_BITS = 16
GF_ORDER = 1 << GF_BITS
#: x^16 + x^12 + x^3 + x + 1, primitive over GF(2): GF(2^16) symbols are
#: uint16 words.
GF_POLY = 0x1100B


def _gf_mul_scalar(a: int, b: int) -> int:
    """Carryless multiply mod GF_POLY (table building only)."""
    r = 0
    for _ in range(GF_BITS):
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & GF_ORDER:
            a ^= GF_POLY
    return r


@functools.lru_cache(maxsize=1)
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(exp, log) discrete-log tables of GF(2^16)*; the generator is found
    by search (its period checked), ``exp`` doubled so products index
    without a mod."""
    for g in (2, 3, 5, 7):
        exp = np.zeros(2 * (GF_ORDER - 1), np.uint32)
        log = np.zeros(GF_ORDER, np.uint32)
        x, period = 1, 0
        for i in range(GF_ORDER - 1):
            exp[i] = x
            log[x] = i
            x = _gf_mul_scalar(x, g)
            period = i + 1
            if x == 1:
                break
        if period == GF_ORDER - 1:
            exp[GF_ORDER - 1:] = exp[:GF_ORDER - 1]
            return exp, log
    raise AssertionError(f"no primitive element found for poly {GF_POLY:#x}")


def gf_mul(a, b) -> np.ndarray:
    """Elementwise GF(2^16) product (zero-absorbing)."""
    exp, log = _tables()
    a = np.asarray(a, np.uint32) & 0xFFFF
    b = np.asarray(b, np.uint32) & 0xFFFF
    out = exp[log[a].astype(np.int64) + log[b].astype(np.int64)]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint32)


def gf_inv(a) -> np.ndarray:
    """Elementwise GF(2^16) inverse; raises on zero."""
    exp, log = _tables()
    a = np.asarray(a, np.uint32) & 0xFFFF
    if np.any(a == 0):
        raise ZeroDivisionError("gf_inv(0)")
    return exp[GF_ORDER - 1 - log[a].astype(np.int64)].astype(np.uint32)


def _mix32_np(x) -> np.ndarray:
    """lowbias32 on numpy words (``masking.mix32``'s bits)."""
    x = np.asarray(x, np.uint64) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x.astype(np.uint32)


def _share_coeffs(seed, worker, t, degree: int, size: int) -> np.ndarray:
    """Deterministic Shamir coefficients (uint16 symbols) of ``worker``'s
    round-``t`` dealing, from a RECOVERY_DOMAIN mix32 chain."""
    k = _mix32_np(np.uint64(int(seed) & 0xFFFFFFFF)
                  ^ np.uint64(pvm.RECOVERY_DOMAIN))
    k = _mix32_np(k.astype(np.uint64) + np.uint64(int(worker))
                  * np.uint64(pvm._SALT_STREAM))
    k = _mix32_np(k.astype(np.uint64) + np.uint64(int(t) & 0xFFFFFFFF)
                  * np.uint64(pvm._SALT_ROUND))
    k = _mix32_np(k.astype(np.uint64) + np.uint64(degree)
                  * np.uint64(pvm._SALT_SHARD))
    idx = np.arange(size, dtype=np.uint64)
    return (_mix32_np(k.astype(np.uint64) + idx) & 0xFFFF).astype(np.uint32)


def deal_shares(secret, n_shares: int, threshold: int, *,
                coeffs=None) -> np.ndarray:
    """t-of-n Shamir shares of uint16 symbols over GF(2^16): share ``j``
    (at ``x = j + 1``) is the degree-(threshold-1) polynomial through the
    secret at ``x = 0``; ``coeffs`` pins the ``threshold - 1``
    non-constant coefficient planes. Returns ``(n_shares, *secret.shape)``
    uint16."""
    if threshold < 1:
        raise ValueError(f"threshold must be >= 1, got {threshold}")
    if n_shares < threshold:
        raise ValueError(f"cannot deal {n_shares} shares at threshold "
                         f"{threshold}")
    secret = np.asarray(secret, np.uint32) & 0xFFFF
    if coeffs is None:
        coeffs = [_share_coeffs(0, 0, 0, d, secret.size).reshape(secret.shape)
                  for d in range(1, threshold)]
    out = np.zeros((n_shares,) + secret.shape, np.uint32)
    for j in range(n_shares):
        x = np.uint32(j + 1)
        acc = secret.copy()
        xp = np.uint32(1)
        for c in coeffs:
            xp = gf_mul(xp, x)
            acc ^= gf_mul(np.asarray(c, np.uint32) & 0xFFFF, xp)
        out[j] = acc
    return out.astype(np.uint16)


def reconstruct(shares, xs) -> np.ndarray:
    """Lagrange-interpolate the secret at ``x = 0`` from ``(m, ...)``
    shares held at the distinct 1-based points ``xs``."""
    shares = np.asarray(shares, np.uint32) & 0xFFFF
    xs = np.asarray(xs, np.uint32) & 0xFFFF
    if len(set(int(x) for x in xs)) != xs.shape[0]:
        raise ValueError("share points must be distinct")
    out = np.zeros(shares.shape[1:], np.uint32)
    for j in range(xs.shape[0]):
        lj = np.uint32(1)
        for i in range(xs.shape[0]):
            if i == j:
                continue
            # l_j(0) = prod x_i / (x_i - x_j); subtraction is XOR in GF(2^k)
            lj = gf_mul(lj, gf_mul(xs[i], gf_inv(xs[i] ^ xs[j])))
        out ^= gf_mul(shares[j], lj)
    return out.astype(np.uint16)


# -- worker-level dealing and reconstruction (control plane, host) ----------

def group_members(worker: int, n: int, group_size: int | None) -> np.ndarray:
    """``worker``'s sibling group: its contiguous ``group_size`` block, or
    the whole cohort when ``group_size`` is None (the flat wire)."""
    if group_size is None:
        return np.arange(n, dtype=np.int32)
    lo = worker // group_size * group_size
    return np.arange(lo, min(lo + group_size, n), dtype=np.int32)


def worker_pair_symbols(seed, worker: int, n: int, t, *,
                        group_size: int | None = None,
                        shard_idx: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(members, symbols): ``worker``'s round-``t`` pair stream keys toward
    its sibling group, each uint32 key split into two GF(2^16) symbols
    (low half first), ``(s, 2)`` uint16."""
    members = group_members(worker, n, group_size)
    keys = pvm.as_u64(pvm.pair_stream_keys(seed, n, t, shard_idx,
                                           device="cpu")).numpy()
    row = keys[worker][members]
    sym = np.stack([row & 0xFFFF, row >> 16], axis=-1).astype(np.uint16)
    return members, sym


def deal_worker_shares(seed, worker: int, n: int, t, threshold: int, *,
                       group_size: int | None = None, shard_idx: int = 0
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deal ``worker``'s pair-key secret to its sibling group: returns
    ``(members, xs, shares)``, ``shares[j]`` ((s, 2) uint16) held by
    ``members[j]`` at ``xs[j] = j + 1``. The coefficients chain from
    (seed, worker, round, degree), so a re-dealt round gives the same
    shares."""
    members, sym = worker_pair_symbols(seed, worker, n, t,
                                       group_size=group_size,
                                       shard_idx=shard_idx)
    s = members.shape[0]
    if threshold > s:
        raise ValueError(f"threshold {threshold} exceeds sibling group "
                         f"size {s}")
    coeffs = [_share_coeffs(seed, worker, t, d, sym.size).reshape(sym.shape)
              for d in range(1, threshold)]
    shares = deal_shares(sym, s, threshold, coeffs=coeffs)
    xs = np.arange(1, s + 1, dtype=np.uint16)
    return members, xs, shares


def recover_worker_keys(seed, worker: int, n: int, t, threshold: int, *,
                        alive, group_size: int | None = None,
                        shard_idx: int = 0
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Reconstruct a dead worker's within-group pair keys from the shares
    of ``threshold`` surviving siblings: ``(members, keys)``, keys (s,)
    uint32.

    Raises :class:`~repro_torch.core.privacy.LeakageError` when ``alive``
    marks the target live, and :class:`ValueError` when fewer than
    ``threshold`` siblings survive (the group then degrades to a zero
    subtree, :func:`effective_masks`)."""
    pv_audit.check_recovery_target(worker, alive)
    members, xs, shares = deal_worker_shares(seed, worker, n, t, threshold,
                                             group_size=group_size,
                                             shard_idx=shard_idx)
    alive = np.asarray(alive)
    holders = [j for j, m in enumerate(members)
               if int(m) != int(worker) and alive[int(m)] > 0]
    if len(holders) < threshold:
        raise ValueError(
            f"sibling group of worker {worker} fell below threshold: "
            f"{len(holders)} surviving share-holders < {threshold}")
    sel = np.asarray(holders[:threshold])
    sym = reconstruct(shares[sel], xs[sel]).astype(np.uint32)
    keys = (sym[..., 0] | (sym[..., 1] << 16)).astype(np.uint32)
    return members, keys


# -- the repair's device operands (data plane) -------------------------------

def effective_masks(pmask, alive: torch.Tensor, threshold: int,
                    group_size: int | None, n: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Post-fault activity split ``(alive_eff, dead_eff)``, (n,) float32 on
    ``alive``'s device: workers that participated and survived, and the
    participants that died. Both are zeroed over every sibling group that
    suffered a death and kept fewer than ``threshold`` survivors (its
    keys cannot be reconstructed, so the subtree contributes exact zero);
    a group without deaths is viable whatever its size."""
    av = alive > 0
    pm = (torch.ones((n,), dtype=torch.bool, device=alive.device)
          if pmask is None else torch.as_tensor(pmask, device=alive.device)
          > 0)
    live = (pm & av).to(torch.int32)
    dead = (pm & ~av).to(torch.int32)
    g = n if group_size is None else group_size
    ng = -(-n // g)
    pad = ng * g - n
    lp = torch.nn.functional.pad(live, (0, pad)).view(ng, g)
    dp = torch.nn.functional.pad(dead, (0, pad)).view(ng, g)
    viable = (dp.sum(1) == 0) | (lp.sum(1) >= threshold)
    v = viable[:, None].expand(ng, g).reshape(-1)[:n].to(torch.int32)
    return (live * v).to(torch.float32), (dead * v).to(torch.float32)


@functools.lru_cache(maxsize=64)
def repair_pair_index(n: int, sibling: int | None = None, device=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Endpoints of the pairs a repair can touch, ``i`` major, as (P,)
    int64 tensors on ``device`` (None = the CPU): all unordered pairs
    (flat wire) or only the pairs inside one sibling group of ``sibling``
    (tree leaves). Made on the device (one ``triu_indices`` a group, no
    host copy), once per (n, sibling, device)."""
    g = n if sibling is None else sibling
    parts = [torch.triu_indices(min(g, n - lo), min(g, n - lo), 1,
                                device=device) + lo
             for lo in range(0, n, g)]
    ij = torch.cat(parts, dim=1)
    return ij[0], ij[1]


def repair_coefficients(keys_mat: torch.Tensor, signs_mat: torch.Tensor,
                        alive_eff: torch.Tensor, dead_eff: torch.Tensor,
                        i_idx: torch.Tensor, j_idx: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pair ``((P,) uint32 keys, (P,) int32 coefficients)`` of the
    repair term ``Σ_{k dead, l alive} sign(k, l)·m_kl``.

    ``signs_mat`` is the sign matrix the uplink committed (flat or
    tree-scoped); the unordered pair {i, j} contributes through whichever
    endpoint died, so its coefficient is ``C[i, j] + C[j, i]`` with
    ``C = signs·(dead ⊗ alive)``, in {-1, 0, +1}. ``i_idx``/``j_idx``
    are :func:`repair_pair_index`'s, on the keys' device."""
    a = (alive_eff > 0).to(torch.int32)
    d = (dead_eff > 0).to(torch.int32)
    c = signs_mat.to(torch.int32) * (d[:, None] * a[None, :])
    coeff_mat = c + c.T
    keys = keys_mat.view(torch.int32)[i_idx, j_idx].view(torch.uint32)
    return keys, coeff_mat[i_idx, j_idx]


def mask_repair_ref(words: torch.Tensor, pair_keys: torch.Tensor,
                    pair_coeff: torch.Tensor, *, word_bits: int
                    ) -> torch.Tensor:
    """Oracle of the repair kernel: ``words + Σ_p coeff[p]·stream(keys[p])``
    mod 2**word_bits over one (rows, 512) word slab (flat element index
    ``r·512 + c``)."""
    rep = pvm.net_words64(pair_keys.reshape(1, -1), pair_coeff.reshape(1, -1),
                          words.numel(), word_bits)[0]
    out = pvm.as_u64(words).reshape(-1) + rep
    return pvm.to_words(out, word_bits).view(words.shape)
