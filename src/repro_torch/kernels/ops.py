"""Wrappers of the wire kernels over the flat ``(rows, 128)`` buffers.

They make the kernel views (``(rows, 128)`` ↔ ``(rows // 4, 512)`` float,
``(rows // 4, 128)`` uint8, ``(rows // 4, 512)`` masked words), put the
round index and the per-worker thresholds on the buffers' device without
a host copy, and call ``kernels.fused_wire``, ``kernels.masked_wire``
or ``kernels.partial_sum``. The kernels pick a fixed launch shape.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_wire as fw
from repro_torch.kernels import masked_wire as mw
from repro_torch.kernels import partial_sum as ps
from repro_torch.privacy.masking import as_u64, to_words

LANES = fw.LANES
PACK = fw.PACK


def _device_scalar(x, dtype: torch.dtype, device: torch.device,
                   what: str) -> torch.Tensor:
    """``x`` as a 0-d ``dtype`` tensor on ``device``. A tensor already
    there is used as it is, so a device scalar never syncs."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"{what} is on {x.device}, buffers on {device}")
        return x.to(dtype).reshape(())
    return torch.full((), int(x), dtype=dtype, device=device)


def round_index(t, device: torch.device) -> torch.Tensor:
    """The 1-based round as a 0-d int32 tensor on ``device``."""
    return _device_scalar(t, torch.int32, device, "round index")


def pilot_index(k_star, device: torch.device) -> torch.Tensor:
    """The pilot's worker index as a 0-d int64 tensor on ``device``."""
    return _device_scalar(k_star, torch.int64, device, "pilot index")


def per_worker(beta, n: int, device: torch.device) -> torch.Tensor:
    """A shared scalar or an (N,) vector of beta_k as an (N,) float32
    tensor on ``device``."""
    if isinstance(beta, torch.Tensor):
        if beta.device != device:
            raise ValueError(f"beta is on {beta.device}, buffers on {device}")
        return beta.to(torch.float32).reshape(-1).expand(n).contiguous()
    return torch.full((n,), float(beta), dtype=torch.float32, device=device)


def flat_ternary_pack_stacked(bufs_q: torch.Tensor, buf_p1: torch.Tensor,
                              buf_p2: torch.Tensor, *, t, beta,
                              alpha1: float) -> torch.Tensor:
    """Batched uplink: (N, rows, 128) worker buffers → (N, rows//4, 128)
    packed wire buffers in one launch. ``t`` may be a device tensor;
    ``beta`` is a shared scalar or a per-worker (N,) vector."""
    n, rows, _ = bufs_q.shape
    r4 = rows // PACK
    dev = bufs_q.device
    return fw.ternary_pack_stacked(
        bufs_q.reshape(n, r4, fw.WIDE), buf_p1.reshape(r4, fw.WIDE),
        buf_p2.reshape(r4, fw.WIDE), round_index(t, dev),
        per_worker(beta, n, dev), alpha1)


def flat_master_update(bufs_q: torch.Tensor, k_star,
                       packed_stacked: torch.Tensor, w: torch.Tensor,
                       buf_p1: torch.Tensor, buf_p2: torch.Tensor, *, t,
                       alpha0: float) -> torch.Tensor:
    """Fused Eq. (3) over all N packed wire buffers: bufs_q (N, rows, 128)
    float32, whose pilot row ``k_star`` (a device tensor or an int) the
    kernel reads in place; buf_p* (rows, 128) float32; packed_stacked
    (N, rows//4, 128) uint8; w (N,) weights with the pilot zeroed.
    Returns the new global (rows, 128) buffer."""
    n, rows, _ = bufs_q.shape
    r4 = rows // PACK
    dev = bufs_q.device
    out = fw.packed_master_update(
        bufs_q.reshape(n, r4, fw.WIDE), pilot_index(k_star, dev),
        packed_stacked, w.to(torch.float32), buf_p1.reshape(r4, fw.WIDE),
        buf_p2.reshape(r4, fw.WIDE), round_index(t, dev), alpha0)
    return out.reshape(rows, LANES)


def flat_ternary_pack_masked(bufs_q: torch.Tensor, buf_p1: torch.Tensor,
                             buf_p2: torch.Tensor, *, t, beta, alpha1: float,
                             wq: torch.Tensor, pair_keys: torch.Tensor,
                             pair_signs: torch.Tensor, rr_keys: torch.Tensor,
                             rr_threshold: int = 0, word_bits: int = 32,
                             use_masks: bool = True) -> torch.Tensor:
    """Masked (secure-agg) uplink: (N, rows, 128) worker buffers →
    (N, rows//4, 512) wire words (uint16 at ``word_bits=16``, else
    uint32) in one launch.

    ``wq`` (N,) uint32 fixed-point Eq. (3) weights; ``pair_keys`` (N, L)
    uint32 and ``pair_signs`` (N, L) int32 the pair stream keys and
    participation-folded signs (``privacy.masking.pair_stream_keys`` /
    ``pair_signs``); ``rr_keys`` (N,) uint32 RR keys; ``rr_threshold`` the
    uint16 flip threshold (0 = DP off); ``use_masks=False`` adds no mask.
    ``t`` may be a device tensor; ``beta`` a shared scalar or an (N,)
    vector.
    """
    n, rows, _ = bufs_q.shape
    r4 = rows // PACK
    dev = bufs_q.device
    return mw.ternary_pack_masked(
        bufs_q.reshape(n, r4, fw.WIDE), buf_p1.reshape(r4, fw.WIDE),
        buf_p2.reshape(r4, fw.WIDE), round_index(t, dev),
        per_worker(beta, n, dev), alpha1, wq.contiguous(),
        pair_keys.contiguous(), pair_signs.contiguous(),
        rr_keys.contiguous(), rr_threshold=rr_threshold,
        word_bits=word_bits, use_masks=use_masks)


def word_scalar(x, device: torch.device) -> torch.Tensor:
    """An int, or an integer tensor already on ``device``, as a 0-d
    uint32 tensor there (its value mod 2**32), with no host copy."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"scalar is on {x.device}, buffers on {device}")
        return to_words(as_u64(x), 32).reshape(())
    return to_words(torch.full((), as_u64(x), dtype=torch.int64,
                               device=device), 32)


def flat_masked_master_update(bufs_q: torch.Tensor, k_star,
                              masked: torch.Tensor, sum_wq,
                              buf_p1: torch.Tensor, buf_p2: torch.Tensor, *,
                              t, alpha0: float, scale_mult: float
                              ) -> torch.Tensor:
    """Sum-then-unmask Eq. (3) over the masked wire words: bufs_q
    (N, rows, 128) float32, whose pilot row ``k_star`` the kernel reads in
    place; masked (C, rows//4, 512) uint16/uint32, any C >= 1 (the N
    workers' words, or a tree's last-level partials); ``sum_wq`` the public
    Σ_k W_k (a device tensor or an int); ``scale_mult`` the fixed-point
    descale with the RR unbias folded in. Returns the new global
    (rows, 128) buffer."""
    n, rows, _ = bufs_q.shape
    r4 = rows // PACK
    dev = bufs_q.device
    out = mw.masked_master_update(
        bufs_q.reshape(n, r4, fw.WIDE), pilot_index(k_star, dev), masked,
        word_scalar(sum_wq, dev), buf_p1.reshape(r4, fw.WIDE),
        buf_p2.reshape(r4, fw.WIDE), round_index(t, dev), alpha0,
        scale_mult)
    return out.reshape(rows, LANES)


def flat_mask_repair(words: torch.Tensor, pair_keys: torch.Tensor,
                     pair_coeff: torch.Tensor) -> torch.Tensor:
    """Dropout repair over one masked-word slab (kernel view): a new
    (rows//4, 512) buffer ``words + Σ_p coeff[p]·stream(keys[p])`` mod
    2**modulus_bits in one launch (none for P = 0). ``pair_keys`` (P,)
    uint32 and ``pair_coeff`` (P,) int32 come from
    ``privacy.recovery.repair_coefficients``; the kernel skips the pairs
    whose coefficient is 0."""
    return mw.mask_repair(words, pair_keys.contiguous(),
                          pair_coeff.to(torch.int32).contiguous())


def flat_partial_sum(packed: torch.Tensor, wq: torch.Tensor, *, fanout: int,
                     word_bits: int = 32) -> torch.Tensor:
    """Leaf-level tree sub-aggregate over the packed wire: (C, rows//4,
    128) uint8 children + (C,) uint32 fixed-point weights →
    (ceil(C / fanout), rows//4, 512) word partials, one launch. The ragged
    last group folds only the children that exist."""
    return ps.partial_sum(packed, wq.contiguous(), fanout=fanout,
                          word_bits=word_bits)


def flat_masked_partial_sum(words: torch.Tensor, keys: torch.Tensor,
                            signs: torch.Tensor, *, fanout: int,
                            sibling: int, use_masks: bool = True
                            ) -> torch.Tensor:
    """Interior tree sub-aggregate over word partials: (C, rows//4, 512)
    children → (ceil(C / fanout), rows//4, 512) parents in the same wire
    dtype, each parent's own sibling-scoped net mask added in the kernel
    from the level's (G, G) ``keys``/``signs``."""
    return ps.masked_partial_sum(words, keys.contiguous(),
                                 signs.contiguous(), fanout=fanout,
                                 sibling=sibling, use_masks=use_masks)
