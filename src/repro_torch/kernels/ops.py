"""Wrappers of the wire kernels over the flat ``(rows, 128)`` buffers and
over tensors of any shape.

They make the kernel views (``(rows, 128)`` ↔ ``(rows // 4, 512)`` float,
``(rows // 4, 128)`` uint8, ``(rows // 4, 512)`` masked words), put the
round index and the per-worker thresholds on the buffers' device without
a host copy, and call ``kernels.fused_wire``, ``kernels.masked_wire``,
``kernels.partial_sum``, ``kernels.ternary_encode``, ``kernels.pack2bit``
or ``kernels.master_update``. The arbitrary-shape functions
(``ternary_encode`` … ``master_update``) zero-pad their operands to rows
that are a multiple of 8, as the JAX package's ``ops`` do, and cut the
result back to ``n`` codes or ``ceil(n / 4)`` bytes. The kernels pick a
fixed launch shape.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import fused_wire as fw
from repro_torch.kernels import master_update as mu
from repro_torch.kernels import masked_wire as mw
from repro_torch.kernels import pack2bit as pk
from repro_torch.kernels import partial_sum as ps
from repro_torch.kernels import ternary_encode as te
from repro_torch.privacy.masking import as_u64, to_words
from repro_torch.utils import cdiv, round_up

LANES = fw.LANES
PACK = fw.PACK
ROW_MULTIPLE = 8


def _device_scalar(x, dtype: torch.dtype, device: torch.device,
                   what: str) -> torch.Tensor:
    """``x`` as a 0-d ``dtype`` tensor on ``device``. A tensor already
    there is used as it is, so a device scalar never syncs."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"{what} is on {x.device}, buffers on {device}")
        return x.to(dtype).reshape(())
    value = float(x) if dtype.is_floating_point else int(x)
    return torch.full((), value, dtype=dtype, device=device)


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


def _to_2d(x: torch.Tensor, row_multiple: int, lane_multiple: int = LANES
           ) -> tuple[torch.Tensor, int]:
    """Flatten and zero-pad to (rows, lane_multiple) with rows a multiple
    of ``row_multiple``; returns the view and the element count n. An
    operand that needs no padding and starts on a 16-byte boundary is a
    view, else a fresh copy."""
    flat = x.reshape(-1)
    n = flat.numel()
    rows = round_up(max(cdiv(n, lane_multiple), 1), row_multiple)
    pad = rows * lane_multiple - n
    if pad or flat.data_ptr() % 16:
        flat = F.pad(flat, (0, pad))
    return flat.view(rows, lane_multiple), n


def _static(what: str, x):
    """Refuse a tensor where the JAX package takes a static Python number:
    reading it would sync with the device."""
    if isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a Python number here, got a tensor;"
                        f" device values go to flat_ternary_pack_traced")
    return x


def ternary_encode(q: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                   beta: float) -> torch.Tensor:
    """Eq. (5) over a tensor of any shape; int8 codes of ``q.shape``."""
    q2, n = _to_2d(q, ROW_MULTIPLE)
    out = te.ternary_encode(q2, _to_2d(p1, ROW_MULTIPLE)[0],
                            _to_2d(p2, ROW_MULTIPLE)[0], beta)
    return out.reshape(-1)[:n].reshape(q.shape)


def ternary_encode_round1(q: torch.Tensor, p0: torch.Tensor,
                          alpha: float) -> torch.Tensor:
    """Eq. (4) over a tensor of any shape; int8 codes of ``q.shape``."""
    q2, n = _to_2d(q, ROW_MULTIPLE)
    out = te.ternary_encode_round1(q2, _to_2d(p0, ROW_MULTIPLE)[0], alpha)
    return out.reshape(-1)[:n].reshape(q.shape)


def pack2bit(t: torch.Tensor) -> torch.Tensor:
    """int8 codes of any shape → uint8 (ceil(n/4),) packed bytes; the
    zero pad packs as code 0."""
    t2, n = _to_2d(t, ROW_MULTIPLE, LANES * PACK)
    return pk.pack2bit(t2).reshape(-1)[:cdiv(n, PACK)]


def unpack2bit(b: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 packed bytes → int8 (n,) codes."""
    b2, _ = _to_2d(b, ROW_MULTIPLE)
    return pk.unpack2bit(b2).reshape(-1)[:n]


def ternary_pack(q: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                 beta: float) -> torch.Tensor:
    """Fused Eq. (5) → §3.3 uplink over a tensor of any shape: equals
    ``pack2bit(ternary_encode(q, p1, p2, beta))`` in one launch with no
    int8 intermediate. Returns uint8 (ceil(n/4),)."""
    wide = LANES * PACK
    q2, n = _to_2d(q, ROW_MULTIPLE, wide)
    out = fw.ternary_pack(q2, _to_2d(p1, ROW_MULTIPLE, wide)[0],
                          _to_2d(p2, ROW_MULTIPLE, wide)[0], beta)
    return out.reshape(-1)[:cdiv(n, PACK)]


def ternary_pack_round1(q: torch.Tensor, p0: torch.Tensor,
                        alpha: float) -> torch.Tensor:
    """Round-1 (Eq. (4)) variant of :func:`ternary_pack`."""
    wide = LANES * PACK
    q2, n = _to_2d(q, ROW_MULTIPLE, wide)
    out = fw.ternary_pack_round1(q2, _to_2d(p0, ROW_MULTIPLE, wide)[0],
                                 alpha)
    return out.reshape(-1)[:cdiv(n, PACK)]


def flat_ternary_pack(buf_q: torch.Tensor, buf_p1: torch.Tensor,
                      buf_p2: torch.Tensor, *, t: int, beta: float,
                      alpha1: float) -> torch.Tensor:
    """One worker's uplink over flat buffers: (rows, 128) → (rows//4, 128)
    uint8 in one launch. ``t`` is the static 1-based round, a Python int:
    round 1 takes Eq. (4) with ``alpha1`` against ``buf_p1`` (= P^0) and
    never reads ``buf_p2``, later rounds Eq. (5) with ``beta``. A tensor
    ``t`` or ``beta`` raises rather than sync."""
    t, beta = _static("t", t), _static("beta", beta)
    r4 = buf_q.shape[0] // PACK
    wide = LANES * PACK
    if t <= 1:
        return fw.ternary_pack_round1(buf_q.reshape(r4, wide),
                                      buf_p1.reshape(r4, wide), alpha1)
    return fw.ternary_pack(buf_q.reshape(r4, wide), buf_p1.reshape(r4, wide),
                           buf_p2.reshape(r4, wide), beta)


def flat_ternary_pack_traced(buf_q: torch.Tensor, buf_p1: torch.Tensor,
                             buf_p2: torch.Tensor, *, t, beta,
                             alpha1) -> torch.Tensor:
    """:func:`flat_ternary_pack` at a device round: ``t``, ``beta`` (this
    worker's beta_k, e.g. sliced from a per-worker vector) and ``alpha1``
    may be device tensors or numbers; the kernel reads all three from
    device memory and picks Eq. (4) or (5), so nothing syncs."""
    r4 = buf_q.shape[0] // PACK
    wide = LANES * PACK
    dev = buf_q.device
    return fw.ternary_pack_any(
        buf_q.reshape(r4, wide), buf_p1.reshape(r4, wide),
        buf_p2.reshape(r4, wide), round_index(t, dev),
        _device_scalar(beta, torch.float32, dev, "beta"),
        _device_scalar(alpha1, torch.float32, dev, "alpha1"))


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
    """Fused Eq. (3) over all N packed wire buffers: bufs_q (Nq, rows,
    128) float32, whose pilot row ``k_star`` (a device tensor or an int)
    the kernel reads in place (the N workers' stack, or the pilot's buffer
    alone at Nq = 1, k_star 0); buf_p* (rows, 128) float32;
    packed_stacked (N, rows//4, 128) uint8; w (N,) weights with the pilot
    zeroed. Returns the new global (rows, 128) buffer."""
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


def flat_mask_repair(words: torch.Tensor | None, pair_keys: torch.Tensor,
                     pair_coeff: torch.Tensor, *,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Dropout repair over one masked-word slab (kernel view):
    ``words + Σ_p coeff[p]·stream(keys[p])`` mod 2**modulus_bits in one
    launch (none for P = 0), into a new (rows//4, 512) buffer, or into
    ``out`` (``out=words`` repairs in place). ``words`` None writes the
    repair term alone into ``out``. ``pair_keys`` (P,) uint32 and
    ``pair_coeff`` (P,) int32 come from
    ``privacy.recovery.repair_coefficients``; the kernel folds only the
    pairs whose coefficient is not 0."""
    return mw.mask_repair(words, pair_keys.contiguous(),
                          pair_coeff.to(torch.int32).contiguous(), out=out)


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


def master_update(q_pilot: torch.Tensor, tern_stacked: torch.Tensor,
                  w: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor
                  ) -> torch.Tensor:
    """Unfused Eq. (3), t > 1, over tensors of any shape: q_pilot, p1, p2
    float32 of one shape; tern_stacked (N, *shape) int8 codes; w (N,) the
    weights p_k·beta_k with the pilot's zeroed. Returns q_pilot's shape."""
    n_workers = tern_stacked.shape[0]
    q2, n = _to_2d(q_pilot, ROW_MULTIPLE)
    rows = q2.shape[0]
    flat = tern_stacked.reshape(n_workers, -1)
    pad = rows * LANES - flat.shape[1]
    if pad or flat.data_ptr() % 4:
        flat = F.pad(flat, (0, pad))
    out = mu.master_update(q2, flat.view(n_workers, rows, LANES),
                           w.to(torch.float32).contiguous(),
                           _to_2d(p1, ROW_MULTIPLE)[0],
                           _to_2d(p2, ROW_MULTIPLE)[0])
    return out.reshape(-1)[:n].reshape(q_pilot.shape)
