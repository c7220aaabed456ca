"""The kernels of the plain FedPC round: the batched uplink, the one-worker
uplinks and the fused master, hand-written in CUDA C++
(``csrc/fused_wire.cu``).

Both take the kernel views of the flat ``(rows, 128)`` buffer: float
``(R, 512)`` views with ``R = rows // 4`` (four consecutive codes of one
wire byte side by side, the §3.3 order) and packed uint8 ``(R, 128)``
views. ``repro_torch.kernels.ops`` makes the views.

Each wrapper checks device, dtype, shape, contiguity and (for the
operands read as float4) 16-byte alignment, and raises on what its kernel does not take. A CUDA tensor launches the kernel
on the current stream and bumps ``LAUNCHES``; a CPU tensor takes the plain
PyTorch version beside it, through the launch seam (``kernels.seam``),
where an audit's ``meta`` run records the launch. The masters declare
their pilot slot there: the worker stack they read the pilot from in
place at ``k_star``. Nothing falls back: a kernel that fails to build
or launch raises. Either path runs inside a profiler scope named after the
launch site's tune key (``telemetry.profile.kernel_scope``).

The plain versions repeat the kernels' arithmetic: the codes from
``core.ternary``, the pack and decode in int32 (CPU torch has no shifts
for every unsigned width), and the worker fold and the Eq. (3) combine
each rounded once, as the kernel's fused multiply-adds round them
(``kernels.ref.fma_f32``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import pack2bit
from repro_torch.core.ternary import ternarize, ternarize_round1
from repro_torch.kernels import build
from repro_torch.kernels.ref import (packed_master_accum_ref,
                                     ternary_pack_ref,
                                     ternary_pack_round1_ref)
from repro_torch.kernels.seam import device_of, run_plain
from repro_torch.telemetry import profile as tprof

LANES = 128
PACK = 4
WIDE = LANES * PACK

#: Kernel launches per wrapper; only a launch on the card counts.
LAUNCHES = {"uplink_stacked": 0, "master": 0, "uplink": 0,
            "uplink_round1": 0, "uplink_traced": 0}

# The one-worker uplink's rule (csrc/fused_wire.cu, enum Rule) per kind.
_RULES = {"uplink": 0, "uplink_round1": 1, "uplink_traced": 2}

_P = ctypes.c_void_p
_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The built library with every function's C signature declared."""
    global _bound
    if _bound is None:
        lib = build.load("fused_wire")
        lib.fw_ternary_pack_stacked.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_float, _P, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, _P]
        lib.fw_ternary_pack_stacked.restype = ctypes.c_int
        lib.fw_packed_master_update.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P]
        lib.fw_packed_master_update.restype = ctypes.c_int
        lib.fw_ternary_pack.argtypes = [
            ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_float,
            ctypes.c_float, _P, ctypes.c_longlong, ctypes.c_int, _P]
        lib.fw_ternary_pack.restype = ctypes.c_int
        lib.fw_error_string.argtypes = [ctypes.c_int]
        lib.fw_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def check_operand(name: str, x: torch.Tensor, dtype: torch.dtype,
                  shape: tuple, device: torch.device, *, align: int = 1
                  ) -> None:
    """Raise unless ``x`` is what the kernels take; an operand read in
    ``align``-byte vectors must also start on such a boundary on the card."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device.type == "cuda" and x.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned for vector "
                         f"loads")


def _launch(kind: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: "
                           f"{_lib().fw_error_string(err).decode()}")
    LAUNCHES[kind] += 1


def scope_kind(kind: str, word_bits: int) -> str:
    """The tune-table kind of a word kernel: ``kind`` at 32 bits,
    ``kind + "16"`` at 16 (``uplink_masked16``, ``master_masked16``,
    ``mask_repair16``, ``partial_sum_masked16``), as the JAX package keys
    its launch sites."""
    return kind + "16" if word_bits == 16 else kind


# -- batched uplink: Eq. (4)/(5) + §3.3 pack for all N workers -------------

def ternary_pack_stacked_plain(q, p1, p2, t, beta, alpha1: float
                               ) -> torch.Tensor:
    """Plain twin of :func:`ternary_pack_stacked`; any device."""
    n, r, _ = q.shape
    codes = torch.where(t <= 1, ternarize_round1(q, p1, alpha1),
                        ternarize(q, p1, p2, beta.view(n, 1, 1)))
    return pack2bit(codes).view(n, r, LANES)


def ternary_pack_stacked(q: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                         t: torch.Tensor, beta: torch.Tensor, alpha1: float
                         ) -> torch.Tensor:
    """All N workers' §3.3 wire buffers in one launch.

    q (N, R, 512) float32, every worker's view; p1/p2 (R, 512) float32, the
    shared history; t 0-d int32, the 1-based round (Eq. (4) at t <= 1 with
    p1 = P^0, Eq. (5) after); beta (N,) float32 per-worker beta_k; alpha1
    the Eq. (4) threshold. Returns (N, R, 128) uint8.
    """
    dev = device_of(q)
    n, r = q.shape[0], q.shape[1]
    check_operand("q", q, torch.float32, (n, r, WIDE), dev, align=16)
    check_operand("p1", p1, torch.float32, (r, WIDE), dev, align=16)
    check_operand("p2", p2, torch.float32, (r, WIDE), dev, align=16)
    check_operand("t", t, torch.int32, (), dev)
    check_operand("beta", beta, torch.float32, (n,), dev)
    if n < 1:
        raise ValueError("need at least one worker")
    with tprof.kernel_scope("uplink_stacked", r, n, dev):
        if dev.type != "cuda":
            return run_plain("uplink_stacked", ternary_pack_stacked_plain, q,
                             p1, p2, t, beta, alpha1)
        out = torch.empty((n, r, LANES), dtype=torch.uint8, device=dev)
        _launch("uplink_stacked", _lib().fw_ternary_pack_stacked,
                q.data_ptr(), p1.data_ptr(), p2.data_ptr(), beta.data_ptr(),
                t.data_ptr(), float(alpha1), out.data_ptr(), n, r * LANES,
                dev.index, torch.cuda.current_stream(dev).cuda_stream)
        return out


# -- one-worker uplinks: Eq. (5), Eq. (4), or either by a device round ----

def ternary_pack_plain(q, p1, p2, beta: float) -> torch.Tensor:
    """Plain twin of :func:`ternary_pack`; any device."""
    return ternary_pack_ref(q, p1, p2, beta).view(q.shape[0], LANES)


def ternary_pack_round1_plain(q, p0, alpha: float) -> torch.Tensor:
    """Plain twin of :func:`ternary_pack_round1`; any device."""
    return ternary_pack_round1_ref(q, p0, alpha).view(q.shape[0], LANES)


def ternary_pack_any_plain(q, p1, p2, t, beta, alpha1) -> torch.Tensor:
    """Plain twin of :func:`ternary_pack_any`; any device."""
    return ternary_pack_stacked_plain(q[None], p1, p2, t, beta.reshape(1),
                                      alpha1)[0]


def _pack_one(kind: str, q, p1, p2, t, beta, alpha1) -> torch.Tensor:
    """Check one worker's (R, 512) views and launch the ``kind`` rule:
    ``p2`` may be None (Eq. (4)); ``t``, ``beta`` and ``alpha1`` are 0-d
    device tensors for the traced rule, numbers for the others."""
    dev = device_of(q)
    r = q.shape[0]
    check_operand("q", q, torch.float32, (r, WIDE), dev, align=16)
    check_operand("p1", p1, torch.float32, (r, WIDE), dev, align=16)
    if p2 is not None:
        check_operand("p2", p2, torch.float32, (r, WIDE), dev, align=16)
    traced = kind == "uplink_traced"
    if traced:
        check_operand("t", t, torch.int32, (), dev)
        check_operand("beta", beta, torch.float32, (), dev)
        check_operand("alpha1", alpha1, torch.float32, (), dev)
    with tprof.kernel_scope("uplink", r, 1, dev):
        if dev.type != "cuda":
            if traced:
                return run_plain(kind, ternary_pack_any_plain, q, p1, p2, t,
                                 beta, alpha1)
            if p2 is None:
                return run_plain(kind, ternary_pack_round1_plain, q, p1,
                                 alpha1)
            return run_plain(kind, ternary_pack_plain, q, p1, p2, beta)
        if traced:
            at = (t.data_ptr(), beta.data_ptr(), alpha1.data_ptr())
            by_value = (0.0, 0.0)
        else:
            at = (None, None, None)
            by_value = (float(beta), float(alpha1))
        out = torch.empty((r, LANES), dtype=torch.uint8, device=dev)
        _launch(kind, _lib().fw_ternary_pack, _RULES[kind], q.data_ptr(),
                p1.data_ptr(), None if p2 is None else p2.data_ptr(), *at,
                *by_value, out.data_ptr(), r * LANES, dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
        return out


def ternary_pack(q: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                 beta: float) -> torch.Tensor:
    """One worker's §3.3 wire buffer by Eq. (5), a static round t >= 2.

    q, p1, p2 (R, 512) float32: the worker's view and the history
    P^{t-1}, P^{t-2}; beta the threshold. Returns (R, 128) uint8.
    """
    return _pack_one("uplink", q, p1, p2, None, beta, 0.0)


def ternary_pack_round1(q: torch.Tensor, p0: torch.Tensor, alpha: float
                        ) -> torch.Tensor:
    """One worker's §3.3 wire buffer by Eq. (4), round 1: q and P^0
    (R, 512) float32, threshold alpha; no P^{t-2} operand. Returns
    (R, 128) uint8."""
    return _pack_one("uplink_round1", q, p0, None, None, 0.0, alpha)


def ternary_pack_any(q: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                     t: torch.Tensor, beta: torch.Tensor,
                     alpha1: torch.Tensor) -> torch.Tensor:
    """One worker's §3.3 wire buffer at a device round: Eq. (4) at t <= 1
    (p1 holds P^0; p2 is not read), Eq. (5) after.

    q, p1, p2 (R, 512) float32; t 0-d int32, beta and alpha1 0-d float32,
    all three read by the kernel from device memory, so no host sync.
    Returns (R, 128) uint8.
    """
    return _pack_one("uplink_traced", q, p1, p2, t, beta, alpha1)


# -- fused master: decode + Σ_k w_k T_k + Eq. (3) --------------------------

def packed_master_update_plain(q, k_star, packed, w, p1, p2, t,
                               alpha0: float) -> torch.Tensor:
    """Plain twin of :func:`packed_master_update`; any device."""
    n = packed.shape[0]
    q_pilot = q.index_select(0, k_star.reshape(1))[0]
    return packed_master_accum_ref(q_pilot, packed.view(n, -1), w, p1, p2,
                                   t, alpha0)


def packed_master_update(q: torch.Tensor, k_star: torch.Tensor,
                         packed: torch.Tensor, w: torch.Tensor,
                         p1: torch.Tensor, p2: torch.Tensor, t: torch.Tensor,
                         alpha0: float) -> torch.Tensor:
    """Eq. (3) over every worker's packed codes in one launch.

    q (Nq, R, 512) float32, a stack of float views of which the pilot's is
    read in place at k_star, a 0-d int64 device index in [0, Nq) (the
    kernel writes NaN for one outside it): every worker's view in one
    process (Nq = N, k_star the pilot), or the pilot's alone where it
    arrived apart, as on a mesh rank (Nq = 1, k_star 0); packed
    (N, R, 128) uint8; w (N,) float32, the Eq. (3) weights with the
    pilot's entry zeroed; p1/p2 (R, 512) float32; t 0-d int32 (alpha0
    steps at t <= 1, P^{t-1} − P^{t-2} after). Workers fold strictly in
    order k = 0..N−1. Returns (R, 512) float32.
    """
    dev = device_of(q)
    nq, r = q.shape[0], q.shape[1]
    n = packed.shape[0] if packed.dim() == 3 else -1
    check_operand("q", q, torch.float32, (nq, r, WIDE), dev, align=16)
    check_operand("k_star", k_star, torch.int64, (), dev)
    check_operand("packed", packed, torch.uint8, (n, r, LANES), dev)
    check_operand("w", w, torch.float32, (n,), dev)
    check_operand("p1", p1, torch.float32, (r, WIDE), dev, align=16)
    check_operand("p2", p2, torch.float32, (r, WIDE), dev, align=16)
    check_operand("t", t, torch.int32, (), dev)
    if n < 1 or nq < 1:
        raise ValueError("need at least one worker and one pilot buffer")
    with tprof.kernel_scope("master", r, n, dev):
        if dev.type != "cuda":
            return run_plain("master", packed_master_update_plain, q, k_star,
                             packed, w, p1, p2, t, alpha0, pilot=(0, 1))
        out = torch.empty((r, WIDE), dtype=torch.float32, device=dev)
        _launch("master", _lib().fw_packed_master_update,
                q.data_ptr(), k_star.data_ptr(), packed.data_ptr(),
                w.data_ptr(), p1.data_ptr(), p2.data_ptr(), t.data_ptr(),
                float(alpha0), out.data_ptr(), n, nq, r * LANES, dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
        return out
