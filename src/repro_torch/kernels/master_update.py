"""The unfused master: Eq. (3) for t > 1 over every worker's int8 ternary
codes, hand-written in CUDA C++ (``csrc/master_update.cu``).

``master_update`` returns ``q − (Σ_k w_k T_k)·(p1 − p2)``: the workers
fold strictly in order k = 0..N−1 as ``acc + T_k·w_k``, each product and
sum rounded once, and the combine is one fused multiply-add. On the
wire's codes {−1, 0, 1} every product is exact, so the result has the bits
of the fused packed master (``fused_wire.packed_master_update``) on the
same codes. A code outside {−1, 0, 1} weighs as its integer value, its
product ``T_k·w_k`` rounded once before it is added. The JAX kernel
reduces with a tensordot whose order XLA picks, so the two agree within
float32 rounding, not bitwise.

The wrapper checks device, dtype, shape, contiguity and alignment and
raises on what the kernel does not take. A CUDA tensor launches the kernel
on the current stream and bumps ``LAUNCHES``; a CPU tensor takes the plain
PyTorch version, which rounds the same operations in the same order
(``kernels.ref.fma_f32`` for the combine). Nothing falls back: a kernel
that fails to build or launch raises. Either path runs inside a profiler
scope (``telemetry.profile.kernel_scope``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_wire import LANES, check_operand
from repro_torch.kernels.seam import device_of, run_plain
from repro_torch.kernels.ref import fma_f32
from repro_torch.telemetry import profile as tprof

#: Kernel launches per wrapper; only a launch on the card counts.
LAUNCHES = {"master_update": 0}

_P = ctypes.c_void_p
_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The built library with every function's C signature declared."""
    global _bound
    if _bound is None:
        lib = build.load("master_update")
        lib.mu_master_update.argtypes = [
            _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, _P]
        lib.mu_master_update.restype = ctypes.c_int
        lib.mu_error_string.argtypes = [ctypes.c_int]
        lib.mu_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def master_update_plain(q, tern, w, p1, p2) -> torch.Tensor:
    """Plain twin of :func:`master_update`; any device."""
    coeff = torch.zeros_like(q)
    for k in range(tern.shape[0]):
        coeff = coeff + tern[k].float() * w[k]
    return fma_f32(-coeff, p1 - p2, q)


def master_update(q: torch.Tensor, tern: torch.Tensor, w: torch.Tensor,
                  p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Eq. (3), t > 1: q (R, 128) float32 the pilot's model; tern
    (N, R, 128) int8 every worker's codes; w (N,) float32 the weights
    p_k·beta_k with the pilot's zeroed; p1/p2 (R, 128) float32 the
    history. Returns (R, 128) float32."""
    dev = device_of(q)
    n, r = tern.shape[0], q.shape[0]
    check_operand("q", q, torch.float32, (r, LANES), dev, align=16)
    check_operand("tern", tern, torch.int8, (n, r, LANES), dev, align=4)
    check_operand("w", w, torch.float32, (n,), dev)
    check_operand("p1", p1, torch.float32, (r, LANES), dev, align=16)
    check_operand("p2", p2, torch.float32, (r, LANES), dev, align=16)
    if n < 1:
        raise ValueError("need at least one worker")
    with tprof.kernel_scope("master_update", r, n, dev):
        if dev.type != "cuda":
            return run_plain("master_update", master_update_plain, q, tern,
                             w, p1, p2)
        out = torch.empty((r, LANES), dtype=torch.float32, device=dev)
        lib = _lib()
        err = lib.mu_master_update(
            q.data_ptr(), tern.data_ptr(), w.data_ptr(), p1.data_ptr(),
            p2.data_ptr(), out.data_ptr(), n, r * LANES // 4, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"master_update kernel launch failed: "
                               f"{lib.mu_error_string(err).decode()}")
        LAUNCHES["master_update"] += 1
        return out
