"""The unfused uplink's first kernel: one worker's Eq. (5) (or Eq. (4))
ternary codes as int8, hand-written in CUDA C++
(``csrc/ternary_encode.cu``).

Both take ``(R, 128)`` float32 views of flat operands and return int8
``(R, 128)`` codes in {-1, 0, 1}; ``repro_torch.kernels.ops`` pads an
arbitrary shape to such a view. The codes are those of the fused uplinks
before packing, from the same field function, so ``pack2bit`` of them is
the fused uplink's wire buffer bit for bit.

Each wrapper checks device, dtype, shape, contiguity and 16-byte alignment
and raises on what its kernel does not take. A CUDA tensor launches the
kernel on the current stream and bumps ``LAUNCHES``; a CPU tensor takes the
plain PyTorch version (``core.ternary``). Nothing falls back: a kernel
that fails to build or launch raises. Either path runs inside a profiler
scope (``telemetry.profile.kernel_scope``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ternary import ternarize, ternarize_round1
from repro_torch.kernels import build
from repro_torch.kernels.fused_wire import LANES, check_operand
from repro_torch.kernels.seam import device_of, run_plain
from repro_torch.telemetry import profile as tprof

#: Kernel launches per wrapper; only a launch on the card counts.
LAUNCHES = {"encode": 0, "encode_round1": 0}

_P = ctypes.c_void_p
_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The built library with every function's C signature declared."""
    global _bound
    if _bound is None:
        lib = build.load("ternary_encode")
        lib.te_ternary_encode.argtypes = [
            ctypes.c_int, _P, _P, _P, ctypes.c_float, ctypes.c_float, _P,
            ctypes.c_longlong, ctypes.c_int, _P]
        lib.te_ternary_encode.restype = ctypes.c_int
        lib.te_error_string.argtypes = [ctypes.c_int]
        lib.te_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _encode(kind: str, q, p1, p2, beta: float, alpha: float
            ) -> torch.Tensor:
    dev = device_of(q)
    r = q.shape[0]
    check_operand("q", q, torch.float32, (r, LANES), dev, align=16)
    check_operand("p1", p1, torch.float32, (r, LANES), dev, align=16)
    if p2 is not None:
        check_operand("p2", p2, torch.float32, (r, LANES), dev, align=16)
    with tprof.kernel_scope(kind, r, 1, dev):
        if dev.type != "cuda":
            if p2 is None:
                return run_plain(kind, ternarize_round1, q, p1, alpha)
            return run_plain(kind, ternarize, q, p1, p2, beta)
        out = torch.empty((r, LANES), dtype=torch.int8, device=dev)
        lib = _lib()
        err = lib.te_ternary_encode(
            int(p2 is None), q.data_ptr(), p1.data_ptr(),
            None if p2 is None else p2.data_ptr(), float(beta), float(alpha),
            out.data_ptr(), r * LANES // 4, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{kind} kernel launch failed: "
                               f"{lib.te_error_string(err).decode()}")
        LAUNCHES[kind] += 1
        return out


def ternary_encode(q: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                   beta: float) -> torch.Tensor:
    """Eq. (5): q, p1, p2 (R, 128) float32 (the worker's model and the
    history P^{t-1}, P^{t-2}) → int8 (R, 128) codes."""
    return _encode("encode", q, p1, p2, beta, 0.0)


def ternary_encode_round1(q: torch.Tensor, p0: torch.Tensor,
                          alpha: float) -> torch.Tensor:
    """Eq. (4): q, p0 (R, 128) float32 → int8 (R, 128) codes."""
    return _encode("encode_round1", q, p0, None, 0.0, alpha)
