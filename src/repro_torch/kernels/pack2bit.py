"""The §3.3 wire format alone: four int8 ternary codes to one byte and
back, hand-written in CUDA C++ (``csrc/pack2bit.cu``).

``pack2bit`` takes int8 ``(R, 512)`` codes and returns uint8 ``(R, 128)``
bytes, four consecutive codes a byte, code j biased by one in bits 2j,
2j + 1; ``unpack2bit`` is the inverse and returns ``field − 1``, so the
unused field 3 becomes code 2. Pack takes any int8: it sums
``(c + 1)·4^j`` in int32 and keeps the low 8 bits, as the JAX kernel's
int32 sum and XLA's conversion to uint8 do, so a code outside
{-1, 0, 1, 2} carries into the higher fields.

Each wrapper checks device, dtype, shape, contiguity and alignment (the
codes are read 16 bytes, the bytes 4 bytes at a time) and raises on what
its kernel does not take. A CUDA tensor launches the kernel on the current
stream and bumps ``LAUNCHES``; a CPU tensor takes the plain PyTorch
version, in int32 (CPU torch has no shifts for every unsigned width).
Nothing falls back: a kernel that fails to build or launch raises.
Either path runs inside a profiler scope
(``telemetry.profile.kernel_scope``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.kernels import build
from repro_torch.kernels.fused_wire import LANES, PACK, WIDE, check_operand
from repro_torch.kernels.seam import device_of, run_plain
from repro_torch.telemetry import profile as tprof

#: Kernel launches per wrapper; only a launch on the card counts.
LAUNCHES = {"pack": 0, "unpack": 0}

_P = ctypes.c_void_p
_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The built library with every function's C signature declared."""
    global _bound
    if _bound is None:
        lib = build.load("pack2bit")
        for fn in (lib.pk_pack2bit, lib.pk_unpack2bit):
            fn.argtypes = [_P, _P, ctypes.c_longlong, ctypes.c_int, _P]
            fn.restype = ctypes.c_int
        lib.pk_error_string.argtypes = [ctypes.c_int]
        lib.pk_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _launch(kind: str, fn, src: torch.Tensor, out: torch.Tensor) -> None:
    dev = src.device
    err = fn(src.data_ptr(), out.data_ptr(), out.shape[0] * LANES // PACK,
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: "
                           f"{_lib().pk_error_string(err).decode()}")
    LAUNCHES[kind] += 1


def pack2bit_plain(codes: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`pack2bit`; any device."""
    return packing.pack2bit(codes).view(codes.shape[0], LANES)


def unpack2bit_plain(packed: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`unpack2bit`; any device."""
    return packing.unpack2bit(packed, packed.numel() * PACK).view(
        packed.shape[0], WIDE)


def pack2bit(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes (R, 512) → uint8 (R, 128), four consecutive codes a
    byte."""
    dev = device_of(codes)
    r = codes.shape[0]
    check_operand("codes", codes, torch.int8, (r, WIDE), dev, align=16)
    with tprof.kernel_scope("pack", r, 1, dev):
        if dev.type != "cuda":
            return run_plain("pack", pack2bit_plain, codes)
        out = torch.empty((r, LANES), dtype=torch.uint8, device=dev)
        _launch("pack", _lib().pk_pack2bit, codes, out)
        return out


def unpack2bit(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (R, 128) → int8 codes (R, 512), ``field − 1`` each."""
    dev = device_of(packed)
    r = packed.shape[0]
    check_operand("packed", packed, torch.uint8, (r, LANES), dev, align=4)
    with tprof.kernel_scope("unpack", r, 1, dev):
        if dev.type != "cuda":
            return run_plain("unpack", unpack2bit_plain, packed)
        out = torch.empty((r, WIDE), dtype=torch.int8, device=dev)
        _launch("unpack", _lib().pk_unpack2bit, packed, out)
        return out
