"""The two kernels of hierarchical (tree) aggregation — the leaf-level
partial sum over packed codes and the interior partial sum over (masked)
words — hand-written in CUDA C++ (``csrc/partial_sum.cu``).

An internal tree node folds its sibling group of at most ``fanout``
children into one partial of integer wire words, ``uint16`` at the 16-bit
modulus and ``uint32`` at 32, with no de-bias and no descale: the root's
masked master does both once, over the public Σ_k W_k. Modular addition is
order-free, so every tree shape gives the flat round's bits. A ragged last
group (C not a multiple of ``fanout``) folds only the children that exist;
the JAX wrapper's zero padding gives the same bits.

A launch takes a plan, as ``csrc/partial_sum.cu`` reads it:
``block_rows`` (kernel-view rows a CTA covers) and ``block_groups``
(output nodes a CTA folds); the leaf sum honours only its default (2
rows, one node a CTA). ``kernels.ops`` resolves it through the
``kernels.tune`` table (the kinds ``partial_sum*``, keyed by the fanout)
and snaps it; left as None here it is the kernels' default geometry, and
a plan the kernel would have to change raises. The plain twin has no
grid, so a plan there changes nothing.

Each wrapper checks device, dtype, shape, contiguity and alignment and
raises on what its kernel does not take. A CUDA tensor launches the
kernel on the current stream and bumps ``LAUNCHES``; a CPU tensor takes
the plain PyTorch version beside it (int64 arithmetic, streams expanded
by ``privacy.masking``). Nothing falls back: a kernel that fails to build
or launch raises. Either path runs inside a profiler scope named after
the launch site's tune key (``telemetry.profile.kernel_scope``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, tune
from repro_torch.kernels.fused_wire import (LANES, PACK, WIDE, check_operand,
                                            scope_kind)
from repro_torch.kernels.seam import device_of, run_plain
from repro_torch.privacy.masking import (as_u64, net_words64, to_words,
                                         word_bits_of)
from repro_torch.telemetry import profile as tprof

#: Kernel launches per wrapper; only a launch on the card counts.
LAUNCHES = {"partial_sum": 0, "masked_partial_sum": 0}

#: Bytes of shared memory a block may stage its sibling keys and signs in.
MAX_STAGED_BYTES = 227 * 1024

_WORD_DTYPES = {16: torch.uint16, 32: torch.uint32}
_P = ctypes.c_void_p
_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The built library with every function's C signature declared."""
    global _bound
    if _bound is None:
        lib = build.load("partial_sum")
        lib.ps_partial_sum.argtypes = [
            _P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
        lib.ps_partial_sum.restype = ctypes.c_int
        lib.ps_masked_partial_sum.argtypes = [
            _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _P]
        lib.ps_masked_partial_sum.restype = ctypes.c_int
        lib.ps_error_string.argtypes = [ctypes.c_int]
        lib.ps_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _launch(kind: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: "
                           f"{_lib().ps_error_string(err).decode()}")
    LAUNCHES[kind] += 1


def _groups(c: int, fanout: int) -> int:
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    if c < 1:
        raise ValueError("need at least one child")
    return -(-c // fanout)


def _group_sum64(x: torch.Tensor, fanout: int) -> torch.Tensor:
    """(C, ...) int64 → (ceil(C / fanout), ...) sums of contiguous sibling
    groups, the ragged last group padded with zeros."""
    c = x.shape[0]
    g = -(-c // fanout)
    pad = torch.zeros((g * fanout - c,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad]).view((g, fanout) + tuple(x.shape[1:])).sum(1)


# -- leaf level: packed codes → weighted word partials ------------------------

def partial_sum_plain(packed: torch.Tensor, wq: torch.Tensor, *,
                      fanout: int, word_bits: int = 32) -> torch.Tensor:
    """Plain twin of :func:`partial_sum`; any device."""
    c, r, _ = packed.shape
    b = packed.to(torch.int64)
    fields = torch.stack([(b >> (2 * e)) & 3 for e in range(PACK)], dim=-1)
    weighted = as_u64(wq).view(c, 1, 1) * fields.view(c, r, WIDE)
    return to_words(_group_sum64(weighted, fanout), word_bits)


def partial_sum(packed: torch.Tensor, wq: torch.Tensor, *, fanout: int,
                word_bits: int = 32, block_rows: int | None = None,
                block_groups: int | None = None) -> torch.Tensor:
    """The leaf level of the plain tree in one launch.

    packed (C, R, 128) uint8 §3.3 wire buffers; wq (C,) uint32 public
    fixed-point Eq. (3) weights. Each output node g sums
    ``W_c·field_c`` over its children c in ``[g·fanout, (g+1)·fanout)``,
    with the biased fields {0, 1, 2}, mod 2**word_bits. The plan: only
    the default, ``block_rows`` 2 and ``block_groups`` 1. Returns
    (ceil(C / fanout), R, 512) uint16 or uint32.
    """
    dev = device_of(packed)
    c, r = (packed.shape[0], packed.shape[1]) if packed.dim() == 3 else (
        -1, -1)
    if word_bits not in _WORD_DTYPES:
        raise ValueError(f"word_bits must be 16 or 32, got {word_bits}")
    check_operand("packed", packed, torch.uint8, (c, r, LANES), dev)
    check_operand("wq", wq, torch.uint32, (c,), dev)
    g = _groups(c, fanout)
    if r * WIDE > 1 << 32:
        raise ValueError("flat element indices must fit in 32 bits")
    with tprof.kernel_scope("partial_sum", r, fanout, dev):
        if dev.type != "cuda":
            return run_plain("partial_sum", partial_sum_plain, packed, wq,
                             fanout=fanout, word_bits=word_bits)
        br, bg = tune.cuda_plan("partial_sum", r, g, block_rows,
                                block_groups)
        out = torch.empty((g, r, WIDE), dtype=_WORD_DTYPES[word_bits],
                          device=dev)
        _launch("partial_sum", _lib().ps_partial_sum,
                packed.data_ptr(), wq.data_ptr(), word_bits, out.data_ptr(), c,
                fanout, r * LANES, br, bg, dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
        return out


# -- interior level: word children → (masked) word partials -------------------

def masked_partial_sum_plain(words: torch.Tensor, keys: torch.Tensor,
                             signs: torch.Tensor, *, fanout: int,
                             sibling: int, use_masks: bool = True
                             ) -> torch.Tensor:
    """Plain twin of :func:`masked_partial_sum`; any device."""
    bits = word_bits_of(words)
    c, r, _ = words.shape
    acc = _group_sum64(as_u64(words), fanout)
    g = acc.shape[0]
    if use_masks and g >= 2:
        idx = torch.arange(g, device=words.device)
        same = (idx[:, None] // sibling) == (idx[None, :] // sibling)
        scoped = signs * same.to(torch.int32)
        acc += net_words64(keys, scoped, r * WIDE, bits).view(g, r, WIDE)
    return to_words(acc, bits)


def masked_partial_sum(words: torch.Tensor, keys: torch.Tensor,
                       signs: torch.Tensor, *, fanout: int, sibling: int,
                       use_masks: bool = True, block_rows: int | None = None,
                       block_groups: int | None = None) -> torch.Tensor:
    """An interior tree level in one launch.

    words (C, R, 512) uint16/uint32 child partials (the dtype picks the
    modulus); keys (G, G) uint32 and signs (G, G) int32 the emitting
    level's pair stream keys and sibling-scoped signs, G = ceil(C /
    fanout); ``sibling`` the level's sibling-group size. Each output node
    g sums its children mod 2**word_bits and, with ``use_masks`` and
    G >= 2, adds its own net mask ``Σ_l signs[g, l]·stream(keys[g, l])``
    over the l of its own sibling group. The plan: any ``block_rows`` in
    [1, max(R, 2)] and ``block_groups`` in [1, G] (default 2 and 1).
    Returns
    (G, R, 512) in the words' dtype.
    """
    dev = device_of(words)
    c, r = (words.shape[0], words.shape[1]) if words.dim() == 3 else (-1, -1)
    bits = word_bits_of(words)
    check_operand("words", words, words.dtype, (c, r, WIDE), dev,
                  align=bits // 2)
    g = _groups(c, fanout)
    check_operand("keys", keys, torch.uint32, (g, g), dev)
    check_operand("signs", signs, torch.int32, (g, g), dev)
    if sibling < 1:
        raise ValueError(f"sibling must be >= 1, got {sibling}")
    if r * WIDE > 1 << 32:
        raise ValueError("flat element indices must fit in 32 bits")
    if 8 * sibling > MAX_STAGED_BYTES:
        raise ValueError(f"a sibling group of {sibling} does not fit in one "
                         f"block's shared memory")
    with tprof.kernel_scope(scope_kind("partial_sum_masked", bits), r,
                             fanout, dev):
        if dev.type != "cuda":
            return run_plain("masked_partial_sum", masked_partial_sum_plain,
                             words, keys, signs, fanout=fanout,
                             sibling=sibling, use_masks=use_masks)
        br, bg = tune.cuda_plan(scope_kind("partial_sum_masked", bits), r,
                                g, block_rows, block_groups)
        out = torch.empty((g, r, WIDE), dtype=words.dtype, device=dev)
        _launch("masked_partial_sum", _lib().ps_masked_partial_sum,
                words.data_ptr(), keys.data_ptr(), signs.data_ptr(), bits,
                int(bool(use_masks)), out.data_ptr(), c, fanout, sibling,
                r * LANES, br, bg, dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
        return out
