"""The kernels of the masked FedPC round — the masked uplink, the
sum-then-unmask master and the dropout repair — hand-written in CUDA C++
(``csrc/masked_wire.cu``).

They take the same ``(R, 512)`` float views as ``kernels.fused_wire`` and
``(N, R, 512)`` wire words, ``uint16`` at the 16-bit modulus and
``uint32`` at 32. The uplink regenerates the pairwise mask and RR streams
in registers from the ``(N, L)`` key/sign matrices and the ``(N,)`` RR
keys, so no code, field, RR or mask tensor ever reaches device memory;
what it writes is already masked. It has three kernels, picked by shape
alone (:func:`cohort_kernel`): for a square key matrix, each unordered
pair is expanded once and folded into both workers, with all workers'
sums in registers up to ``PAIR_MAX_WORKERS`` (the pair kernel) and in
shared memory beyond, up to ``COHORT_MAX_WORKERS`` (the tile kernel);
otherwise each worker folds its own row (the row-fold kernel).

A launch takes a plan, as ``csrc/masked_wire.cu`` reads it: the uplink's
and the master's ``block_rows`` (kernel-view rows a CTA covers), the
row-fold uplink's ``block_workers`` (workers a CTA; the pair and tile
kernels honour only their default, 2 rows and all N), the master's
``block_workers`` (word rows loaded ahead of each step of its sum), the
repair's ``block_rows`` (rows a pass of its persistent grid covers). The plan comes from the caller: ``kernels.ops``
resolves it through the ``kernels.tune`` table and snaps it to one the
kernel honours; left as None here it is the kernels' default geometry
(``tune.default_plan`` on ``"cuda"``), and a plan the kernel would have
to change raises. The plain twin has no grid, so a plan there changes
nothing.

Each wrapper checks device, dtype, shape, contiguity and alignment and
raises on what its kernel does not take. A CUDA tensor launches the
kernel on the current stream and bumps ``LAUNCHES``; a CPU tensor takes
the plain PyTorch version beside it (``privacy.ref`` arithmetic over
streams expanded by ``privacy.masking``/``privacy.dp``), through the
launch seam (``kernels.seam``), where the master declares its pilot slot.
Nothing falls back: a kernel that fails to build or launch raises. Either
path runs inside a profiler scope named after the launch site's tune key
(``telemetry.profile.kernel_scope``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, tune
from repro_torch.kernels.fused_wire import WIDE, check_operand, scope_kind
from repro_torch.kernels.seam import device_of, run_plain
from repro_torch.privacy import ref as pref
from repro_torch.privacy.dp import rr_bits64
from repro_torch.privacy.masking import net_words64, to_words, word_bits_of
from repro_torch.privacy.recovery import mask_repair_ref
from repro_torch.telemetry import profile as tprof

#: Kernel launches per kernel; only a launch on the card counts. The
#: masked uplink's pair and row-fold kernels count under
#: ``uplink_masked``, its tile kernel under ``uplink_masked_tiles``.
LAUNCHES = {"uplink_masked": 0, "uplink_masked_tiles": 0,
            "master_masked": 0, "mask_repair": 0}

#: Bytes of shared memory a block may stage the (N, L) keys and signs in.
MAX_STAGED_BYTES = 227 * 1024

#: Most workers the pair kernel holds in registers (``kPairMaxWorkers``).
PAIR_MAX_WORKERS = 16

#: Most workers of a square key matrix whose pairs are each expanded once
#: (``kTileMaxWorkers``): the tile kernel takes ``PAIR_MAX_WORKERS`` + 1
#: up to it, every N whose (N, N) keys and signs fit ``MAX_STAGED_BYTES``.
#: Read at each call: lowering it sends those cohorts to the row fold.
COHORT_MAX_WORKERS = 170

_WORD_DTYPES = {16: torch.uint16, 32: torch.uint32}
_P = ctypes.c_void_p
_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The built library with every function's C signature declared."""
    global _bound
    if _bound is None:
        lib = build.load("masked_wire")
        lib.mw_ternary_pack_masked.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
            ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _P]
        lib.mw_ternary_pack_masked.restype = ctypes.c_int
        lib.mw_masked_master_update.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
        lib.mw_masked_master_update.restype = ctypes.c_int
        lib.mw_mask_repair.argtypes = [
            _P, _P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, _P]
        lib.mw_mask_repair.restype = ctypes.c_int
        lib.mw_error_string.argtypes = [ctypes.c_int]
        lib.mw_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _launch(kind: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: "
                           f"{_lib().mw_error_string(err).decode()}")
    LAUNCHES[kind] += 1


# -- masked uplink -----------------------------------------------------------

def ternary_pack_masked_plain(q, p1, p2, t, beta, alpha1: float, wq, keys,
                              signs, rr_keys, *, rr_threshold: int = 0,
                              word_bits: int = 32, use_masks: bool = True
                              ) -> torch.Tensor:
    """Plain twin of :func:`ternary_pack_masked`; any device."""
    n, r, _ = q.shape
    size = r * WIDE
    if use_masks:
        masks = to_words(net_words64(keys, signs, size, word_bits),
                         word_bits)
    else:
        masks = torch.zeros((n, size), dtype=_WORD_DTYPES[word_bits],
                            device=q.device)
    bits = (rr_bits64(rr_keys, size).view(n, r, WIDE)
            if rr_threshold else None)
    return pref.masked_codes_ref(q, p1, p2, t, beta, alpha1, wq,
                                 masks.view(n, r, WIDE), bits, rr_threshold)


def cohort_kernel(n: int, cohort: int) -> str:
    """The kernel of the masked uplink of N workers over an (N, L =
    cohort) key matrix: ``"pairs"`` for a square matrix of at most
    ``PAIR_MAX_WORKERS`` workers, ``"tiles"`` for a square one of more, up
    to ``COHORT_MAX_WORKERS``, ``"rows"`` (the row fold) for any other."""
    if cohort != n or not 1 <= n <= COHORT_MAX_WORKERS:
        return "rows"
    return "pairs" if n <= PAIR_MAX_WORKERS else "tiles"


def uses_pair_kernel(n: int, cohort: int) -> bool:
    """Whether the masked uplink of N workers over an (N, L = cohort) key
    matrix expands each unordered pair once and folds it into both
    workers (the pair or the tile kernel, :func:`cohort_kernel`), as the
    TPU kernel does for a cohort it holds whole. Otherwise the row-fold
    kernel, where each worker folds its own row, runs."""
    return cohort_kernel(n, cohort) != "rows"


def ternary_pack_masked(q: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                        t: torch.Tensor, beta: torch.Tensor, alpha1: float,
                        wq: torch.Tensor, keys: torch.Tensor,
                        signs: torch.Tensor, rr_keys: torch.Tensor, *,
                        rr_threshold: int = 0, word_bits: int = 32,
                        use_masks: bool = True,
                        block_rows: int | None = None,
                        block_workers: int | None = None) -> torch.Tensor:
    """All N workers' masked wire words in one launch.

    q (N, R, 512) float32, every worker's view; p1/p2 (R, 512) float32;
    t 0-d int32, the 1-based round (p2 is not read at t <= 1); beta (N,)
    float32; wq (N,) uint32 fixed-point Eq. (3) weights; keys (N, L)
    uint32 pair stream keys and signs (N, L) int32 the participation-folded
    signs (row k is worker k's; L is the cohort); rr_keys (N,) uint32;
    ``rr_threshold`` the uint16 flip threshold (0 = RR off); ``word_bits``
    16 or 32; ``use_masks=False`` adds no mask (the unmasked debug wire);
    the plan: any ``block_rows`` in [1, max(R, 2)] and ``block_workers``
    in [1, N] for the row fold, 2 and N alone for the pair and tile
    kernels (default 2 and N). Returns (N, R, 512) uint16 or uint32.

    Where :func:`uses_pair_kernel` holds, the kernel reads only the upper
    triangle of a square key matrix: the keys must be symmetric and the
    signs antisymmetric with a zero diagonal, as ``pair_stream_keys``,
    ``pair_signs`` and ``tree_pair_signs`` build them (participation
    folded in symmetrically).
    """
    return _pack_masked(q, p1, p2, t, beta, alpha1, wq, keys, signs,
                        rr_keys, rr_threshold, word_bits, use_masks,
                        block_rows=block_rows, block_workers=block_workers)


def _ternary_pack_masked_rows(q, p1, p2, t, beta, alpha1, wq, keys, signs,
                              rr_keys, *, rr_threshold: int = 0,
                              word_bits: int = 32, use_masks: bool = True,
                              block_rows: int | None = None,
                              block_workers: int | None = None
                              ) -> torch.Tensor:
    """:func:`ternary_pack_masked` through the row-fold kernel at any
    shape: the yardstick the pair and tile kernels are timed and checked
    against."""
    return _pack_masked(q, p1, p2, t, beta, alpha1, wq, keys, signs,
                        rr_keys, rr_threshold, word_bits, use_masks,
                        kernel="rows", block_rows=block_rows,
                        block_workers=block_workers)


def _ternary_pack_masked_tiles(q, p1, p2, t, beta, alpha1, wq, keys, signs,
                               rr_keys, *, rr_threshold: int = 0,
                               word_bits: int = 32, use_masks: bool = True
                               ) -> torch.Tensor:
    """:func:`ternary_pack_masked` through the tile kernel at any square N
    up to ``COHORT_MAX_WORKERS``, the pair kernel's range too: the tile
    kernel beside the pair kernel at the same N."""
    if keys.shape != (q.shape[0], q.shape[0]) or not (
            1 <= q.shape[0] <= COHORT_MAX_WORKERS):
        raise ValueError("the tile kernel takes a square key matrix of at "
                         f"most {COHORT_MAX_WORKERS} workers")
    return _pack_masked(q, p1, p2, t, beta, alpha1, wq, keys, signs,
                        rr_keys, rr_threshold, word_bits, use_masks,
                        kernel="tiles", block_rows=None, block_workers=None)


#: The C entry's number of each masked uplink kernel.
_KERNEL_IDS = {"rows": 0, "pairs": 1, "tiles": 2}


def _pack_masked(q, p1, p2, t, beta, alpha1, wq, keys, signs, rr_keys,
                 rr_threshold, word_bits, use_masks, *,
                 block_rows: int | None, block_workers: int | None,
                 kernel: str | None = None):
    dev = device_of(q)
    n, r = q.shape[0], q.shape[1]
    cohort = keys.shape[1] if keys.dim() == 2 else -1
    if word_bits not in _WORD_DTYPES:
        raise ValueError(f"word_bits must be 16 or 32, got {word_bits}")
    if not 0 <= int(rr_threshold) < 1 << 16:
        raise ValueError(f"rr_threshold must be in [0, 2**16), got "
                         f"{rr_threshold}")
    check_operand("q", q, torch.float32, (n, r, WIDE), dev, align=16)
    check_operand("p1", p1, torch.float32, (r, WIDE), dev, align=16)
    check_operand("p2", p2, torch.float32, (r, WIDE), dev, align=16)
    check_operand("t", t, torch.int32, (), dev)
    check_operand("beta", beta, torch.float32, (n,), dev)
    check_operand("wq", wq, torch.uint32, (n,), dev)
    check_operand("keys", keys, torch.uint32, (n, cohort), dev)
    check_operand("signs", signs, torch.int32, (n, cohort), dev)
    check_operand("rr_keys", rr_keys, torch.uint32, (n,), dev)
    if n < 1 or cohort < 1:
        raise ValueError("need at least one worker and one key per row")
    if r * WIDE > 1 << 32:
        raise ValueError("flat element indices must fit in 32 bits")
    if 8 * n * cohort > MAX_STAGED_BYTES:
        raise ValueError(f"a ({n}, {cohort}) key matrix does not fit in "
                         f"one block's shared memory")
    with tprof.kernel_scope(scope_kind("uplink_masked", word_bits), r, n,
                             dev):
        if dev.type != "cuda":
            return run_plain(
                "uplink_masked", ternary_pack_masked_plain,
                q, p1, p2, t, beta, alpha1, wq, keys, signs, rr_keys,
                rr_threshold=rr_threshold, word_bits=word_bits,
                use_masks=use_masks)
        kernel = kernel or cohort_kernel(n, cohort)
        br, bw = tune.cuda_plan(scope_kind("uplink_masked", word_bits), r, n,
                                block_rows, block_workers,
                                pairs=kernel != "rows")
        out = torch.empty((n, r, WIDE), dtype=_WORD_DTYPES[word_bits],
                          device=dev)
        _launch("uplink_masked_tiles" if kernel == "tiles"
                else "uplink_masked", _lib().mw_ternary_pack_masked,
                q.data_ptr(), p1.data_ptr(), p2.data_ptr(), beta.data_ptr(),
                wq.data_ptr(), keys.data_ptr(), signs.data_ptr(),
                rr_keys.data_ptr(), t.data_ptr(), float(alpha1),
                int(rr_threshold), word_bits, int(bool(use_masks)),
                _KERNEL_IDS[kernel],
                out.data_ptr(), n, cohort, r * WIDE // 4, br, bw, dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
        return out


# -- sum-then-unmask master ---------------------------------------------------

def masked_master_update_plain(q, k_star, masked, sum_wq, p1, p2, t,
                               alpha0: float, scale_mult: float
                               ) -> torch.Tensor:
    """Plain twin of :func:`masked_master_update`; any device."""
    q_pilot = q.index_select(0, k_star.reshape(1))[0]
    return pref.masked_master_ref(q_pilot, masked, sum_wq, p1, p2, t,
                                  alpha0, scale_mult)


def masked_master_update(q: torch.Tensor, k_star: torch.Tensor,
                         masked: torch.Tensor, sum_wq: torch.Tensor,
                         p1: torch.Tensor, p2: torch.Tensor, t: torch.Tensor,
                         alpha0: float, scale_mult: float, *,
                         block_rows: int | None = None,
                         block_workers: int | None = None) -> torch.Tensor:
    """Eq. (3) over the modular sum of the masked words.

    q (N, R, 512) float32, of which the pilot's view is read in place at
    k_star, a 0-d int64 device index in [0, N) (the kernel writes NaN for
    one outside it); masked (C, R, 512) uint16/uint32 (the dtype picks the
    modulus), C >= 1 word rows: the N workers' words on the flat wire, the
    w_L last-level partials at a tree's root; sum_wq 0-d uint32, the
    public Σ_k W_k; p1/p2 (R, 512) float32; t 0-d int32; ``scale_mult``
    the fixed-point descale with the RR unbias folded in; the plan: any
    ``block_rows`` in [1, max(R, 2)], ``block_workers`` the word rows loaded
    ahead, 1, 2, 4 or 8, at most C (default 2 and 1). Returns (R, 512)
    float32.
    """
    dev = device_of(q)
    n, r = q.shape[0], q.shape[1]
    c = masked.shape[0] if masked.dim() == 3 else -1
    bits = word_bits_of(masked)
    check_operand("q", q, torch.float32, (n, r, WIDE), dev, align=16)
    check_operand("k_star", k_star, torch.int64, (), dev)
    check_operand("masked", masked, masked.dtype, (c, r, WIDE), dev,
                  align=bits // 2)
    if c < 1:
        raise ValueError("need at least one row of masked words")
    check_operand("sum_wq", sum_wq, torch.uint32, (), dev)
    check_operand("p1", p1, torch.float32, (r, WIDE), dev, align=16)
    check_operand("p2", p2, torch.float32, (r, WIDE), dev, align=16)
    check_operand("t", t, torch.int32, (), dev)
    with tprof.kernel_scope(scope_kind("master_masked", bits), r, c, dev):
        if dev.type != "cuda":
            return run_plain("master_masked", masked_master_update_plain, q,
                             k_star, masked, sum_wq, p1, p2, t, alpha0,
                             scale_mult, pilot=(0, 1))
        br, bw = tune.cuda_plan(scope_kind("master_masked", bits), r, c,
                                block_rows, block_workers)
        out = torch.empty((r, WIDE), dtype=torch.float32, device=dev)
        _launch("master_masked", _lib().mw_masked_master_update,
                q.data_ptr(), k_star.data_ptr(), masked.data_ptr(),
                sum_wq.data_ptr(), p1.data_ptr(), p2.data_ptr(), t.data_ptr(),
                float(alpha0), float(scale_mult), bits, out.data_ptr(), n, c,
                r * WIDE // 4, br, bw, dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
        return out


# -- dropout repair -----------------------------------------------------------

def mask_repair_plain(y: torch.Tensor | None, keys: torch.Tensor,
                      coeff: torch.Tensor, *, out: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Plain twin of :func:`mask_repair`; any device. ``y`` None reads as a
    zero row of ``out``'s shape."""
    if y is None:
        y = torch.zeros_like(out)
    res = (y if keys.shape[0] == 0 else
           mask_repair_ref(y, keys, coeff, word_bits=word_bits_of(y)))
    if out is None:
        return res
    if out.data_ptr() != res.data_ptr():
        out.copy_(res)
    return out


def mask_repair(y: torch.Tensor | None, keys: torch.Tensor,
                coeff: torch.Tensor, *, out: torch.Tensor | None = None,
                block_rows: int | None = None) -> torch.Tensor:
    """Repair one slab of masked words after post-uplink deaths:
    ``y + Σ_p coeff[p]·stream(keys[p])`` mod 2**word_bits, in one launch.

    y (R, 512) uint16/uint32 (the dtype picks the modulus); keys (P,)
    uint32 pair stream keys and coeff (P,) int32 coefficients
    (``privacy.recovery.repair_coefficients``). The stream geometry is the
    masked uplink's (flat element index ``r·512 + c``). By default the
    result is a new tensor and ``y`` is not written; ``out`` (same dtype
    and shape) takes it instead and is returned, and ``out=y`` repairs in
    place. ``y`` None, with ``out`` given, writes the repair term alone (a
    zero row repaired) without reading anything. P = 0 returns ``y``
    itself with no launch (with ``out``, ``y`` copied into it, or zeros).
    The plan: ``block_rows`` the rows a pass of the persistent grid
    covers, ``tune.repair_rows`` of the modulus (4, 8 or 16 at 16 bits;
    2, 4 or 8 at 32; default the largest).
    """
    ref = y if y is not None else out
    if ref is None:
        raise ValueError("the write-only repair (y None) needs out")
    dev = device_of(ref)
    r = ref.shape[0] if ref.dim() == 2 else -1
    p = keys.shape[0] if keys.dim() == 1 else -1
    bits = word_bits_of(ref)
    for name, x in (("y", y), ("out", out)):
        if x is not None:
            check_operand(name, x, ref.dtype, (r, WIDE), dev, align=16)
    check_operand("keys", keys, torch.uint32, (p,), dev)
    check_operand("coeff", coeff, torch.int32, (p,), dev)
    if r * WIDE > 1 << 32:
        raise ValueError("flat element indices must fit in 32 bits")
    if 8 * p > MAX_STAGED_BYTES:
        raise ValueError(f"{p} repair pairs do not fit in one block's "
                         f"shared memory")
    if p == 0 and out is None:
        return y
    if p == 0 and dev.type != "cpu":      # a copy or a fill: no launch
        return mask_repair_plain(y, keys, coeff, out=out)
    with tprof.kernel_scope(scope_kind("mask_repair", bits), r, 1, dev):
        if dev.type != "cuda":
            return run_plain("mask_repair", mask_repair_plain, y, keys,
                             coeff, out=out)
        br, _ = tune.cuda_plan(scope_kind("mask_repair", bits), r, 1,
                               block_rows, None)
        if out is None:
            out = torch.empty_like(y)
        _launch("mask_repair", _lib().mw_mask_repair,
                None if y is None else y.data_ptr(), keys.data_ptr(),
                coeff.data_ptr(), bits, out.data_ptr(), p, r, br, dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
        return out
