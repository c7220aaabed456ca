"""Round-program leakage audits: §4.2 enforcement, the counterpart of the
JAX package's ``repro.privacy.audit``.

The leakage ledger (``repro_torch.core.privacy``) records what crosses
the worker→master boundary; :func:`check_round_program` *enforces* the
policy on the round program itself, so a runtime fails fast at set-up
instead of trusting its drivers. The program runs once on ``meta``
tensors (:func:`as_specs`: shapes and dtypes, never real data) under the
launch seam's recorder (``kernels.seam``), which sees every ATen op
outside a kernel and every kernel launch with its operands and outputs.

In ``round_step`` the master-side math is the last launch. No float
operand stacked over the worker axis may reach it, i.e. non-pilot
full-precision parameters never enter master-side compute, with one
exception the port's masters declare: the **pilot slot**. They read the
pilot's model in place from the ``(N, rows, 128)`` worker stack at a 0-d
device index ``k_star`` (copying the pilot's row out first would cost a
buffer's worth of traffic a round), and the launch declares that operand
and its index (``run_plain(..., pilot=(stack, index))``). The audit
accepts that one operand as the pilot's upload when the index is a 0-d
integer tensor; any other stacked float operand, or a slot without such
an index, raises. That the kernels read nothing of the stack but the
pilot's row is held by tests that fill the other rows with NaN.

On the masked wire, additionally: no plaintext ternary-code tensor
(int8/uint8) materializes anywhere outside a kernel, the uplink (the first
launch) consumes no mask-shaped unsigned tensor stacked over the worker
axis (mask and RR streams are generated in the kernels from counter keys),
and no dict-carried output of the program (the info and telemetry records
a driver exports) holds a float payload stacked over the worker axis.

The JAX package's second boundary, the distributed runtime's collectives
(``check_fed_collectives``), waits for that runtime's port.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.privacy import LeakageError
from repro_torch.kernels.seam import as_specs, record

__all__ = ["MASKED_WORD_DTYPES", "as_specs", "check_recovery_target",
           "check_round_program"]

_CODE_DTYPE_NAMES = ("int8", "uint8")

#: The wire words the masked path is allowed to move — one word per
#: parameter at either supported modulus.
MASKED_WORD_DTYPES = ("uint16", "uint32")

# A per-worker float payload this small is protocol metadata (Eq. (3)
# weights, costs, goodness — all public scalars per §4.2), not a parameter
# buffer; the smallest real buffer slab is one (8, 128) tile.
_SCALAR_PAYLOAD_MAX = 8

_UNSIGNED = ("uint8", "uint16", "uint32", "uint64")
_SIGNED_INT = ("int8", "int16", "int32", "int64")


def _name(dtype) -> str:
    """A dtype's name without its package: ``torch.uint8`` → ``uint8``.
    Dtypes are compared by name, so ``bool`` is never a code dtype."""
    return str(dtype).rsplit(".", 1)[-1]


def _is_code_dtype(dtype) -> bool:
    return _name(dtype) in _CODE_DTYPE_NAMES


def _is_unsigned_dtype(dtype) -> bool:
    return _name(dtype) in _UNSIGNED


def _is_float_dtype(dtype) -> bool:
    return isinstance(dtype, torch.dtype) and dtype.is_floating_point


def _volume(shape) -> int:
    v = 1
    for d in shape:
        v *= d
    return v


def _is_signed_int_buffer(shape, dtype) -> bool:
    """True for a signed-integer tensor with buffer-scale volume. On the
    masked wire the de-biased (signed) sum exists only at the root, after
    unmasking; scalar signed metadata (round counters, the pilot index)
    stays allowed."""
    return _name(dtype) in _SIGNED_INT and _volume(shape) > _SCALAR_PAYLOAD_MAX


def _stacked_float_buffer(shape, dtype, n: int) -> bool:
    """True when (shape, dtype) is a float tensor stacked over the worker
    axis with real per-worker volume — parameter-bearing, not the public
    per-worker scalars the protocol always shares."""
    if not _is_float_dtype(dtype) or len(shape) < 1 or shape[0] != n:
        return False
    return _volume(shape[1:]) > _SCALAR_PAYLOAD_MAX


def _stacked_mask_buffer(shape, dtype, n: int) -> bool:
    """True when (shape, dtype) looks like a materialized per-worker mask
    or RR tensor: unsigned words stacked over the worker axis with more
    than key-matrix volume per worker. The uplink consumes only the (N, N)
    pair keys and signs, the (N,) RR keys and the (N,) fixed-point
    weights — at most N words a worker — so anything bigger (an
    (N, rows, 512) mask plane) is a mask round-tripping through memory."""
    if not _is_unsigned_dtype(dtype) or len(shape) < 1 or shape[0] != n:
        return False
    return _volume(shape[1:]) > max(_SCALAR_PAYLOAD_MAX, n)


def _check_master(master, n_workers: int) -> None:
    """No float operand of the master launch is stacked over the worker
    axis, but the declared pilot slot beside its 0-d integer index."""
    slot, index = master.pilot if master.pilot is not None else (None, None)
    for i, op in enumerate(master.operands):
        if op is None or not op.shape:
            continue
        if not _stacked_float_buffer(op.shape, op.dtype, n_workers):
            continue
        idx = master.operands[index] if i == slot else None
        if idx is not None and idx.shape == () and _name(
                idx.dtype) in _SIGNED_INT:
            continue          # the pilot's upload, read in place at k_star
        why = (" — its pilot slot has no 0-d integer index" if i == slot
               else "")
        raise LeakageError(
            f"master launch consumes a float operand stacked over the "
            f"worker axis: shape {op.shape} {_name(op.dtype)} — non-pilot "
            f"full-precision params crossed the boundary{why}")


def check_round_program(fn: Callable, *args, n_workers: int,
                        masked: bool = False, **kwargs) -> dict:
    """Audit a round program (``round_step`` or a wrapper of it).

    ``fn(*args, **kwargs)`` runs once on the ``meta`` specs of its tensor
    arguments. The last launch is the master update: none of its float
    operands may be stacked over the worker axis but its declared pilot
    slot. With ``masked=True``, additionally (a) no int8/uint8
    ternary-code tensor materializes outside a kernel — an op's output, or
    a launch's, as its outputs sit in global memory (the packed plaintext
    wire buffer of the unmasked path must not exist); (b) the uplink (the
    first launch) does not consume a mask-shaped unsigned operand stacked
    over the worker axis — later tree launches legitimately consume
    stacked masked-word partials; and (c) no dict-carried output of the
    program (the info and telemetry records a driver fetches to the host)
    holds a float payload stacked over the worker axis. Only dict subtrees
    are audited for (c): the state's (rows, 128) buffer slabs are shared
    state, not per-worker exports.

    A round must not sync with the host; one that does cannot be audited
    on ``meta`` (the values it reads do not exist) and raises
    ``RuntimeError``. Returns ``{"boundary": "round-step", "n_launches",
    "masked"}``: the launches of this one run, a branch counting only the
    side it took.
    """
    rec, out = record(fn, *args, **kwargs)
    if rec.host_syncs:
        raise RuntimeError(
            f"the round program syncs with the host ({rec.host_syncs}); a "
            f"round must not, and the audit cannot read past it")
    launches = rec.launches
    if not launches:
        raise LeakageError("no kernel launch found to audit")
    _check_master(launches[-1], n_workers)
    if masked:
        produced = [(op.name, op.outputs) for op in rec.ops] + [
            (f"launch:{ln.kind}", ln.outputs) for ln in launches]
        for name, outputs in produced:
            for o in outputs:
                if _is_code_dtype(o.dtype):
                    raise LeakageError(
                        f"plaintext code tensor materialized on the masked "
                        f"wire path: {name} -> {o.shape} {_name(o.dtype)}")
        # Only the first launch is the worker uplink; later launches on the
        # tree path are interior partial sums whose operands are
        # legitimately (C, rows, 512) stacks of already-masked words.
        for op in launches[0].operands:
            if op is not None and op.shape and _stacked_mask_buffer(
                    op.shape, op.dtype, n_workers):
                raise LeakageError(
                    f"uplink launch consumes a materialized mask tensor: "
                    f"shape {op.shape} {_name(op.dtype)} — mask/RR streams "
                    f"must be generated in-kernel from counter keys, not "
                    f"round-tripped through device memory")
        _check_info_payloads(out, n_workers)
    return {"boundary": "round-step", "n_launches": len(launches),
            "masked": masked}


def _leaves_with_path(tree: Any, path: tuple = ()):
    """(path, leaf) pairs; a path is a tuple of ``("dict", key)``,
    ``("attr", field)`` (a NamedTuple) and ``("seq", index)`` steps, as
    ``jax.tree_util.tree_flatten_with_path`` keys them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (("dict", k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves_with_path(getattr(tree, f),
                                         path + (("attr", f),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves_with_path(x, path + (("seq", i),))
    else:
        yield path, tree


def _keystr(path: tuple) -> str:
    return "".join(f"[{k!r}]" if kind == "dict" else
                   f".{k}" if kind == "attr" else f"[{k}]"
                   for kind, k in path)


def _check_info_payloads(out: Any, n_workers: int) -> None:
    """Part (c) of the masked audit: scan the program's dict-carried
    outputs (the info and telemetry records a driver exports off the
    device) for per-worker float payloads."""
    for path, leaf in _leaves_with_path(out):
        if not any(kind == "dict" for kind, _ in path):
            continue
        if not isinstance(leaf, torch.Tensor):
            continue
        if _stacked_float_buffer(tuple(leaf.shape), leaf.dtype, n_workers):
            raise LeakageError(
                f"round info/trace record carries a per-worker float "
                f"payload at {_keystr(path)}: shape {tuple(leaf.shape)} "
                f"{_name(leaf.dtype)} — telemetry must export counts and "
                f"public scalars only, never parameter-bearing buffers")


def check_recovery_target(worker: int, alive) -> None:
    """Mask-seed reconstruction may only target a declared-dead worker.

    Reconstructing a live worker's pair keys would let the server strip
    that worker's masks from its committed uplink, the attack secure
    aggregation exists to prevent, so ``recovery.recover_worker_keys``
    calls this before combining any share. ``alive`` is the round's public
    (n,) survival mask (numpy or a tensor; > 0 means live)."""
    a = torch.as_tensor(alive)
    if bool(a[int(worker)] > 0):
        raise LeakageError(
            f"mask-seed recovery targeted worker {int(worker)}, which is "
            f"still live this round — recovery may only reconstruct "
            f"declared-dead workers' seeds")
