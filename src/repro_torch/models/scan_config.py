"""Scan-unroll switch, the JAX package's ``models/scan_config.py``.

The reference's layer stacks and Mamba chunk loops are ``lax.scan``s, and
XLA's cost analysis counts a loop body once. The port's unit stacks and
chunk loops are Python loops: they always run unrolled, and nothing here
changes how a model runs.

The one reader is the dry run's counter (``launch/hlo_stats.py``). While it
counts (:func:`counting`), a loop whose iterations run the same ops on the
same shapes is traced once and counted ``trips`` times, as the
reference's loop-aware HLO counter multiplies a scan body by its trip
count; the counter's record lists each such loop with its trip count
under ``loop_trip_counts``:

  * off the gradient path, the unit stacks and the encoder's
    (``models/transformer.py``), the Mamba chunks and the blocked
    attention's tiles (:func:`loop`), unless ``unroll()`` is set — then
    every iteration is traced, as the reference's dry run unrolls its
    scans. Under a gradient they are traced in full: the backward keeps
    every iteration's saved tensors, which the peak must hold;
  * the mLSTM/sLSTM time loops always, as the reference keeps them rolled:
    one chunk of ``ssm.LSTM_CHUNK[0]`` steps is traced (4,096 steps a
    layer on ``meta`` would take minutes; a chunk of ``None`` traces them
    all). Under a gradient the chunk runs through
    :func:`rolled_call`, whose backward (the checkpoint's recompute and
    the gradient) is counted ``trips`` times too.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext

import torch

_UNROLL = [False]
# While a counter counts: the counter (``launch.hlo_stats.OpCounter``).
_COUNTER = [None]


def set_unroll(value: bool) -> None:
    _UNROLL[0] = bool(value)


def unroll() -> bool:
    return _UNROLL[0]


@contextmanager
def counting(counter):
    """Within this block, loops are rolled for ``counter`` (``None``:
    traced in full)."""
    prev = _COUNTER[0]
    _COUNTER[0] = counter
    try:
        yield
    finally:
        _COUNTER[0] = prev


def rolled() -> bool:
    """True while a counter wants the time loops traced a chunk only."""
    return _COUNTER[0] is not None


def loop_scope(name: str | None, trips: int):
    """The counter's scale for one rolled loop body (a no-op context off
    the counter); ``name=None, trips=0`` counts nothing."""
    counter = _COUNTER[0]
    return nullcontext() if counter is None else counter.scope(name, trips)


def structural(n: int) -> bool:
    """Whether a structural loop of ``n`` like bodies is rolled: while a
    counter counts, off the gradient path, unless ``unroll()``."""
    return (rolled() and n > 1 and not unroll()
            and not torch.is_grad_enabled())


def loop(name: str, n: int):
    """The iterations of a structural loop of ``n`` like bodies to run:
    all of them, or, while a counter counts (:func:`structural`), the
    first alone under its scale of ``n``. A caller that collects a result
    an iteration repeats the list to ``n`` entries."""
    if not structural(n):
        yield from range(n)
        return
    with loop_scope(name, n):
        yield 0


def rolled_call(body, name: str, trips: int, tensors: tuple, n_carry: int):
    """``body(*tensors)``, a tuple of tensors, run once for ``trips`` runs
    of a checkpointed loop (one that recomputes a body in its backward):
    under the counter's scale off the gradient path; under a gradient
    through :class:`_Rolled`, whose backward is counted ``trips`` times.
    The first ``n_carry`` tensors are the carry, which the loop passes
    from body to body (each later body takes its gradient, so this one
    does too); the gradients of the others the loop sums over its bodies,
    and those ``trips - 1`` sums are counted."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        with loop_scope(name, trips):
            return body(*tensors)
    carry = tuple(t if t.requires_grad else t.detach().requires_grad_()
                  for t in tensors[:n_carry])
    return _Rolled.apply(body, name, trips, n_carry, *carry,
                         *tensors[n_carry:])


class _Rolled(torch.autograd.Function):
    """One checkpointed body standing for ``trips``: its forward, and in
    the backward its recompute and its gradient, each under the counter's
    scale of ``trips`` — what the checkpointed loop runs a body."""

    @staticmethod
    def forward(ctx, body, name, trips, n_carry, *ts):
        ctx.body, ctx.name, ctx.trips, ctx.n_carry = body, name, trips, \
            n_carry
        ctx.save_for_backward(*ts)
        with loop_scope(name, trips):
            return body(*ts)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[4:]
        ts = [t.detach().requires_grad_(n)
              for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad(), loop_scope(ctx.name, ctx.trips):
            outs = ctx.body(*ts)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            gs = list(torch.autograd.grad(
                [o for o, _ in pairs], [t for t in ts if t.requires_grad],
                [g for _, g in pairs], allow_unused=True))
        counter = _COUNTER[0]
        if counter is not None:      # the sums over the other bodies
            for g in gs[ctx.n_carry:]:
                if g is not None:
                    counter.add_bytes(3 * (ctx.trips - 1) * _local_bytes(g))
        it = iter(gs)
        return (None, None, None, None,
                *(next(it) if n else None for n in need))


def _local_bytes(t) -> int:
    """One device's bytes of ``t`` (a DTensor's local shard)."""
    local = t.to_local() if hasattr(t, "to_local") else t
    return local.numel() * local.element_size()
