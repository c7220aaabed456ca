"""The fed-axis transport of the distributed runtime (``fed.distributed``):
the port's counterpart of the ``shard_map`` collectives the JAX package's
runtime calls, over ``torch.distributed``.

A mesh axis, as one rank sees it, is an :class:`AxisGroup`: the process
group of the ranks that share every other mesh coordinate, its size, this
rank's index on it, the group's global ranks in index order, and the
backend. One function a JAX primitive takes it:

* :func:`axis_index` — this rank's index on the axis (a Python int: a
  rank knows its own coordinate);
* :func:`psum` — the sum over the axis, on every rank;
* :func:`psum_scatter` — the sum, each rank keeping its ``1/size`` block
  of rows (JAX's ``psum_scatter(..., tiled=True)`` over dimension 0);
* :func:`all_gather` — every rank's tensor, stacked (or concatenated with
  ``tiled=True``) in index order;
* :func:`ppermute` — a permutation of the ranks' tensors by ``(src,
  dst)`` index pairs; a rank nobody sends to receives zeros.

The backend is the caller's choice, made when the process group was made:
``"nccl"`` with one card a rank, ``"gloo"`` with several ranks on one card
or on the CPU. Nothing here picks one.

Words a backend cannot sum (neither gloo nor NCCL sums ``int16``,
``uint16`` or ``uint32``): ``uint32`` words sum as their ``int32`` view,
a wrapping add, so mod 2**32 and the same bits; ``uint16`` words widen to
``int32`` for the sum and narrow after, exact for fewer than 2**15 ranks.
A gather or a permute of such a dtype moves its bytes as a ``uint8`` view.
Under ``"gloo"`` every call on a CUDA tensor goes through pinned host
memory (one device-to-host copy, which the host waits for, and one copy
back): gloo moves host memory, and handed a CUDA tensor it wrote the
device pointer to its socket (an 84 MB ``all_reduce`` failed with
"writev: Bad address" on an H100 under torch 2.11).

A call staged through host memory makes the host wait for the device
by design, so it lifts ``torch.cuda``'s sync-debug mode for its own
duration (the rest of the round stays under the caller's check); a call
on the device (NCCL) stays under it. Every call adds its host time, its
protocol bytes (also by the name of its axis, under ``axis_bytes``), the
bytes it put on the link and whether it was staged to :data:`STATS`.
Both byte counts are of the payload one rank hands the call (a gather's
own shard, a permute's sends): the protocol bytes as the JAX program has
it, the link bytes as the backend takes it, a widened ``uint16`` sum
four bytes a word.

The transport is also a seam, as ``kernels.seam`` is for launches: while
a :func:`recording` records, each call is recorded as ``{"primitive",
"shape", "dtype"}`` of the payload the protocol hands it, under the name
the JAX package's jaxpr gives the primitive (``psum_scatter`` is
``reduce_scatter`` there), and it answers on ``meta`` tensors without a
process group. ``privacy.audit.check_fed_collectives`` reads that record.
The recorder also books every call's bytes as :data:`STATS` would
(``Recorder.stats``), a call kept out of the record too, so that a run on
``meta`` counts what a real run moves (``launch.dryrun``).
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

__all__ = ["AxisGroup", "STATS", "all_gather",
           "axis_index", "ppermute", "psum", "psum_scatter", "recording",
           "reset_stats"]

#: Transport totals of this process since :func:`reset_stats`.
STATS = {"calls": 0, "seconds": 0.0, "protocol_bytes": 0, "link_bytes": 0,
         "staged": 0, "axis_bytes": {}}

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_collective_recorder", default=None)

# Dtypes both backends take as they are. Sums of ``uint32`` and
# ``uint16`` go through int32, of anything else are refused; gathers and
# permutes of anything else move its bytes.
_NATIVE = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int32, torch.int64, torch.int8, torch.uint8)


class AxisGroup(NamedTuple):
    """One mesh axis as a rank sees it. ``group`` is ``None`` on a mesh
    made for a recording only (:meth:`meta`)."""
    group: Any
    size: int
    index: int
    ranks: tuple
    backend: str
    name: str = ""

    @classmethod
    def meta(cls, size: int, index: int, name: str = "") -> "AxisGroup":
        """An axis with no process group, for a :func:`recording`."""
        return cls(None, size, index, tuple(range(size)), "meta", name)


def _zero_stats() -> dict:
    return {"calls": 0, "protocol_bytes": 0, "link_bytes": 0,
            "axis_bytes": {}}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = ({} if k == "axis_bytes" else
                    0.0 if k == "seconds" else 0)


def _book(stats: dict, axis: AxisGroup, x: torch.Tensor,
          link_bytes: int) -> None:
    n = x.numel() * x.element_size()
    stats["calls"] += 1
    stats["protocol_bytes"] += n
    stats["link_bytes"] += link_bytes
    stats["axis_bytes"][axis.name] = stats["axis_bytes"].get(axis.name,
                                                             0) + n


def _sum_bytes(x: torch.Tensor) -> int:
    """The link bytes of a sum of ``x``: a widened ``uint16`` word is
    four bytes."""
    return x.numel() * (4 if x.dtype == torch.uint16 else x.element_size())


class Recorder:
    """The transport calls of one program run. Made by :func:`recording`."""

    def __init__(self):
        self.calls: list[dict] = []
        self.stats = _zero_stats()

    def payloads(self) -> list[dict]:
        return [dict(c) for c in self.calls]


@contextlib.contextmanager
def recording():
    """A :class:`Recorder` of the transport calls made inside the block;
    each answers on ``meta`` with the shape the real call would give."""
    rec = Recorder()
    token = _ACTIVE.set(rec)
    try:
        yield rec
    finally:
        _ACTIVE.reset(token)


def _recorded(primitive: str, x: torch.Tensor, out_shape: tuple,
              axis: AxisGroup, link_bytes: int) -> torch.Tensor | None:
    rec = _ACTIVE.get()
    if rec is None:
        return None
    rec.calls.append({"primitive": primitive, "shape": tuple(x.shape),
                      "dtype": str(x.dtype).rsplit(".", 1)[-1]})
    _book(rec.stats, axis, x, link_bytes)
    return torch.empty(out_shape, dtype=x.dtype, device="meta")


def axis_index(axis: AxisGroup) -> int:
    """This rank's index on ``axis``."""
    return axis.index


# -- the calls ---------------------------------------------------------------

def _staged(axis: AxisGroup, x: torch.Tensor) -> bool:
    """Whether a call goes through host memory: gloo and a CUDA tensor."""
    return axis.backend == "gloo" and x.device.type == "cuda"


@contextlib.contextmanager
def _call(axis: AxisGroup, x: torch.Tensor, link_bytes: int):
    """Time one call and book its bytes; a staged call runs outside the
    sync-debug check of the program around it."""
    mode = torch.cuda.get_sync_debug_mode() if _staged(axis, x) else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        STATS["seconds"] += time.perf_counter() - t0
        _book(STATS, axis, x, link_bytes)
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


def _host(axis: AxisGroup, x: torch.Tensor) -> torch.Tensor:
    """``x`` where the backend can read it: a pinned host copy of a CUDA
    tensor under gloo, else ``x``."""
    if not _staged(axis, x):
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    STATS["staged"] += 1
    return host


def _back(h: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A result on the caller's device (a copy from pinned memory, which
    the host does not wait for)."""
    return h if h.device == device else h.to(device, non_blocking=True)


def _sum_form(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a dtype the backends sum, with the same sum mod its width."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    if x.dtype in _NATIVE:
        return x
    raise TypeError(f"no sum over the fed axis for {x.dtype}")


def _from_sum_form(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.uint32:
        return y.view(torch.uint32)
    if dtype == torch.uint16:
        v = y & 0xFFFF
        return (v - ((v & 0x8000) << 1)).to(torch.int16).view(torch.uint16)
    return y


def _all_gather(out, x, group) -> None:
    """``all_gather_single`` where torch has it (it replaces the
    deprecated ``all_gather_into_tensor``), the same call either way."""
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, x, group=group)


def _reduce_scatter(out, x, group) -> None:
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
        out, x, group=group)


def _byte_form(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype in _NATIVE else x.view(torch.uint8)


def psum(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axis``, on every rank (mod the
    word width for ``uint16``/``uint32``); ``x`` is not written."""
    out = _recorded("psum", x, tuple(x.shape), axis, _sum_bytes(x))
    if out is not None:
        return out
    y = _sum_form(x.contiguous())
    with _call(axis, x, y.numel() * y.element_size()):
        h = _host(axis, y)
        if h.data_ptr() == x.data_ptr():       # the sum is in place
            h = h.clone()
        dist.all_reduce(h, group=axis.group)
        y = _back(h, x.device)
    return _from_sum_form(y, x.dtype)


def psum_scatter(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """The sum over ``axis``, of which rank ``i`` keeps rows ``[i·r/F,
    (i+1)·r/F)`` of dimension 0 (``r`` divisible by the axis size)."""
    f = axis.size
    if x.shape[0] % f:
        raise ValueError(f"{x.shape[0]} rows do not split over {f} ranks")
    shape = (x.shape[0] // f, *x.shape[1:])
    out = _recorded("reduce_scatter", x, shape, axis, _sum_bytes(x))
    if out is not None:
        return out
    y = _sum_form(x.contiguous())
    with _call(axis, x, y.numel() * y.element_size()):
        h = _host(axis, y)
        part = torch.empty(shape, dtype=h.dtype, device=h.device,
                           pin_memory=h.is_pinned())
        _reduce_scatter(part, h, group=axis.group)
        part = _back(part, x.device)
    return _from_sum_form(part, x.dtype)


def all_gather(x: torch.Tensor, axis: AxisGroup, *, tiled: bool = False,
               record: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in index order: stacked ``(F, *x.shape)``, or
    concatenated along dimension 0 with ``tiled``. ``record=False`` keeps
    the call out of a recording (it still answers on ``meta``): the model
    axis's reassembly of the public new buffer, which the JAX package's
    program leaves to XLA's resharding."""
    f = axis.size
    shape = ((f * x.shape[0], *x.shape[1:]) if tiled
             else (f, *x.shape))
    rec = _ACTIVE.get()
    if rec is not None:
        link = x.numel() * x.element_size()
        if not record:
            _book(rec.stats, axis, x, link)
            return torch.empty(shape, dtype=x.dtype, device="meta")
        return _recorded("all_gather", x, shape, axis, link)
    y = _byte_form(x.contiguous())
    with _call(axis, x, y.numel() * y.element_size()):
        h = _host(axis, y)
        out = torch.empty((f * y.shape[0], *y.shape[1:]), dtype=y.dtype,
                          device=h.device, pin_memory=h.is_pinned())
        _all_gather(out, h, group=axis.group)
        out = _back(out, x.device)
    return out.view(x.dtype).view(shape)


def ppermute(x: torch.Tensor, axis: AxisGroup, perm) -> torch.Tensor:
    """Rank ``dst`` receives rank ``src``'s ``x`` for each ``(src, dst)``
    index pair of ``perm`` (each rank at most once on either side, never
    to itself); a rank no pair sends to receives zeros."""
    me = axis.index
    send = [dst for src, dst in perm if src == me]
    recv = [src for src, dst in perm if dst == me]
    out = _recorded("ppermute", x, tuple(x.shape), axis,
                    len(send) * x.numel() * x.element_size())
    if out is not None:
        return out
    y = _byte_form(x.contiguous())
    with _call(axis, x, len(send) * y.numel() * y.element_size()):
        h = _host(axis, y)
        got = torch.zeros(h.shape, dtype=h.dtype, device=h.device,
                          pin_memory=h.is_pinned())
        ops = [dist.P2POp(dist.isend, h, axis.ranks[d], axis.group)
               for d in send]
        ops += [dist.P2POp(dist.irecv, got, axis.ranks[s], axis.group)
                for s in recv]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        got = _back(got, x.device)
    return got.view(x.dtype).view(x.shape)
