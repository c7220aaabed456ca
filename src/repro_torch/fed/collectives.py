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
four bytes a word. ``moved`` books, by axis, the bytes the call moves a
rank by the ring model of :func:`collective_moved`, the dry run's
(``launch.hlo_stats``).

The model axis: DTensor issues its own collectives (``_c10d_functional``
ops) on a fed worker's model group. Inside :func:`model_transport` they
go through this module too: under ``"gloo"`` each runs here, on pinned
host copies of CUDA tensors (the same staging), lifting the sync-debug
check for its own duration; under ``"nccl"`` each runs as DTensor issued
it, on the device. They are not the protocol's calls: each is booked
under ``STATS["dtensor"]`` (calls, host seconds, payload bytes, calls by
ring kind) and its ring bytes under ``moved``, by the axis's name.

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

__all__ = ["AxisGroup", "DTENSOR_OPS", "RING", "STATS", "all_gather",
           "axis_index", "collective_moved", "model_transport", "ppermute",
           "psum", "psum_scatter", "recording", "reset_stats"]

#: Transport totals of this process since :func:`reset_stats`.
STATS = {"calls": 0, "seconds": 0.0, "protocol_bytes": 0, "link_bytes": 0,
         "staged": 0, "axis_bytes": {}, "moved": {},
         "dtensor": {"calls": 0, "seconds": 0.0, "bytes": 0, "kinds": {}}}

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
            "axis_bytes": {}, "moved": {}}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = ({} if k in ("axis_bytes", "moved") else
                    {"calls": 0, "seconds": 0.0, "bytes": 0, "kinds": {}}
                    if k == "dtensor" else 0.0 if k == "seconds" else 0)


def collective_moved(kind: str, result_bytes: int, g: int) -> float:
    """Bytes a participating device moves for one collective (ring model;
    ``g`` the group size), as the JAX package's dry run counts them."""
    kind = kind.replace("-start", "")
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * result_bytes
    if kind in ("all-gather", "all-to-all", "ragged-all-to-all"):
        return (g - 1) / g * result_bytes
    if kind == "reduce-scatter":
        return (g - 1) * result_bytes          # operand = result × g
    return float(result_bytes)                  # collective-permute


#: The ring kind of each transport call, and its result's bytes from the
#: payload's ``n`` on an axis of ``g`` ranks (``launch.dryrun`` books the
#: calls it records by it).
RING = {"psum": ("all-reduce", lambda n, g: n),
         "reduce_scatter": ("reduce-scatter", lambda n, g: n // g),
         "all_gather": ("all-gather", lambda n, g: n * g),
         "ppermute": ("collective-permute", lambda n, g: n)}


def _book(stats: dict, axis: AxisGroup, n: int, link_bytes: int,
          moved: float) -> None:
    stats["calls"] += 1
    stats["protocol_bytes"] += n
    stats["link_bytes"] += link_bytes
    stats["axis_bytes"][axis.name] = stats["axis_bytes"].get(axis.name,
                                                             0) + n
    stats["moved"][axis.name] = stats["moved"].get(axis.name, 0) + moved


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _ring_moved(primitive: str, x: torch.Tensor, axis: AxisGroup) -> float:
    kind, result = RING[primitive]
    g = max(axis.size, 2)
    return collective_moved(kind, result(_nbytes(x), g), g)


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
    _book(rec.stats, axis, _nbytes(x), link_bytes,
          _ring_moved(primitive, x, axis))
    return torch.empty(out_shape, dtype=x.dtype, device="meta")


def axis_index(axis: AxisGroup) -> int:
    """This rank's index on ``axis``."""
    return axis.index


# -- the calls ---------------------------------------------------------------

def _staged(axis: AxisGroup, x: torch.Tensor) -> bool:
    """Whether a call goes through host memory: gloo and a CUDA tensor."""
    return axis.backend == "gloo" and x.device.type == "cuda"


@contextlib.contextmanager
def _call(axis: AxisGroup, x: torch.Tensor, link_bytes: int,
          moved: float):
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
        _book(STATS, axis, _nbytes(x), link_bytes, moved)
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
    with _call(axis, x, y.numel() * y.element_size(),
               _ring_moved("psum", x, axis)):
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
    with _call(axis, x, y.numel() * y.element_size(),
               _ring_moved("reduce_scatter", x, axis)):
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
            _book(rec.stats, axis, _nbytes(x), link,
                  _ring_moved("all_gather", x, axis))
            return torch.empty(shape, dtype=x.dtype, device="meta")
        return _recorded("all_gather", x, shape, axis, link)
    y = _byte_form(x.contiguous())
    with _call(axis, x, y.numel() * y.element_size(),
               _ring_moved("all_gather", x, axis)):
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
    with _call(axis, x, len(send) * y.numel() * y.element_size(),
               len(send) * _ring_moved("ppermute", x, axis)):
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



# -- the model axis: DTensor's collectives -----------------------------------

#: DTensor's collective ops (namespaces ``_c10d_functional`` and
#: ``_dtensor``), each with its ring kind and its result's bytes from the
#: payload's ``n`` on ``g`` ranks: what this module books on the model axis
#: and what ``launch.hlo_stats`` counts.
DTENSOR_OPS = {
    "all_gather_into_tensor": ("all-gather", lambda n, g: n * g),
    "all_gather_into_tensor_coalesced": ("all-gather", lambda n, g: n * g),
    "all_reduce": ("all-reduce", lambda n, g: n),
    "all_reduce_": ("all-reduce", lambda n, g: n),
    "all_reduce_coalesced": ("all-reduce", lambda n, g: n),
    "reduce_scatter_tensor": ("reduce-scatter", lambda n, g: n // g),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                        lambda n, g: n // g),
    "all_to_all_single": ("all-to-all", lambda n, g: n),
    "shard_dim_alltoall": ("all-to-all", lambda n, g: n),
    "broadcast": ("collective-permute", lambda n, g: n),
}


def _group_name(group) -> str:
    return group if isinstance(group, str) else group.group_name


def _reduced(h: torch.Tensor, reduce_op: str, g: int) -> torch.Tensor:
    """``h`` after a summing collective, as DTensor's ``reduce_op`` has it."""
    if reduce_op == "sum":
        return h
    if reduce_op == "avg":
        return h / g
    raise NotImplementedError(f"model axis: reduce op {reduce_op!r}")


def _dt_gather(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dimension 0."""
    y = _byte_form(x.contiguous())
    h = _host(axis, y)
    out = torch.empty((axis.size * y.shape[0], *y.shape[1:]),
                      dtype=y.dtype, device=h.device,
                      pin_memory=h.is_pinned())
    _all_gather(out, h, group=axis.group)
    return _back(out, x.device).view(x.dtype)


def _dt_sum(x: torch.Tensor, axis: AxisGroup, reduce_op: str
            ) -> torch.Tensor:
    h = _host(axis, x.contiguous())
    if h.data_ptr() == x.data_ptr():
        h = h.clone()
    dist.all_reduce(h, group=axis.group)
    return _reduced(_back(h, x.device), reduce_op, axis.size)


def _dt_scatter(x: torch.Tensor, axis: AxisGroup, reduce_op: str
                ) -> torch.Tensor:
    h = _host(axis, x.contiguous())
    part = torch.empty((x.shape[0] // axis.size, *x.shape[1:]),
                       dtype=x.dtype, device=h.device,
                       pin_memory=h.is_pinned())
    _reduce_scatter(part, h, group=axis.group)
    return _reduced(_back(part, x.device), reduce_op, axis.size)


def _dt_all_to_all(x: torch.Tensor, axis: AxisGroup, out_splits=(),
                   in_splits=()) -> torch.Tensor:
    """``all_to_all_single`` of dimension 0's blocks (even without
    splits)."""
    y = _byte_form(x.contiguous())
    h = _host(axis, y)
    rows = sum(out_splits) if out_splits else y.shape[0]
    out = torch.empty((rows, *y.shape[1:]), dtype=y.dtype, device=h.device,
                      pin_memory=h.is_pinned())
    dist.all_to_all_single(out, h, list(out_splits) or None,
                           list(in_splits) or None, group=axis.group)
    return _back(out, x.device).view(x.dtype)


def _dt_shard_dim_alltoall(x: torch.Tensor, axis: AxisGroup,
                           gather_dim: int, shard_dim: int) -> torch.Tensor:
    """A shard along ``gather_dim`` re-sharded along ``shard_dim``: each
    rank's chunks along ``shard_dim`` exchanged and the received ones
    joined along ``gather_dim`` in rank order (an all-to-all); a
    ``shard_dim`` the ranks do not divide is gathered whole and chunked,
    as DTensor does on a CPU mesh."""
    g = axis.size
    if x.shape[shard_dim] % g:
        whole = _dt_gather(x.movedim(gather_dim, 0), axis)
        return whole.movedim(0, gather_dim).chunk(g, dim=shard_dim)[
            axis.index].contiguous()
    got = _dt_all_to_all(torch.stack(x.chunk(g, dim=shard_dim)), axis)
    return torch.cat(got.unbind(0), dim=gather_dim)


def _dt_staged(op: str, x: torch.Tensor, rest: tuple,
               axis: AxisGroup) -> torch.Tensor:
    """One of DTensor's collectives on a gloo model group, run here;
    ``rest`` its arguments between the tensor and the group."""
    if op.startswith("all_gather_into_tensor"):
        return _dt_gather(x, axis)
    if op.startswith("all_reduce"):
        return _dt_sum(x, axis, rest[0])
    if op.startswith("reduce_scatter_tensor"):
        return _dt_scatter(x, axis, rest[0])
    if op == "all_to_all_single":
        return _dt_all_to_all(x, axis, rest[0], rest[1])
    if op == "shard_dim_alltoall":
        return _dt_shard_dim_alltoall(x, axis, rest[0], rest[1])
    h = _host(axis, x.contiguous())                         # broadcast
    if h.data_ptr() == x.data_ptr():
        h = h.clone()
    dist.broadcast(h, dist.get_global_rank(axis.group, rest[0]),
                   group=axis.group)
    return _back(h, x.device)


def _model_call(axis: AxisGroup, op: str, func, args, kwargs):
    """DTensor's collective ``op`` on ``axis``: run (under gloo, here; else
    by ``func``, DTensor's own call) and booked."""
    kind, result = DTENSOR_OPS[op]
    xs = args[0]
    many = isinstance(xs, (list, tuple))
    xs = list(xs) if many else [xs]
    g = max(axis.size, 2)
    mode = torch.cuda.get_sync_debug_mode() if _staged(axis, xs[0]) else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    t0 = time.perf_counter()
    try:
        if axis.backend != "gloo":
            out = func(*args, **kwargs)
        elif op == "all_reduce_":
            out = args[0].copy_(_dt_sum(args[0], axis, args[1]))
        else:
            outs = [_dt_staged(op, t, tuple(args[1:-1]), axis) for t in xs]
            out = outs if many else outs[0]
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)
    st = STATS["dtensor"]
    st["seconds"] += time.perf_counter() - t0
    st["calls"] += 1
    st["kinds"][kind] = st["kinds"].get(kind, 0) + 1
    for t in xs:
        st["bytes"] += _nbytes(t)
        STATS["moved"][axis.name] = STATS["moved"].get(axis.name, 0) + \
            collective_moved(kind, result(_nbytes(t), g), g)
    return out


def _transport_mode(axis: AxisGroup):
    """A ``TorchDispatchMode`` that takes the collectives DTensor issues on
    ``axis``'s group. It declines every op on DTensors, so that DTensor's
    own dispatch, and the collectives that issues, run beneath it."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    name = _group_name(axis.group)

    class ModelTransport(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func.namespace in ("_c10d_functional", "_dtensor"):
                op = func._schema.name.split("::", 1)[-1]
                if op in DTENSOR_OPS and _group_name(args[-1]) == name:
                    return _model_call(axis, op, func, args, kwargs)
            return func(*args, **kwargs)

    return ModelTransport()


@contextlib.contextmanager
def model_transport(axis: AxisGroup):
    """Route the collectives that DTensor issues on ``axis``'s process
    group inside this block through this module: booked in
    ``STATS["dtensor"]`` and, by the axis's name, ``STATS["moved"]``
    (:data:`STATS`), and under ``"gloo"`` run here on pinned host
    copies of CUDA tensors (gloo moves host memory); under ``"nccl"`` they
    run as DTensor issued them. DTensor's CPU-mesh stand-in for an
    all-to-all (an all-gather and a chunk) is replaced by the all-to-all
    on this axis, so that a CPU run moves what a card's does."""
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import placement_types as pt

    orig = pt.shard_dim_alltoall
    name = _group_name(axis.group)

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if (axis.backend != "gloo"
                or mesh.get_group(mesh_dim).group_name != name):
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        return _model_call(axis, "shard_dim_alltoall", None,
                           (input, gather_dim, shard_dim, name), {})

    pt.shard_dim_alltoall = cu.shard_dim_alltoall = shard_dim_alltoall
    try:
        with _transport_mode(axis):
            yield
    finally:
        pt.shard_dim_alltoall = cu.shard_dim_alltoall = orig
