"""Per-device cost of one traced program: the port's counterpart of the
JAX package's ``launch/hlo_stats.py``, which parses compiled HLO.

There is no HLO here. The counter is a ``TorchDispatchMode`` that sees
each ATen op one rank dispatches, *below* DTensor: it declines an op on
DTensors (so DTensor picks its strategy, redistributes and runs the op on
local shards) and counts the local ops that follow, with this rank's
shapes. It skips the ops DTensor runs on fake tensors to propagate
shapes. It counts

  * FLOPs       — matmul-class ops, by ``torch.utils.flop_counter``'s
                  formulas on the local shapes;
  * bytes       — each op's tensor inputs plus its outputs. This is the
                  eager program the port runs, op by op, with no fusion:
                  an upper bound on what a fused step would move. Views,
                  which move nothing, count nothing;
  * collectives — the ``_c10d_functional`` ops DTensor issues, by kind
                  (all-gather, all-reduce, reduce-scatter, all-to-all),
                  with their group's size and mesh axis, and the byte
                  model of ``_collective_moved``; the fed axis's transport
                  calls come from ``fed.collectives``' recorder
                  (:meth:`OpCounter.add_collective`);
  * peak live bytes — the program's arguments plus every output storage
                  from its creation until its last reference dies.

:meth:`OpCounter.scope` multiplies what runs inside by ``trips``: the
body of a loop traced once (``models.scan_config``); the record lists
each such loop with its trip count under ``loop_trip_counts``.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.fed.collectives import DTENSOR_OPS
from repro_torch.fed.collectives import collective_moved as _collective_moved

# ops that allocate or alias and move no bytes
_FREE = {"empty", "empty_strided", "empty_like", "detach", "alias",
         "lift_fresh", "wait_tensor", "_wrap_tensor_autograd", "new_empty",
         "new_empty_strided"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class HloStats:
    """What :class:`OpCounter` counted, under the JAX record's keys, plus
    ``bytes_by_axis`` (collective bytes by mesh axis), the peak live
    bytes and the argument bytes."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_device_bytes: float = 0.0
    collective_counts: dict = field(default_factory=dict)
    collective_bytes_by_kind: dict = field(default_factory=dict)
    loop_trip_counts: dict = field(default_factory=dict)
    bytes_by_axis: dict = field(default_factory=dict)
    peak_bytes: int = 0
    argument_bytes: int = 0


class OpCounter(TorchDispatchMode):
    """Counts the local ops of the program run inside ``with counter:``.

    ``axis_of_group`` maps a process group's name to its mesh axis (see
    :func:`mesh_groups`). ``skip``, when set, is a callable that returns
    True while the ops it sees belong to a kernel launch's plain version
    (a launch is counted by :meth:`add_launch` instead)."""

    def __init__(self, axis_of_group: dict | None = None):
        super().__init__()
        self.stats = HloStats()
        self.axis_of_group = dict(axis_of_group or {})
        self.skip = None
        self._mult = 1.0
        self._paused = 0
        self._live: dict = {}           # storage key -> bytes
        self._live_bytes = 0

    # -- memory ---------------------------------------------------------
    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        if self._live_bytes > self.stats.peak_bytes:
            self.stats.peak_bytes = self._live_bytes
        weakref.finalize(st, self._drop, key)

    def _drop(self, key) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def hold_arguments(self, *trees) -> None:
        """Count the program's arguments (each DTensor's local shard) as
        live from the start."""
        from torch.distributed.tensor import DTensor
        before = self._live_bytes
        for t in _tensors(trees):
            self._hold(t.to_local() if isinstance(t, DTensor) else t)
        self.stats.argument_bytes += self._live_bytes - before

    # -- loops ----------------------------------------------------------
    @property
    def live_bytes(self) -> int:
        return self._live_bytes

    def hold_extra(self, nbytes: int) -> None:
        """Count ``nbytes`` more as live at this moment, for the peak: what
        the other bodies of a rolled loop would hold here."""
        self.stats.peak_bytes = max(self.stats.peak_bytes,
                                    self._live_bytes + nbytes)

    @contextlib.contextmanager
    def scope(self, name: str | None, trips: int):
        """Count what runs inside ``trips`` times (one traced body of a
        rolled loop ``name``; ``None, 0`` counts nothing)."""
        if name is not None:
            self.stats.loop_trip_counts[name] = int(trips)
        prev = self._mult
        self._mult = prev * trips
        try:
            yield
        finally:
            self._mult = prev

    # -- other sources --------------------------------------------------
    def add_collective(self, kind: str, result_bytes: int, group: int,
                       axis: str, count: int = 1) -> None:
        moved = self._mult * count * _collective_moved(kind, result_bytes,
                                                       max(group, 2))
        st = self.stats
        st.collective_device_bytes += moved
        st.collective_counts[kind] = (st.collective_counts.get(kind, 0)
                                      + int(self._mult * count))
        st.collective_bytes_by_kind[kind] = (
            st.collective_bytes_by_kind.get(kind, 0.0) + moved)
        st.bytes_by_axis[axis] = st.bytes_by_axis.get(axis, 0.0) + moved

    def add_bytes(self, nbytes: float) -> None:
        """``nbytes`` more moved, at the current loop scale."""
        self.stats.bytes += self._mult * nbytes

    def add_launch(self, operands, outputs) -> None:
        """A wire kernel's launch: its operands read once, its outputs
        written once (``kernels.seam.Launch`` specs)."""
        for s in (*operands, *outputs):
            if s is not None:
                n = 1
                for d in s.shape:
                    n *= d
                self.stats.bytes += n * s.dtype.itemsize

    @contextlib.contextmanager
    def alltoall_on_cpu_mesh(self):
        """On a ``DeviceMesh`` of CPU ranks DTensor stands an all-gather and
        a chunk in for an all-to-all (gloo has none); within this block
        each such redistribution counts as the all-to-all a CUDA mesh
        runs: its input's bytes over its mesh dim's group."""
        from torch.distributed.tensor import _collective_utils as cu
        from torch.distributed.tensor import placement_types as pt
        orig = getattr(pt, "shard_dim_alltoall", None)
        if orig is None:
            yield
            return

        def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
            group = mesh.get_group(mesh_dim)
            self.add_collective(
                "all-to-all", _nbytes(input), group.size(),
                self.axis_of_group.get(group.group_name, "mixed"))
            self._paused += 1
            try:
                out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._paused -= 1
            self._hold(out)
            self.stats.bytes += self._mult * 2 * _nbytes(out)
            return out

        pt.shard_dim_alltoall = cu.shard_dim_alltoall = counted
        try:
            yield
        finally:
            pt.shard_dim_alltoall = cu.shard_dim_alltoall = orig

    # -- dispatch -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor)
               for t in _tensors((out, args, kwargs))):
            return out                   # DTensor's shape propagation
        if self._paused or (self.skip is not None and self.skip()):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        ns = func.namespace
        name = func._schema.name.split("::", 1)[-1]
        m = self._mult
        if ns in ("_c10d_functional", "_dtensor"):
            if name in DTENSOR_OPS:
                self._collective(DTENSOR_OPS[name][0], func, args, out)
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            self.stats.flops += m * flop_registry[packet](
                *args, **kwargs, out_val=out)
        outs = [t for t in _tensors(out)]
        for t in outs:
            self._hold(t)
        if func.is_view or name in _FREE:
            return
        moved = sum(_nbytes(t) for t in _tensors((args, kwargs)))
        moved += sum(_nbytes(t) for t in outs)
        self.stats.bytes += m * moved

    def _collective(self, kind, func, args, out) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group
        group_name = args[-1]
        group = _resolve_process_group(group_name).size()
        axis = self.axis_of_group.get(group_name, "mixed")
        result = sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._hold(t)
        self.add_collective(kind, result, group, axis)


def mesh_groups(mesh) -> dict:
    """``{process group name: mesh axis name}`` of a ``DeviceMesh``; a
    group of several axes (DTensor flattens some) counts as ``"mixed"``,
    which the roofline puts on the network."""
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
