"""The launch seam of the wire kernels, and the program recorder that the
§4.2 audit (``privacy.audit``) and ``utils.program_op_counts`` read.

Every wrapper of ``repro_torch.kernels`` meets its operands' device in
:func:`device_of` and, where no CUDA kernel runs, calls its plain PyTorch
version through :func:`run_plain`. A CUDA tensor launches the kernel and
never comes here; a CPU tensor runs the plain version.

While a :class:`Recorder` records (:func:`record`), the program runs on
``meta`` tensors: shapes and dtypes, no data, no device memory (the
counterpart of tracing a jaxpr against ``jax.ShapeDtypeStruct`` specs).
The recorder then sees

* every ATen op the program runs outside a launch, with its outputs'
  shapes and dtypes (a ``TorchDispatchMode``); an op that would make the
  host wait for the device (``utils.HOST_SYNC_OPS``) is recorded and
  answered with a placeholder, since a meta tensor has no value to read;
* every launch, through :func:`run_plain`: its kind, its operands and its
  outputs, and the pilot slot a master declares. The plain version makes
  the outputs on ``meta`` with op recording paused, so the ops inside a
  launch do not count (as ``iter_jaxpr_eqns(into_pallas=False)`` does not
  enter a ``pallas_call``), while its outputs, which sit in global memory,
  do.

``meta`` reaches a wrapper only while a recorder records; otherwise
:func:`device_of` refuses it. With no recorder the seam costs one context
lookup on the plain path and nothing on the CUDA path.

The seam is public, so a test can build a deliberately leaky "kernel" as
``run_plain("leaky", fn, *operands)``, as the JAX package's tests build
leaky ``pl.pallas_call``s.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.utils import HOST_SYNC_OPS, TO_HOST, tree_map

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_kernel_recorder", default=None)


class Spec(NamedTuple):
    """A tensor's shape and dtype, as a recording keeps it."""
    shape: tuple
    dtype: torch.dtype


class Op(NamedTuple):
    """One ATen op run outside a launch: its name (``aten::add``) and its
    outputs."""
    name: str
    outputs: tuple


class Launch(NamedTuple):
    """One launch: its kind (the wrapper's ``LAUNCHES`` key), its operands
    in call order (a :class:`Spec` a tensor, ``None`` anything else;
    keyword tensors after the positional ones), its outputs, and the
    declared pilot slot: ``(stack, index)`` positions of the float stack
    read in place at a 0-d device index, or ``None``."""
    kind: str
    operands: tuple
    outputs: tuple
    pilot: tuple | None


def _spec(x) -> Spec | None:
    return (Spec(tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
            else None)


def _out_specs(out) -> tuple:
    """The tensors of an op's or a launch's result, flattened."""
    if isinstance(out, torch.Tensor):
        return (_spec(out),)
    if isinstance(out, (tuple, list)):
        return tuple(s for o in out for s in _out_specs(o))
    return ()


def _on_meta(args, kwargs) -> bool:
    return any(isinstance(a, torch.Tensor) and a.device.type == "meta"
               for a in (*args, *kwargs.values()))


def _sync_name(name: str, args, kwargs) -> str | None:
    """The ``HOST_SYNC_OPS`` name of an op that makes the host wait for
    the device, or None: an op of the set, or a copy onto the CPU."""
    if name in HOST_SYNC_OPS:
        return name
    if name == "aten::_to_copy":
        dev = kwargs.get("device")
        if (dev is not None and torch.device(dev).type == "cpu"
                and args[0].device.type != "cpu"):
            return TO_HOST
    if name == "aten::copy_" and args[0].device.type == "cpu" and (
            isinstance(args[1], torch.Tensor)
            and args[1].device.type != "cpu"):
        return TO_HOST
    return None


def _placeholder(name: str, func, args, kwargs):
    """What a host-syncing op returns on ``meta``, which has no values:
    0 for a scalar read, an empty result for a data-dependent shape, a
    zero CPU tensor for a copy to the host."""
    x = args[0]
    if name == "aten::_local_scalar_dense":
        return (False if x.dtype == torch.bool
                else 0.0 if x.dtype.is_floating_point else 0)
    if name == "aten::equal":
        return False
    if name == "aten::nonzero":
        return torch.empty((0, x.dim()), dtype=torch.int64, device=x.device)
    if name == "aten::masked_select":
        return torch.empty((0,), dtype=x.dtype, device=x.device)
    if func._schema.name == "aten::copy_":      # TO_HOST into a CPU tensor
        return x
    return torch.zeros(x.shape, dtype=kwargs.get("dtype") or x.dtype,
                       device="cpu")             # TO_HOST by _to_copy


class Recorder(TorchDispatchMode):
    """The ops and launches of one program run. Made by :func:`record`."""

    def __init__(self):
        super().__init__()
        self.ops: list[Op] = []
        self.launches: list[Launch] = []
        self._paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        name = func._schema.name
        sync = _sync_name(name, args, kwargs)
        if sync is not None and _on_meta(args, kwargs):
            out = _placeholder(sync, func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        self.ops.append(Op(sync or name, _out_specs(out)))
        return out

    def launch(self, kind: str, fn: Callable, args: tuple, kwargs: dict,
               pilot: tuple | None):
        """Run one launch site's plain version with op recording paused and
        record the launch."""
        self._paused += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._paused -= 1
        operands = tuple(_spec(a) for a in (*args, *kwargs.values()))
        self.launches.append(Launch(kind, operands, _out_specs(out), pilot))
        return out

    @property
    def in_launch(self) -> bool:
        """Whether the ops running now belong to a launch's plain version."""
        return self._paused > 0

    @property
    def host_syncs(self) -> list[str]:
        """The ops of the run that would make the host wait for the device."""
        return [op.name for op in self.ops if op.name in HOST_SYNC_OPS]

    def counts(self) -> dict:
        """``{op name or "launch:<kind>": count}`` over the run."""
        out: dict = {}
        for key in ([op.name for op in self.ops]
                    + [f"launch:{ln.kind}" for ln in self.launches]):
            out[key] = out.get(key, 0) + 1
        return out


def as_specs(tree: Any) -> Any:
    """Tensors → ``meta`` tensors of the same shape, strides and dtype
    (anything else passes through), so a recording runs a program without
    real data or device memory."""
    return tree_map(
        lambda x: (torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                       device="meta")
                   if isinstance(x, torch.Tensor) else x), tree)


@contextlib.contextmanager
def recording():
    """A :class:`Recorder` that records what runs inside the block."""
    rec = Recorder()
    token = _ACTIVE.set(rec)
    try:
        with rec:
            yield rec
    finally:
        _ACTIVE.reset(token)


def record(fn: Callable, *args, **kwargs) -> tuple[Recorder, Any]:
    """Run ``fn(*args, **kwargs)`` once on the ``meta`` specs of its
    tensor arguments (:func:`as_specs`) under a recorder; returns the
    recorder and ``fn``'s result (meta tensors)."""
    spec_args, spec_kwargs = as_specs((args, kwargs))
    with recording() as rec:
        out = fn(*spec_args, **spec_kwargs)
    return rec, out


def device_of(x: torch.Tensor) -> torch.device:
    """The device a wrapper runs on: CUDA (the kernel), the CPU (the plain
    version), or ``meta`` while a recorder records."""
    kind = x.device.type
    if kind == "cuda" or kind == "cpu" or (
            kind == "meta" and _ACTIVE.get() is not None):
        return x.device
    raise ValueError(f"no wire kernel for device {x.device}")


def run_plain(kind: str, fn: Callable, *args, pilot: tuple | None = None,
              **kwargs):
    """``fn(*args, **kwargs)``, a launch site's plain version, for a
    tensor off the card. While a recorder records, the call is recorded as
    one launch of ``kind``; ``pilot=(i, j)`` declares positional operand
    ``i`` the worker stack the launch reads the pilot from in place, at
    the 0-d integer index that is operand ``j``."""
    rec = _ACTIVE.get()
    if rec is None:
        return fn(*args, **kwargs)
    return rec.launch(kind, fn, args, kwargs, pilot)
