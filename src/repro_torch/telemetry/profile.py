"""Profiler scopes on the wire kernels' launches, and a profiling session.

Every launch of a kernel of ``repro_torch.kernels`` (and the plain
PyTorch version a CPU tensor takes instead) runs inside a
:func:`kernel_scope` named as the JAX package names the launch site,
after its tune key: ``wire/<kind>/r<rows>n<N>/<backend>``, with
``backend`` ``"cuda"`` for the kernel and ``"cpu-plain"`` for the plain
version. A ``torch.profiler`` capture then attributes each launch to the
identity ``PERF.md``'s kernel table and ``kernels.tune``'s table use
(``backend_tag`` is the tuner's).

A ``record_function`` costs a dispatcher call even with no profiler
running, so :func:`kernel_scope` opens one only while a profiler records;
otherwise it is a no-op context. :func:`profile_session` wraps
``torch.profiler.profile`` as a context manager.
"""
from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.kernels.tune import backend_tag


def scope_name(kind: str, rows: int, n: int = 1, device=None) -> str:
    """The profiler label of one launch site, keyed like the tune table."""
    return f"wire/{kind}/r{int(rows)}n{max(1, int(n))}/{backend_tag(device)}"


def kernel_scope(kind: str, rows: int, n: int = 1, device=None):
    """A ``record_function`` range over one launch, named by its tune key,
    while a profiler records; a no-op context otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(scope_name(kind, rows, n, device))


@contextlib.contextmanager
def profile_session(logdir: str | None = None):
    """A ``torch.profiler`` capture of the block (CPU activity, and CUDA
    activity where CUDA is available), yielded so the caller can read its
    events; every kernel scope inside it lands in the capture. With
    ``logdir`` the Chrome trace is written to ``logdir/trace.json``
    (TensorBoard / Perfetto) when the block ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
