"""Activation placements (logical-axis style), the JAX package's
``sharding/activations.py`` over DTensor.

The reference pins the residual stream to (batch→data axes) and the wide
intermediates to (feature→'model'), so that its partitioner gathers
weights instead of activations and the only activation collectives left
are the Megatron row-parallel all-reduces. Here each hook redistributes a
DTensor to the placements that the reference's constraint names, and a
plain tensor the model made (a zeroed state) counts as replicated first.

The hooks act only inside :func:`use_mesh`, the context the dry run enters
with a ``DeviceMesh``; it also enters ``implicit_replication()``, so the
plain tensors the models make (RoPE tables, masks, zeroed caches) mix with
DTensors as replicated ones. Off a mesh every hook returns its input
object, so the eager and graphed paths on one card do not change. Any axis
that does not divide its dim is dropped (e.g. batch=1 in long_500k — the
cache placements then carry the parallelism).

Where DTensor has no strategy for an op on these placements, the model
calls :func:`replicated` on its operands at that site: they are gathered
whole and the op is listed in :data:`REPLICATED_OPS`, which the dry run
reports. An op with no strategy at all is run another way under a mesh
(:func:`on_mesh`), and listed too. Torch before 2.13 lacks a few
strategies that 2.13 has (:data:`OLD_DTENSOR`): the sites that need them
step round there only (:func:`gather_rows`, :func:`scatter_rows`,
:func:`add`, :func:`old_dtensor_on_mesh`), so that what 2.13 runs and
counts stays as it is.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from repro_torch.sharding.specs import mesh_axes, placements

#: DTensor of a torch before 2.13: no strategy for an index whose indices
#: split one dim over two mesh dims, nor for a view that splits a sharded
#: dim in the backward of the MoE's gather; no redistribution of a shard
#: to a partial sum; no plan for the pad of a channel-sharded tensor; an
#: einsum's views of a shard split over two mesh dims take local lengths.
OLD_DTENSOR = tuple(int(v) for v in
                    torch.__version__.split("+")[0].split(".")[:2]) < (2, 13)

_DISABLED = [False]
_MESH = [None]
#: Ops whose operands were gathered whole under a mesh, or that ran
#: another way there, in first-seen order (the dry run clears it per
#: combo and reports it).
REPLICATED_OPS: list = []


@contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the hooks' mesh for this block."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = _MESH[0]
    _MESH[0] = mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESH[0] = prev


def set_disabled(value: bool) -> None:
    """Disable all activation placements (the fed dry run, whose local
    training keeps the fed axis out of the activations)."""
    _DISABLED[0] = bool(value)


@contextmanager
def disabled():
    """:func:`set_disabled` for this block, the previous setting restored
    after it."""
    prev = _DISABLED[0]
    _DISABLED[0] = True
    try:
        yield
    finally:
        _DISABLED[0] = prev


def _current_mesh():
    return None if _DISABLED[0] else _MESH[0]


def _dp_axes(sizes: dict) -> tuple[str, ...]:
    return tuple(a for a in sizes if a in ("pod", "data"))


def _place(x, mesh, spec):
    """``x`` as a DTensor with the placements of ``spec``."""
    from torch.distributed.tensor import DTensor, Replicate

    target = placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def constrain(x, raw_spec):
    """raw_spec: tuple per dim — None | axis-name | 'DP' (data axes) |
    tuple of axis names. Drops non-divisible/absent axes."""
    mesh = _current_mesh()
    if mesh is None or x.ndim != len(raw_spec):
        return x
    return _place_raw(x, mesh, raw_spec)


def _place_raw(x, mesh, raw_spec):
    sizes = mesh_axes(mesh)
    spec = []
    for dim, ax in zip(x.shape, raw_spec):
        if ax is None:
            spec.append(None)
            continue
        if ax == "DP":
            axs = _dp_axes(sizes)
        elif isinstance(ax, str):
            axs = (ax,) if ax in sizes else ()
        else:
            axs = ()
            for a in ax:
                if a == "DP":
                    axs += _dp_axes(sizes)
                elif a in sizes:
                    axs += (a,)
        size = 1
        for a in axs:
            size *= sizes[a]
        if axs and size > 0 and dim % size == 0:
            spec.append(axs if len(axs) > 1 else axs[0])
        else:
            spec.append(None)
    return _place(x, mesh, spec)


def replicated(op: str, *xs):
    """``xs`` gathered whole under a mesh (each as it is off one), with
    ``op`` listed in :data:`REPLICATED_OPS`: the operands of an op that
    DTensor cannot run on their placements. Like :func:`like`, it acts
    under :func:`set_disabled` too: it keeps DTensor running, it places
    nothing."""
    mesh = _MESH[0]
    if mesh is None:
        return xs if len(xs) > 1 else xs[0]
    if op not in REPLICATED_OPS:
        REPLICATED_OPS.append(op)
    out = tuple(_place(x, mesh, (None,) * x.ndim) for x in xs)
    return out if len(out) > 1 else out[0]


def old_dtensor_on_mesh(x) -> bool:
    """Whether ``x`` is a DTensor under a mesh on a torch before 2.13
    (:data:`OLD_DTENSOR`): a site that steps round that torch's holes
    does so then only."""
    from torch.distributed.tensor import DTensor

    return OLD_DTENSOR and _MESH[0] is not None and isinstance(x, DTensor)


def _hybrid(x) -> bool:
    """Whether a DTensor splits one of its dims over two mesh dims."""
    return any(sum(p.is_shard(d) for p in x.placements) > 1
               for d in range(x.ndim))


class _WholeGrad(torch.autograd.Function):
    """Identity; its gradient redistributed whole (replicated)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        return g.redistribute(g.device_mesh,
                              [Replicate()] * g.device_mesh.ndim)


def gather_rows(op: str, table, shape: tuple, index, groups: int):
    """``table.reshape(shape)[index()]``, rows gathered from ``table``
    (its leading dim ``groups`` groups of rows, the MoE's experts), in
    that order. On a torch before 2.13 under a mesh, with the indices
    sharded, where that torch has no strategy (``op`` listed each time):
    under a gradient, indices split over two mesh dims are gathered whole
    with the rows, and the rows' gradient is made whole before it is
    viewed as the groups (whose sharded dim it would split) when the
    indices split over two mesh dims or over mesh dims that do not divide
    ``groups``; with no gradient, an index whose sharding propagation
    fails is retried on whole operands. Else as it is."""
    flat = table.reshape(shape)
    idx = index()
    if not (old_dtensor_on_mesh(idx) and any(p.is_shard()
                                             for p in idx.placements)):
        return flat[idx]
    grad = torch.is_grad_enabled() and table.requires_grad
    shards = 1
    for n, p in zip(idx.device_mesh.shape, idx.placements):
        shards *= n if p.is_shard() else 1
    hybrid = _hybrid(idx)
    if grad and hybrid:           # the rows whole before they are viewed
        table, idx = replicated(op, table, idx)
        flat = table.reshape(shape)
    if grad and (hybrid or groups % shards):
        if op + " (gradient whole)" not in REPLICATED_OPS:
            REPLICATED_OPS.append(op + " (gradient whole)")
        flat = _WholeGrad.apply(flat)
    try:
        return flat[idx]
    except RuntimeError:        # no strategy for these sharded indices
        if grad:
            raise
    flat, idx = replicated(op, flat, idx)
    return flat[idx]


def scatter_rows(op: str, idx, rows):
    """``(idx, rows)`` for ``buf.index_put((idx,), rows)``: on a torch
    before 2.13 under a mesh and a gradient, indices split over two mesh
    dims gathered whole with the rows (``op`` listed) — the backward
    indexes the buffer's gradient by them, which that torch cannot. Else
    as they are."""
    if (old_dtensor_on_mesh(idx) and torch.is_grad_enabled()
            and rows.requires_grad and _hybrid(idx)):
        return replicated(op, idx, rows)
    return idx, rows


def partial_beside_shard(a, b) -> bool:
    """Whether DTensors ``a`` and ``b`` hold a partial sum and a shard on
    one mesh dim, where a plan may redistribute the shard to a partial
    sum."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return False
    return any((p.is_partial() and q.is_shard())
               or (p.is_shard() and q.is_partial())
               for p, q in zip(a.placements, b.placements))


def add(op: str, a, b):
    """``a + b``; on a torch before 2.13 under a mesh, with a partial sum
    beside a shard (:func:`partial_beside_shard`), where DTensor's plan
    redistributes the shard to a partial sum, which that torch cannot,
    both operands gathered whole and added again (``op`` listed)."""
    try:
        return a + b
    except RuntimeError:
        if not (old_dtensor_on_mesh(a) and partial_beside_shard(a, b)):
            raise
    a, b = replicated(op, a, b)
    return a + b


def on_mesh(op: str) -> bool:
    """True under a mesh, where the caller runs ``op`` another way that
    DTensor has strategies for; ``op`` then joins
    :data:`REPLICATED_OPS`."""
    if _MESH[0] is None:
        return False
    if op not in REPLICATED_OPS:
        REPLICATED_OPS.append(op)
    return True


def head_split(x, n: int):
    """``x`` (B, ..., n·dh), whose last dim holds ``n`` heads, ready to be
    split into them or just merged from them: under a mesh, batch over the
    data axes and the last dim over 'model' when ``n`` divides it, else
    whole (the op then listed in :data:`REPLICATED_OPS`) — DTensor cannot
    split a dim sharded unevenly, nor (torch 2.11) flatten a sequence dim
    sharded over 'model' into the batch of a product. Off a mesh ``x`` as
    it is."""
    mesh = _MESH[0]
    if mesh is None:
        return x
    heads = n % model_size_of(mesh) == 0
    if not heads:
        op = "aten::view (heads split or merged, heads not dividing 'model')"
        if op not in REPLICATED_OPS:
            REPLICATED_OPS.append(op)
    return _place_raw(x, mesh, ("DP",) + (None,) * (x.ndim - 2)
                      + ("model" if heads else None,))


def local_heads(fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)``, attention over (B, S, H, dh) heads, run on
    each device's shards under a mesh (``local_map``): q, k and v placed
    batch over the data axes and heads over 'model' when both head counts
    divide it (else whole over 'model', the op listed in
    :data:`REPLICATED_OPS`), ``rest`` passed as they are. Every head
    attends on its own, so the shards need no collective; and DTensor
    need not split the products' flattened batch dims. Off a mesh,
    ``fn(q, k, v, *rest)``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    mesh = _MESH[0]
    if mesh is None or not isinstance(q, DTensor):
        return fn(q, k, v, *rest)
    m = model_size_of(mesh)
    heads = q.shape[2] % m == 0 and k.shape[2] % m == 0
    if not heads:
        op = "attention (heads not dividing 'model')"
        if op not in REPLICATED_OPS:
            REPLICATED_OPS.append(op)
    spec = ("DP", None, "model" if heads else None, None)
    q, k, v = (_place_raw(t, mesh, spec) for t in (q, k, v))
    pl = q.placements
    if k.placements != pl or v.placements != pl:
        raise ValueError(f"q, k, v placed {pl}, {k.placements}, "
                         f"{v.placements}")

    def run(*args):               # the hooks stay off the local shards
        _MESH[0] = None
        try:
            return fn(*args)
        finally:
            _MESH[0] = mesh

    return local_map(run, out_placements=(pl,),
                     in_placements=(pl, pl, pl) + (None,) * len(rest),
                     device_mesh=mesh)(q, k, v, *rest)


def local(x, dim: int):
    """``x``'s local shard, for an in-place write along ``dim`` that
    DTensor has no strategy for (each device writes its own shard; ``dim``
    must not be split); ``x`` itself if it is no DTensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    if any(getattr(p, "dim", None) == dim for p in x.placements):
        raise ValueError(f"a local write along dim {dim}, split in "
                         f"{x.placements}")
    return x.to_local()


def like(op: str, x, ref):
    """``x`` placed as ``ref`` is, for an in-place write of ``x`` into
    ``ref`` (``op``): DTensor would otherwise relabel ``ref``'s placements
    to ``x``'s and keep its local data. ``op`` joins
    :data:`REPLICATED_OPS` when this gathers ``x`` whole. Off a mesh, or
    for a plain ``ref``, ``x`` as it is."""
    from torch.distributed.tensor import DTensor

    mesh = _MESH[0]
    if mesh is None or not isinstance(ref, DTensor):
        return x
    if not isinstance(x, DTensor):
        x = _place(x, mesh, (None,) * x.ndim)
    if tuple(x.placements) == tuple(ref.placements):
        return x
    if all(p.is_replicate() for p in ref.placements):
        if op not in REPLICATED_OPS:
            REPLICATED_OPS.append(op)
    return x.redistribute(mesh, ref.placements)


def residual(x):
    """(B, S, D): batch over data axes, D replicated."""
    return constrain(x, ("DP", None, None))


def heads(x):
    """(B, S, H, dh): batch over data axes; heads over 'model' when they
    divide it, else sequence over 'model' (sequence-parallel attention —
    e.g. qwen3's 40 heads on a 16-wide model axis)."""
    mesh = _current_mesh()
    if mesh is None or x.ndim != 4:
        return x
    if x.shape[2] % model_size() == 0:
        return constrain(x, ("DP", None, "model", None))
    return constrain(x, ("DP", "model", None, None))


def ffn_hidden(x):
    """(B, S, F): wide intermediate over model."""
    return constrain(x, ("DP", None, "model"))


def logits(x):
    """(B, S, V): vocab over model."""
    return constrain(x, ("DP", None, "model"))


def expert_buf(x):
    """(E, C, D): expert-parallel over model when E divides it; else
    tensor-parallel experts — capacity over the data axes."""
    mesh = _current_mesh()
    if mesh is None or x.ndim != 3:
        return x
    if x.shape[0] % model_size() == 0:
        return constrain(x, ("model", None, None))
    return constrain(x, (None, "DP", None))


def dp_size() -> int:
    """Number of data-parallel shards in the active mesh (1 off-mesh)."""
    mesh = _current_mesh()
    if mesh is None:
        return 1
    sizes = mesh_axes(mesh)
    n = 1
    for a in _dp_axes(sizes):
        n *= sizes[a]
    return n


def model_size() -> int:
    """Size of the 'model' axis in the active mesh (1 off-mesh)."""
    mesh = _current_mesh()
    if mesh is None:
        return 1
    return model_size_of(mesh)


def model_size_of(mesh) -> int:
    return mesh_axes(mesh).get("model", 1)


def expert_block_buf(x):
    """(E, s, C_loc, D) block-dispatched expert buffer: blocks over DP,
    experts over model when divisible."""
    mesh = _current_mesh()
    if mesh is None or x.ndim != 4:
        return x
    e_ax = "model" if x.shape[0] % model_size() == 0 else None
    return constrain(x, (e_ax, "DP", None, None))


def expert_block_hidden(x):
    """(E, s, C_loc, F)."""
    mesh = _current_mesh()
    if mesh is None or x.ndim != 4:
        return x
    if x.shape[0] % model_size() == 0:
        return constrain(x, ("model", "DP", None, None))
    return constrain(x, (None, "DP", None, "model"))


def expert_weights(w, transposed: bool = False):
    """Use-site placement of tensor-parallel expert weights (E not
    divisible by 'model'): the FSDP shard on the F dim, the contraction
    dims whole. (E,D,F) or transposed (E,F,D)."""
    mesh = _current_mesh()
    if mesh is None or w.ndim != 3:
        return w
    if w.shape[0] % model_size() == 0:
        return w                       # expert-parallel path, leave alone
    spec = (None, ("model", "DP"), None) if transposed \
        else (None, None, ("model", "DP"))
    return constrain(w, spec)


def expert_hidden(x):
    """(E, C, F) expert intermediate: expert-parallel, or capacity×FF."""
    mesh = _current_mesh()
    if mesh is None or x.ndim != 3:
        return x
    if x.shape[0] % model_size() == 0:
        return constrain(x, ("model", None, None))
    return constrain(x, (None, "DP", "model"))


def ssm_state(x):
    """(B, di, ds): channels over model."""
    return constrain(x, ("DP", "model", None))
