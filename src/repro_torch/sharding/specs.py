"""Placement rules: the FSDP + tensor-parallel layout of the model zoo, the
JAX package's ``sharding/specs.py`` with the same rules, roles and
first-match order.

Conventions (see models/*):
  * block params are stacked along a leading ``units`` axis — that axis is
    never sharded;
  * column-parallel weights (D, F): D→data axes (FSDP), F→model axis;
  * row-parallel weights (F, D): F→model, D→data;
  * MoE expert stacks (E, D, F): expert-parallel over 'model' when E divides
    the model-axis size, else tensor-parallel inside each expert;
  * embeddings: vocab over 'model' (in), lm_head vocab over 'model' (out,
    Megatron-style sharded logits), other dim over data axes;
  * norms/scalars: replicated.

Multi-pod: the data shards span ('pod', 'data') — full FSDP across all
chips.

A spec is :class:`P`, a tuple with one entry a tensor dim: ``None``, an
axis name, or a tuple of names; it equals the reference's
``PartitionSpec`` read through ``tuple(...)``. A mesh is anything that
names its axes and their sizes: a ``torch.distributed`` ``DeviceMesh``
(``mesh_dim_names``), an object with ``axis_names`` and a ``shape``
mapping, or ``launch.mesh.Mesh``. :func:`placements` turns a spec into
DTensor placements on a ``DeviceMesh``.

The wire part (:func:`wire_specs`) is which rows of the flat wire buffers
a (fed, model) rank holds: the ``(rows, 128)`` buffers of ``core.flat``
split their rows over the model axis (model rank ``m`` of ``M`` holds the
slab ``[m·rows/M, (m+1)·rows/M)``; ``layout_of(..., shards=M)`` pads rows
to make the slabs whole and aligned), and the worker buffers their worker
axis over the fed axis as well, so that fed rank ``f`` only ever has
worker ``f``'s own model.
"""
from __future__ import annotations

import re
from typing import Any

from repro_torch.utils import tree_flatten, tree_unflatten

PyTree = Any


class P(tuple):
    """A partition spec: ``P(None, "data", ("model", "data"))``."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def spec_leaves(tree) -> list:
    """The :class:`P` leaves of a spec tree in ``tree_flatten`` order (a
    spec is a tuple, which ``tree_flatten`` would walk into)."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for c in tree for s in spec_leaves(c)]
    return [tree]


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` in the mesh's axis order."""
    if hasattr(mesh, "mesh_dim_names"):                  # DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    if hasattr(mesh, "axis_names"):
        return {a: mesh.shape[a] for a in mesh.axis_names}
    return dict(mesh.shape)


def data_axes(mesh) -> tuple[str, ...]:
    """The axes that jointly play the 'data/FSDP' role."""
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def _ax(axes):
    """Normalize a 1-tuple of axis names to the bare name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _div(n: int, axis_size: int) -> bool:
    return axis_size > 0 and n % axis_size == 0


def _axis_size(sizes: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    s = 1
    for a in axes:
        s *= sizes[a]
    return s


# Leaf-name regexes → role. First match wins.
_RULES: list[tuple[str, str]] = [
    (r"(^|/)embed$", "embed"),
    (r"(^|/)lm_head$", "lm_head"),
    (r"(^|/)(wq|wk|wv|w_gate|w_up|in_proj|dt_proj|up_proj|audio_proj|patch_proj)$", "col"),
    (r"(^|/)(wo|w_down|out_proj)$", "row"),
    (r"(^|/)router$", "router"),
    (r"(^|/)experts_(gate|up)$", "expert_col"),
    (r"(^|/)experts_down$", "expert_row"),
    (r"(^|/)(x_proj)$", "row"),          # (d_inner, k): d_inner is model-sharded
    (r"(^|/)(A_log)$", "ssm_state"),     # (d_inner, d_state)
    (r"(^|/)(conv_w)$", "conv"),         # (d_conv, d_inner)
    (r"(^|/)(D_skip|dt_bias|conv_b)$", "vec_model"),  # (d_inner,)
    (r"(^|/)(q_norm|k_norm|norm|norm1|norm2|norm3|norm_f|scale|bias|gates_b)$", "rep"),
    (r"(^|/)(gates_w)$", "col"),         # lstm gate projections (D, k*di)
    (r"(^|/)(r_gates_w)$", "lstm_rec"),  # slstm recurrent (di, k*di)
]


def _role(path: str) -> str:
    for pat, role in _RULES:
        if re.search(pat, path):
            return role
    return "auto"


def _spec_for(role: str, shape: tuple[int, ...], mesh,
              stacked: bool) -> P:
    """Build a spec for the *unstacked* trailing dims, then prepend None
    for the units axis if stacked."""
    sizes = mesh_axes(mesh)
    dp = data_axes(mesh)
    dp_sz = _axis_size(sizes, dp)
    mp_sz = sizes.get("model", 1)
    dims = shape[1:] if stacked else shape
    nd = len(dims)

    def fits(i, sz):
        return _div(dims[i], sz)

    spec: list = [None] * nd
    if role == "embed" and nd == 2:                      # (V, D)
        if fits(0, mp_sz):
            spec[0] = "model"
        if fits(1, dp_sz):
            spec[1] = _ax(dp)
    elif role == "lm_head" and nd == 2:                  # (D, V)
        if fits(0, dp_sz):
            spec[0] = _ax(dp)
        if fits(1, mp_sz):
            spec[1] = "model"
    elif role == "col" and nd == 2:                      # (D, F)
        if fits(0, dp_sz):
            spec[0] = _ax(dp)
        if fits(1, mp_sz):
            spec[1] = "model"
    elif role == "row" and nd == 2:                      # (F, D)
        if fits(0, mp_sz):
            spec[0] = "model"
        if fits(1, dp_sz):
            spec[1] = _ax(dp)
    elif role == "router" and nd == 2:                   # (D, E)
        if fits(0, dp_sz):
            spec[0] = _ax(dp)
    elif role in ("expert_col", "expert_row") and nd == 3:  # (E, D, F)/(E, F, D)
        if fits(0, mp_sz):                               # expert-parallel
            spec[0] = "model"
            inner = 1 if role == "expert_col" else 2     # the D dim
            if fits(inner, dp_sz):
                spec[inner] = _ax(dp)
        else:
            # tensor-parallel experts: the FSDP shard rides on the F dim
            # together with 'model', so the contraction dims stay whole
            # and the weights, not the (E, C, ·) activations, are gathered
            f_axes = ("model",) + dp
            if role == "expert_col":                     # (E, D, F)
                if fits(2, mp_sz * dp_sz):
                    spec[2] = f_axes
                elif fits(2, mp_sz):
                    spec[2] = "model"
            else:                                        # (E, F, D)
                if fits(1, mp_sz * dp_sz):
                    spec[1] = f_axes
                elif fits(1, mp_sz):
                    spec[1] = "model"
    elif role == "ssm_state" and nd == 2:                # (d_inner, d_state)
        if fits(0, mp_sz):
            spec[0] = "model"
    elif role == "conv" and nd == 2:                     # (d_conv, d_inner)
        if fits(1, mp_sz):
            spec[1] = "model"
    elif role == "vec_model" and nd == 1:
        if fits(0, mp_sz):
            spec[0] = "model"
    elif role == "lstm_rec" and nd == 2:                 # (di, k*di)
        if fits(1, mp_sz):
            spec[1] = "model"
    elif role == "rep":
        pass
    else:  # auto: shard the last dim over model, the first over data
        if nd >= 1 and fits(nd - 1, mp_sz):
            spec[nd - 1] = "model"
        if nd >= 2 and fits(0, dp_sz):
            spec[0] = _ax(dp)

    if stacked:
        spec = [None] + spec
    return P(*spec)


def _paths(node, prefix: str, out: list) -> None:
    """Leaf paths in ``tree_flatten`` order, named as ``jax.tree_util``
    names them: dict keys, NamedTuple fields, sequence indices."""
    if isinstance(node, dict):
        for k in sorted(node):
            _paths(node[k], f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for k, c in zip(node._fields, node):
            _paths(c, f"{prefix}/{k}" if prefix else k, out)
    elif isinstance(node, (list, tuple)):
        for i, c in enumerate(node):
            _paths(c, f"{prefix}/{i}" if prefix else str(i), out)
    else:
        out.append(prefix)


def tree_paths(tree: PyTree) -> list[str]:
    """Each leaf's ``a/b/c`` path, in ``tree_flatten`` order."""
    out: list = []
    _paths(tree, "", out)
    return out


def param_specs(params: PyTree, mesh,
                stacked_prefixes: tuple[str, ...] = ("blocks", "units",
                                                     "encoder_blocks",
                                                     "decoder_blocks")) -> PyTree:
    """A spec tree matching ``params``."""
    leaves, treedef = tree_flatten(params)
    specs = []
    for p, leaf in zip(tree_paths(params), leaves):
        stacked = any(p.startswith(pre + "/") or f"/{pre}/" in p
                      for pre in stacked_prefixes)
        specs.append(_spec_for(_role(p), tuple(leaf.shape), mesh, stacked))
    return tree_unflatten(treedef, specs)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: a
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` names, ``Replicate``
    on the others. A dim over ("model", "data") becomes two ``Shard(d)``;
    DTensor splits a dim mesh-dim-major, so the shards lie in another
    order than the reference's, with the same local shape on each
    device."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else ax):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def param_shardings(params: PyTree, mesh) -> PyTree:
    """The placements of :func:`param_specs` on a ``DeviceMesh``, a tuple
    a leaf of ``params``."""
    treedef = tree_flatten(params)[1]
    return tree_unflatten(treedef, [placements(s, mesh) for s in
                                    spec_leaves(param_specs(params, mesh))])


def wire_specs(rows: int, n_model: int, model_index: int | None) -> dict:
    """``{"stacked", "history"}``: the row slice of a (rows, 128)
    buffer that model rank ``model_index`` of ``n_model`` holds in each
    role (a worker's buffer; the public P^{t-1}/P^{t-2}, replicated over
    fed); ``model_index=None`` is the replicated wire (every row). The
    new global buffer comes back whole: the runtime gathers it over the
    model axis."""
    if model_index is None:
        rs = slice(0, rows)
    elif rows % n_model:
        raise ValueError(f"{rows} rows do not split into {n_model} slabs")
    else:
        sr = rows // n_model
        rs = slice(model_index * sr, (model_index + 1) * sr)
    return {"stacked": rs, "history": rs}


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> P:
    """Tokens/labels (B, S, ...): shard B over the data axes if divisible."""
    sizes = mesh_axes(mesh)
    dp = data_axes(mesh)
    if _div(batch, _axis_size(sizes, dp)):
        return P(_ax(dp), *([None] * extra_dims))
    # fall back to sharding over just 'data'
    if _div(batch, sizes.get("data", 1)):
        return P("data", *([None] * extra_dims))
    return P(*([None] * (1 + extra_dims)))


def cache_specs(cache: PyTree, mesh, batch: int) -> PyTree:
    """KV / SSM state sharding. Rank-4 KV caches (B, S, H, dh): batch over
    data axes when divisible, else sequence over data axes; heads over model
    when divisible. Rank-3 SSM states (B, di, ds): di over model. Scalars
    (positions) replicated. The rules read a leaf's own dims, as the
    reference's do: a unit-stacked (units, B, S, H, dh) KV cache has rank 5
    and stays replicated, a stacked (units, B, di, ds) Mamba state is read
    as (B, S, H, dh)."""
    sizes = mesh_axes(mesh)
    dp = data_axes(mesh)
    dp_sz = _axis_size(sizes, dp)
    mp_sz = sizes.get("model", 1)

    def spec(leaf):
        s = tuple(leaf.shape)
        if len(s) == 4:  # (B, S, H, dh)
            b = _ax(dp) if _div(s[0], dp_sz) else None
            seq = _ax(dp) if (b is None and _div(s[1], dp_sz)) else None
            h = "model" if _div(s[2], mp_sz) else None
            return P(b, seq, h, None)
        if len(s) == 3:  # (B, d_inner, d_state) or (B, d_conv, d_inner)
            b = _ax(dp) if _div(s[0], dp_sz) else None
            mid = "model" if _div(s[1], mp_sz) else None
            last = None
            if mid is None and _div(s[2], mp_sz):
                last = "model"
            return P(b, mid, last)
        if len(s) == 2:  # (B, d) lstm hidden
            b = _ax(dp) if _div(s[0], dp_sz) else None
            d = "model" if _div(s[1], mp_sz) else None
            return P(b, d)
        return P()

    leaves, treedef = tree_flatten(cache)
    return tree_unflatten(treedef, [spec(x) for x in leaves])
