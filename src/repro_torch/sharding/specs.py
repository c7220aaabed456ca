"""Which rows of the flat wire buffers a (fed, model) rank holds: the wire
part of the JAX package's ``sharding.specs`` (``wire_specs``).

The ``(rows, 128)`` buffers of ``core.flat`` split their rows over the
model axis: model rank ``m`` of ``M`` holds the slab ``[m·rows/M,
(m+1)·rows/M)`` (``layout_of(..., shards=M)`` pads rows to make the slabs
whole and aligned). The worker buffers split their worker axis over the
fed axis as well, which on a mesh of processes means that fed rank ``f``
only ever has worker ``f``'s own model. The roles are the JAX package's
PartitionSpecs a rank reads: ``stacked`` (a worker's buffer) and
``history`` (the public P^{t-1}/P^{t-2}, replicated over fed). The new
global buffer comes back whole: the runtime gathers it over the model
axis.
"""
from __future__ import annotations


def wire_specs(rows: int, n_model: int, model_index: int | None) -> dict:
    """``{"stacked", "history"}``: the row slice of a (rows, 128)
    buffer that model rank ``model_index`` of ``n_model`` holds in each
    role; ``model_index=None`` is the replicated wire (every row)."""
    if model_index is None:
        rs = slice(0, rows)
    elif rows % n_model:
        raise ValueError(f"{rows} rows do not split into {n_model} slabs")
    else:
        sr = rows // n_model
        rs = slice(model_index * sr, (model_index + 1) * sr)
    return {"stacked": rs, "history": rs}
