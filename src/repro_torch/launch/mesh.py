"""The port's mesh: an (F fed × M model) grid of ``torch.distributed``
ranks, the counterpart of the JAX package's ``launch.mesh`` debug mesh.

Rank ``r`` sits at ``(r // M, r % M)``, as ``devices.reshape(F, M)`` lays a
JAX mesh out. Each axis is a :class:`~repro_torch.fed.collectives.AxisGroup`:
along ``"data"`` the F ranks that share a model index (the fed axis the
round's wire crosses), along ``"model"`` the M ranks of one fed worker.
The TPU's production meshes and hardware constants do not carry over.
"""
from __future__ import annotations

from typing import NamedTuple

import torch.distributed as dist

from repro_torch.fed.collectives import AxisGroup

AXES = ("data", "model")


class Mesh(NamedTuple):
    """This rank's view of the mesh: ``shape`` maps each axis name to its
    size, ``axes`` to its :class:`AxisGroup`."""
    shape: dict
    axes: dict

    @classmethod
    def meta(cls, n_data: int, n_model: int = 1, rank: int = 0) -> "Mesh":
        """Rank ``rank``'s view of an (n_data, n_model) mesh with no
        process group: enough for a recording (an audit, a payload list)
        or a refusal."""
        f, m = divmod(rank, n_model)
        return cls({"data": n_data, "model": n_model},
                   {"data": AxisGroup.meta(n_data, f),
                    "model": AxisGroup.meta(n_model, m)})


def make_debug_mesh(n_data: int = 4, n_model: int = 2) -> Mesh:
    """The (n_data, n_model) mesh over the default process group, which
    the caller made with the backend of its choice and a world of
    ``n_data · n_model`` ranks. Every rank must call it (it makes every
    axis's process groups, in one order on all ranks)."""
    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs torch.distributed's "
                           "default process group; init_process_group first")
    world = dist.get_world_size()
    if world != n_data * n_model:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} ranks, the group has {world}")
    rank = dist.get_rank()
    backend = dist.get_backend()
    axes = {}
    for name, size, lines in (
            ("data", n_data, [[f * n_model + m for f in range(n_data)]
                              for m in range(n_model)]),
            ("model", n_model, [[f * n_model + m for m in range(n_model)]
                                for f in range(n_data)])):
        for ranks in lines:
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                axes[name] = AxisGroup(group, size, ranks.index(rank),
                                       tuple(ranks), backend)
    return Mesh({"data": n_data, "model": n_model}, axes)

