"""The port's meshes, the counterpart of the JAX package's ``launch.mesh``.

The debug mesh is an (F fed × M model) grid of ``torch.distributed``
ranks. Rank ``r`` sits at ``(r // M, r % M)``, as ``devices.reshape(F,
M)`` lays a JAX mesh out. Each axis is a
:class:`~repro_torch.fed.collectives.AxisGroup`: along ``"data"`` the F
ranks that share a model index (the fed axis the round's wire crosses),
along ``"model"`` the M ranks of one fed worker.

The production meshes are H100 clusters of the reference's chip counts,
256 and 512, with the model axis inside one 8-GPU NVLink node. The dry
run (``launch.dryrun``) lays them out as a ``DeviceMesh`` over a fake
process group (:func:`fake_mesh`): a trace on ``meta`` tensors in one
process, with no card. The hardware constants below are NVIDIA's
datasheet figures for the card (NVIDIA H100 80GB HBM3, SXM5, at its 700 W
limit), not measurements; the roofline (``launch.analysis``) divides by
them. Defined as functions, so importing this module touches no process
group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch.distributed as dist

from repro_torch.fed.collectives import AxisGroup

AXES = ("data", "model")

# NVIDIA H100 80GB HBM3 (SXM5, 700 W), datasheet figures, not measured:
PEAK_FLOPS_BF16 = 989e12   # dense bf16 tensor-core FLOP/s a GPU
HBM_BW = 3.35e12           # HBM3 bytes/s a GPU
HBM_BYTES = 80e9           # HBM bytes a GPU
NVLINK_BW = 450e9          # NVLink 4 bytes/s a GPU, one direction
NET_BW = 50e9              # one 400 Gb/s NIC a GPU, bytes/s

SINGLE_POD = (32, 8)       # 256 GPUs: 32 nodes of 8
MULTI_POD = (2, 32, 8)     # 2 pods × 256 GPUs


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
                   {"data": AxisGroup.meta(n_data, f, "data"),
                    "model": AxisGroup.meta(n_model, m, "model")})


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
                                       tuple(ranks), backend, name)
    return Mesh({"data": n_data, "model": n_model}, axes)


def fake_mesh(shape: tuple, axes: tuple):
    """A ``DeviceMesh`` of ``shape`` over ``axes``, over a fake process
    group, which this call makes in this process unless one is there
    (rank 0's view of the mesh; no card, no peer). Its ranks are CPU ranks,
    so that DTensor's shape propagation runs where torch has no CUDA; the
    counter counts the all-to-all a CUDA mesh would run where DTensor
    stands in an all-gather for it
    (``hlo_stats.OpCounter.alltoall_on_cpu_mesh``)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        world = MULTI_POD[0] * MULTI_POD[1] * MULTI_POD[2]
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=max(world, n))
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The 256-GPU ``("data", "model")`` mesh, or with ``multi_pod`` the
    512-GPU ``("pod", "data", "model")`` one (:func:`fake_mesh`)."""
    if multi_pod:
        return fake_mesh(MULTI_POD, ("pod", "data", "model"))
    return fake_mesh(SINGLE_POD, ("data", "model"))


def chips(mesh) -> int:
    """The number of devices of a ``DeviceMesh``."""
    return mesh.size()


def mesh_shape_name(mesh) -> str:
    """``"32x8"``: a ``DeviceMesh``'s shape as the records name it."""
    return "x".join(str(s) for s in mesh.shape)
