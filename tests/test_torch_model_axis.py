"""The model axis's pieces on the CPU, in one process.

* the fed dry run (``launch.dryrun.run_fed``) trains through
  ``fed.distributed.train_sharded``, the function ``build_fed_step`` runs
  at M > 1 (``tests/test_torch_distributed_step.py`` counts its calls on
  gloo ranks): the counted program and the executed one are one;
* every ``kernels.ops`` wrapper refuses a DTensor with ``TypeError`` (a
  mesh rank hands the wire kernels plain slabs cut from its gathered
  model) and still takes the plain tensor;
* the transport books each call's ring bytes (``moved``) by the dry
  run's model (``collective_moved``) under the axis's name.

The DTensors live on a fake process group's mesh
(``launch.mesh.fake_mesh``), as the dry run's do.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.fed import collectives as col
from repro_torch.fed import distributed as fd
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh


@pytest.fixture(scope="module")
def mesh2():
    return fake_mesh((2, 2), ("data", "model"))


def test_fed_dry_run_trains_through_train_sharded(mesh2, monkeypatch):
    calls = []
    real = fd.train_sharded

    def spy(model, mesh, *args):
        calls.append(tuple(mesh.mesh_dim_names))
        return real(model, mesh, *args)

    monkeypatch.setattr(fd, "train_sharded", spy)
    rec = dryrun.run_fed("qwen3-14b", "fedpc_packed",
                         cfg=get_config("qwen3-14b").reduced(), mesh=mesh2,
                         local_batch=2, seq=16, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert calls == [("model",)]
    assert rec["collectives"]["bytes_by_axis"]["model"] > 0


def _dtensor(mesh2, x):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh2["model"], [Replicate()],
                              run_check=False)


RNG = torch.Generator().manual_seed(0)
SLAB = torch.randn(8, 128, generator=RNG)
CODES = torch.randint(-1, 2, (4, 8, 128), generator=RNG).to(torch.int8)
CALLS = {
    "ternary_encode": lambda a: ops.ternary_encode(a, SLAB, SLAB + 0.1,
                                                   0.2),
    "pack2bit": lambda a: ops.pack2bit(a.to(torch.int8)),
    "flat_ternary_pack_traced": lambda a: ops.flat_ternary_pack_traced(
        a, SLAB, SLAB + 0.1, t=torch.tensor(2, dtype=torch.int32),
        beta=torch.tensor(0.2), alpha1=torch.tensor(0.01)),
    "master_update": lambda a: ops.master_update(
        a, CODES, torch.full((4,), 0.25), SLAB, SLAB + 0.1),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_ops_refuse_a_dtensor(mesh2, name):
    CALLS[name](SLAB)                        # the plain slab is taken
    with pytest.raises(TypeError, match="DTensor"):
        CALLS[name](_dtensor(mesh2, SLAB))


def test_ring_bytes_booked_by_axis():
    axis = col.AxisGroup.meta(4, 1, "data")
    x = torch.empty((64, 128), dtype=torch.float32, device="meta")
    n = 64 * 128 * 4
    with col.recording() as rec:
        col.psum(x, axis)
        col.all_gather(x, axis)
        col.psum_scatter(x, axis)
    want = (col.collective_moved("all-reduce", n, 4)
            + col.collective_moved("all-gather", 4 * n, 4)
            + col.collective_moved("reduce-scatter", n // 4, 4))
    assert rec.stats["moved"] == {"data": want}
    assert rec.stats["axis_bytes"] == {"data": 3 * n}
