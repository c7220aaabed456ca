"""The port's placement rules (``repro_torch.sharding.specs``) against the
JAX package's ``repro.sharding.specs``: the reference's own six cases on
its duck-typed mesh, then ``param_specs`` (params and the momentum state),
``cache_specs`` and ``batch_spec`` leaf by leaf, by path, for every
registered config at full size on four mesh shapes — the JAX trees from
``jax.eval_shape``, the port's on ``meta``. No device is needed."""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget
from repro.configs import list_configs as jlist
from repro.launch.specs import SHAPES as JSHAPES
from repro.models import build_model as jbuild
from repro.optim.optimizers import momentum as jmomentum
from repro.sharding import specs as js
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_configs
from repro_torch.launch.specs import SHAPES
from repro_torch.models import build_model as tbuild
from repro_torch.optim.optimizers import momentum as tmomentum
from repro_torch.sharding import specs as ts
from repro_torch.sharding.specs import P


class FakeMesh:
    """Duck-typed mesh: specs.py only touches .axis_names and .shape."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH_MP = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = (MESH, MESH_MP, FakeMesh({"data": 32, "model": 8}),
          FakeMesh({"data": 4, "model": 2}))


def _sds(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- the reference's cases ---------------------------------------------------

def test_col_row_rules():
    params = {
        "units": {"b0": {
            "mixer": {"wq": _sds((2, 5120, 4096)), "wo": _sds((2, 4096, 5120))},
            "ffn": {"w_up": _sds((2, 5120, 14336)),
                    "w_down": _sds((2, 14336, 5120))},
            "norm1": _sds((2, 5120)),
        }},
        "embed": _sds((131072, 5120)),
        "lm_head": _sds((5120, 131072)),
    }
    specs = ts.param_specs(params, MESH)
    b0 = specs["units"]["b0"]
    assert b0["mixer"]["wq"] == P(None, "data", "model")
    assert b0["mixer"]["wo"] == P(None, "model", "data")
    assert b0["ffn"]["w_down"] == P(None, "model", "data")
    assert b0["norm1"] == P(None, None)                # replicated
    assert specs["embed"] == P("model", "data")
    assert specs["lm_head"] == P("data", "model")


def test_expert_rules_divisible_vs_not():
    p64 = {"units": {"b0": {"ffn": {
        "experts_gate": _sds((2, 64, 2048, 1408)),
        "experts_down": _sds((2, 64, 1408, 2048)),
    }}}}
    s = ts.param_specs(p64, MESH)["units"]["b0"]["ffn"]
    assert s["experts_gate"][1] == "model"
    p8 = {"units": {"b0": {"ffn": {
        "experts_gate": _sds((2, 8, 6144, 32768)),
        "experts_down": _sds((2, 8, 32768, 6144)),
    }}}}
    s8 = ts.param_specs(p8, MESH)["units"]["b0"]["ffn"]
    assert s8["experts_gate"][1] is None
    assert s8["experts_gate"][2] is None        # contraction dim unsharded
    assert s8["experts_gate"][3] == ("model", "data")
    assert s8["experts_down"][2] == ("model", "data")


def test_non_divisible_falls_back_to_replication():
    params = {"units": {"b0": {"mixer": {"wq": _sds((2, 37, 53))}}}}
    spec = ts.param_specs(params, MESH)["units"]["b0"]["mixer"]["wq"]
    assert spec == P(None, None, None)


def test_batch_spec():
    assert ts.batch_spec(MESH, 256) == P("data", None)
    assert ts.batch_spec(MESH_MP, 256) == P(("pod", "data"), None)
    assert ts.batch_spec(MESH, 1) == P(None, None)        # long_500k B=1


def test_cache_specs_kv_and_ssm():
    cache = {
        "kv": {"k": _sds((128, 32768, 8, 128), torch.bfloat16)},
        "ssm": {"h": _sds((128, 16384, 16))},
        "b1": {"k": _sds((1, 524288, 8, 128), torch.bfloat16)},
    }
    specs = ts.cache_specs(cache, MESH, 128)
    assert specs["kv"]["k"][0] == "data"            # batch sharded
    assert specs["ssm"]["h"][1] == "model"             # channels sharded
    assert specs["b1"]["k"][0] is None
    assert specs["b1"]["k"][1] == "data"


def test_multipod_param_sharding():
    params = {"units": {"b0": {"ffn": {"w_up": _sds((2, 8192, 24576))}}}}
    spec = ts.param_specs(params, MESH_MP)["units"]["b0"]["ffn"]["w_up"]
    assert spec == P(None, ("pod", "data"), "model")


def test_placements_on_a_device_mesh():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import fake_mesh
    mesh = fake_mesh((4, 2), ("data", "model"))
    assert ts.placements(P(None, "data", "model"), mesh) == (Shard(1),
                                                             Shard(2))
    assert ts.placements(P(None, ("model", "data")), mesh) == (Shard(1),
                                                               Shard(1))
    assert ts.placements(P(), mesh) == (Replicate(), Replicate())
    got = ts.param_shardings({"wq": _sds((8, 6)), "norm": _sds((6,))}, mesh)
    assert got == {"wq": (Shard(0), Shard(1)),
                   "norm": (Replicate(), Replicate())}


# -- every registered config, leaf by leaf -----------------------------------

def test_the_registries_agree():
    assert sorted(jlist()) == sorted(list_configs())


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {js._path_str(p): tuple(s) for p, s in flat}


def _port_specs(tree, specs):
    return dict(zip(ts.tree_paths(tree), ts.spec_leaves(specs)))


@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_specs_equal_the_reference_at_full_size(arch):
    jcfg = jget(arch).replace(param_dtype="bfloat16")
    tcfg = tget(arch).replace(param_dtype="bfloat16")
    jm = jbuild(jcfg, optimizer=jmomentum(accum_dtype=jnp.bfloat16))
    tm = tbuild(tcfg, optimizer=tmomentum(accum_dtype=torch.bfloat16))
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tp = tm.init(None, device="meta")
    trees = [(jp, tp), (jax.eval_shape(jm.optimizer.init, jp),
                        tm.optimizer.init(tp))]
    caches = {}
    for name, info in SHAPES.items():
        key = (info["batch"], info["seq"])
        if info["kind"] != "train" and key not in caches:
            caches[key] = (jax.eval_shape(
                lambda b=key[0], s=key[1]: jm.init_decode_state(b, s)),
                tm.init_decode_state(*key, device="meta"))
    assert JSHAPES == SHAPES
    for mesh in MESHES:
        for jt, tt in trees:
            want = _jax_specs(js.param_specs(jt, mesh))
            got = _port_specs(tt, ts.param_specs(tt, mesh))
            assert list(got) == list(want)     # same paths, same order
            assert got == want, mesh.shape
        for (b, _), (jc, tc) in caches.items():
            want = _jax_specs(js.cache_specs(jc, mesh, b))
            got = _port_specs(tc, ts.cache_specs(tc, mesh, b))
            assert got == want, (mesh.shape, b)
            assert tuple(ts.batch_spec(mesh, b, 1)) == tuple(
                js.batch_spec(mesh, b, 1))
            assert tuple(ts.batch_spec(mesh, b, 2)) == tuple(
                js.batch_spec(mesh, b, 2))
