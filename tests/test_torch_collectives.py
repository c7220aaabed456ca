"""The fed-axis transport (``fed.collectives``) and the collective audit
(``privacy.audit.check_fed_collectives``).

* The transport on four gloo ranks on the CPU, meshes (4, 1) and (2, 2):
  ``uint32`` sums that wrap past 2**32 and ``uint16`` sums widened to
  ``int32`` give the modular sums exactly; gathers of the refused dtypes
  move their bytes; f16/f32 sums; ``ppermute`` by XOR pairs and a shift
  (a rank nobody sends to receives zeros); each rank's index.
* The payloads one run of the port's sync moves across the fed axis
  (primitive, shape, dtype, in order; recorded on ``meta`` tensors, no
  process group) equal the JAX package's ``collective_payloads`` of its
  sync on ``Mesh(devs, ("data", "model"))``, for every strategy, the
  masked wire at 16 and 32 bits, the tree and the fault plan.
* ``check_fed_collectives`` refuses leaky programs built through the
  transport's seam with the JAX audit's own texts, refuses the plaintext
  wire under the masked policy, and passes the masked wire.
"""
import json

import numpy as np
import pytest
import torch

import _torch_dist as H
from repro_torch.core import flat as fl
from repro_torch.core.privacy import LeakageError
from repro_torch.core.tree import TreeSpec
from repro_torch.fed import collectives as col
from repro_torch.fed.distributed import build_fed_sync, fed_state_init
from repro_torch.fed.faults import FaultPlan
from repro_torch.launch.mesh import Mesh
from repro_torch.privacy import PrivacySpec
from repro_torch.privacy.audit import (check_fed_collectives,
                                       collective_payloads)

CONFIGS = H.AUDIT_CONFIGS

ORACLE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
import _torch_dist as H
from repro.core.privacy import LeakageError
from repro.core.tree import TreeSpec
from repro.fed.distributed import build_fed_sync, fed_state_init
from repro.fed.faults import FaultPlan
from repro.privacy import PrivacySpec, check_fed_collectives
from repro.privacy import collective_payloads

out = {"payloads": {}, "audits": {}}
for F, M in H.MESHES:
    mesh = Mesh(np.array(jax.devices()[:F * M]).reshape(F, M),
                ("data", "model"))
    x = H.inputs(F, 3)
    params_F = {k: jnp.stack([jnp.asarray(l[k]) for l in x["local"]])
                for k in x["params"]}
    state = fed_state_init(jax.tree_util.tree_map(jnp.asarray, x["params"]),
                           F)
    for name, strat, spec, fanout, faults in H.AUDIT_CONFIGS:
        kw = {}
        if spec:
            kw["privacy"] = PrivacySpec(**H.SPECS[spec])
        if fanout:
            kw["tree"] = TreeSpec(fanout=fanout)
        if faults:
            kw["faults"] = FaultPlan(**H.FAULTS)
        with mesh:
            sync = build_fed_sync(None, mesh, "data", strat, **kw)
            pl = collective_payloads(sync, params_F, jnp.asarray(x["costs"]),
                                     jnp.asarray(x["sizes"]), state,
                                     jnp.asarray(x["mask"]))
        out["payloads"][f"{F}x{M}_{name}"] = [
            [p["primitive"], list(p["shape"]), p["dtype"]] for p in pl]

mesh = Mesh(np.array(jax.devices()[:4]).reshape(4, 1), ("data", "model"))
LEAKY = {
    "stacked_float": (lambda x: jax.lax.psum(x, "data"), (16, 16, 128),
                      jnp.float32, False),
    "codes": (lambda x: jax.lax.all_gather(x.astype(jnp.int8), "data"),
              (64, 128), jnp.float32, True),
    "signed": (lambda x: jax.lax.psum(x.astype(jnp.int32), "data"),
               (64, 128), jnp.float32, True),
    "words": (lambda x: jax.lax.psum(x, "data"), (64, 128), jnp.uint16,
              True),
}
for name, (body, shape, dtype, masked) in LEAKY.items():
    fn = jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                       out_specs=P("data"), check_vma=False)
    try:
        check_fed_collectives(fn, jnp.zeros(shape, dtype), n_fed=4,
                              masked=masked)
        out["audits"][name] = "passed"
    except LeakageError as e:
        out["audits"][name] = str(e)
np.savez(sys.argv[2], result=np.array(json.dumps(out)))
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    res = H.oracle_result(H.start_oracle(ORACLE, str(d / "oracle.npz")))
    return json.loads(str(res["result"]))


@pytest.fixture(scope="module")
def transport(tmp_path_factory):
    d = tmp_path_factory.mktemp("transport")
    return {mesh: H.run_ranks({"task": "transport", "F": mesh[0],
                               "M": mesh[1]}, str(d))
            for mesh in H.MESHES}


def _fed_rows(res, F, M):
    """Per-rank results in fed order for model index 0."""
    return {k: v[[f * M for f in range(F)]] for k, v in res.items()}


MESH_IDS = dict(ids=lambda m: f"{m[0]}x{m[1]}")


@pytest.mark.parametrize("mesh", H.MESHES, **MESH_IDS)
def test_word_sums_wrap_exactly(transport, mesh):
    F, M = mesh
    got = _fed_rows(transport[mesh], F, M)
    u32 = np.array([[0xFFFFFFF0 + i, 7 * i, 0x80000000 + i]
                    for i in range(F)], np.uint64)
    want32 = (u32.sum(0) % 2 ** 32).astype(np.uint32)
    u16 = np.array([[0xFFF0 + i, 3 * i, 0x8000 + i, 0xFFFF]
                    for i in range(F)], np.uint64)
    want16 = (u16.sum(0) % 2 ** 16).astype(np.uint16)
    assert (want32 < u32.max(0)).any()          # the sum did wrap
    for r in range(F):
        np.testing.assert_array_equal(got["u32"][r], want32)
        np.testing.assert_array_equal(got["u16"][r], want16)
    ys = np.stack([np.arange(8 * F).reshape(2 * F, 4) + 0xFFF0 + i
                   for i in range(F)]).sum(0) % 2 ** 16
    for r in range(F):
        np.testing.assert_array_equal(got["u16_scatter"][r],
                                      ys[2 * r:2 * r + 2])


@pytest.mark.parametrize("mesh", H.MESHES, **MESH_IDS)
def test_gathers_move_every_dtype(transport, mesh):
    F, M = mesh
    got = _fed_rows(transport[mesh], F, M)
    u16 = np.array([[0xFFF0 + i, 3 * i, 0x8000 + i, 0xFFFF]
                    for i in range(F)], np.uint16)
    u32 = np.array([[0xFFFFFFF0 + i, 7 * i, 0x80000000 + i]
                    for i in range(F)], np.uint64).astype(np.uint32)
    for r in range(F):
        np.testing.assert_array_equal(got["u16_gather"][r],
                                      u16)
        np.testing.assert_array_equal(
            got["u32_gather_tiled"][r], u32.reshape(-1))
        np.testing.assert_array_equal(
            got["i8_gather"][r],
            np.array([[-1, 0, 1]], np.int8) * np.arange(1, F + 1,
                                                        dtype=np.int8)[:, None])


@pytest.mark.parametrize("mesh", H.MESHES, **MESH_IDS)
def test_float_sums_and_permutes(transport, mesh):
    F, M = mesh
    got = _fed_rows(transport[mesh], F, M)
    tri = F * (F + 1) // 2
    for r in range(F):
        np.testing.assert_array_equal(got["f32_psum"][r],
                                      np.float32([0.5, -2.0]) * tri)
        np.testing.assert_allclose(got["f16_psum"][r].astype(np.float32),
                                   np.float32([0.1, 1000.0]) * tri,
                                   rtol=2 * F * 2.0 ** -11)
        want = np.array([0xFFF0 + (r ^ 1), 3 * (r ^ 1), 0x8000 + (r ^ 1),
                         0xFFFF], np.uint16)
        np.testing.assert_array_equal(got["xor1"][r], want)
        np.testing.assert_array_equal(got["shift"][r],
                                      np.full(3, max(r - 1, 0), np.float32))
        assert int(got["index"][r][0]) == r


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c[0])
@pytest.mark.parametrize("mesh", H.MESHES, **MESH_IDS)
def test_payloads_equal_the_jax_runtime(oracle, mesh, config):
    F, M = mesh
    name, strat, spec, fanout, faults = config
    kw = {}
    if spec:
        kw["privacy"] = PrivacySpec(**H.SPECS[spec])
    if fanout:
        kw["tree"] = TreeSpec(fanout=fanout)
    if faults:
        kw["faults"] = FaultPlan(**H.FAULTS)
    sync = build_fed_sync(None, Mesh.meta(F, M), "data", strat,
                          device="cpu", **kw)
    x = H.inputs(F, 3)
    state = fed_state_init({k: torch.from_numpy(np.array(v))
                            for k, v in x["params"].items()}, F)
    local = {k: torch.from_numpy(np.array(v))
             for k, v in x["local"][0].items()}
    got = collective_payloads(sync, local, torch.from_numpy(x["costs"]),
                              torch.from_numpy(x["sizes"]), state,
                              torch.from_numpy(x["mask"]))
    want = oracle["payloads"][f"{F}x{M}_{name}"]
    got = [[p["primitive"], list(p["shape"]), p["dtype"]] for p in got]
    if strat == "fedavg":
        # The JAX sync averages the stacked params with a plain jnp sum,
        # which XLA partitions into a cross-device reduce that no jaxpr
        # collective shows; the port's is that one psum of its slab.
        assert want == []
        sr = fl.layout_of(state["params"], shards=M).shard_rows
        assert got == [["psum", [sr, 128], "float32"]]
    else:
        assert got == want


def _leaky(name):
    ax = col.AxisGroup.meta(4, 0)
    return {
        "stacked_float": (lambda x: col.psum(x, ax), (4, 16, 128),
                          torch.float32, False),
        "codes": (lambda x: col.all_gather(x.to(torch.int8), ax),
                  (16, 128), torch.float32, True),
        "signed": (lambda x: col.psum(x.to(torch.int32), ax), (16, 128),
                   torch.float32, True),
        "words": (lambda x: col.psum(x, ax), (16, 128), torch.uint16, True),
    }[name]


@pytest.mark.parametrize("name", ("stacked_float", "codes", "signed",
                                  "words"))
def test_audit_verdicts_and_texts_equal_the_jax_audit(oracle, name):
    fn, shape, dtype, masked = _leaky(name)
    want = oracle["audits"][name]
    if want == "passed":
        report = check_fed_collectives(fn, torch.zeros(shape, dtype=dtype),
                                       n_fed=4, masked=masked)
        assert report == {"boundary": "fed-collectives", "n_payloads": 1,
                          "masked": masked}
    else:
        with pytest.raises(LeakageError) as e:
            check_fed_collectives(fn, torch.zeros(shape, dtype=dtype),
                                  n_fed=4, masked=masked)
        assert str(e.value) == want


def test_audit_refuses_an_unsigned_payload_that_is_no_wire_word():
    ax = col.AxisGroup.meta(4, 0)
    with pytest.raises(LeakageError) as e:
        check_fed_collectives(lambda x: col.all_gather(x, ax),
                              torch.zeros((16, 128), dtype=torch.uint64),
                              n_fed=4, masked=True)
    assert str(e.value) == (
        "unexpected unsigned payload crosses a all_gather on the masked "
        "wire: shape (16, 128) uint64 — masked words must be one of "
        "('uint16', 'uint32')")


def test_plain_wire_refused_under_the_masked_policy_and_masked_passes():
    """The plaintext packed wire gathers uint8 codes: §4.2-legal without
    the masked policy, refused under it; the masked wire's sync records
    its audit in the ledger when ``enforce`` is on."""
    from repro_torch.core.privacy import LeakageLedger
    F = 4
    mesh = Mesh.meta(F)
    x = H.inputs(F, 3)
    state = fed_state_init({k: torch.from_numpy(np.array(v))
                            for k, v in x["params"].items()}, F)
    local = {k: torch.from_numpy(np.array(v))
             for k, v in x["local"][0].items()}
    args = (local, torch.from_numpy(x["costs"]),
            torch.from_numpy(x["sizes"]), state)
    plain = build_fed_sync(None, mesh, "data", "fedpc_packed", device="cpu")
    assert check_fed_collectives(plain, *args, n_fed=F)["n_payloads"] == 2
    with pytest.raises(LeakageError, match="plaintext ternary codes"):
        check_fed_collectives(plain, *args, n_fed=F, masked=True)
    led = LeakageLedger()
    masked = build_fed_sync(None, mesh, "data", "fedpc", device="cpu",
                            privacy=PrivacySpec(), ledger=led)
    collective_payloads(masked, *args)
    assert led.audits == [{"runtime": "build_fed_sync",
                           "boundary": "fed-collectives", "n_payloads": 3,
                           "masked": True}]
