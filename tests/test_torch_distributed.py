"""The port's distributed round sync (``fed.distributed.build_fed_sync``)
against the JAX package's on the same meshes.

The JAX runtime runs on ``Mesh(devs, ("data", "model"))`` over 8 forced
host devices in one subprocess; the port on (F, M) meshes of gloo ranks
on the CPU, one subprocess a rank (``_torch_dist``). Meshes (4, 1) and
(2, 2), rounds 1 and 3, every strategy with and without per-worker betas
and a participation mask, the masked wire at 16 and 32 bits with DP off
and on, the masked XOR-butterfly tree at fanout 2 and the flat masked
wire under a fault plan with recovery threshold 2.

The per-worker forms a rank draws its own streams with
(``masking.pair_stream_keys_row``, ``pair_signs_row``,
``tree_pair_signs_row``, ``_pair_values``, ``net_mask_slab``,
``dp.rr_bits_worker``) are held to the JAX package's bitwise at model
shard indices above 0, and so are the slab kernels of a rank: the masked
uplink at N = 1 (``WirePath.uplink_masked_slab``) and the packed master
with the pilot's buffer apart (Nq = 1), and ``layout_of(shards=M)``.

Pass conditions:

* bitwise for ``fedpc`` (the int8 gather: the port folds Σ w_k T_k in
  worker order, and XLA's ``tensordot`` over F gives the same bits here),
  ``fedpc_packed`` and every masked case, and the same pilot everywhere;
* ``fedpc_reduce`` within the f16 bound: the coefficient is a sum of F
  f16 terms whose order the backend picks, so two orders differ by at
  most 2·(F−1)·2⁻¹¹·Σ|w_k|, times the Eq. (3) step |mult| (alpha0 at
  round 1, |P^{t-1} − P^{t-2}| after), plus 2 ulp of the result;
* ``fedavg`` within the f32 bound of F summed products:
  2·(F−1)·2⁻²⁴·Σ_k|w_k·x_k| element by element, plus 1 ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as H
from repro.core import flat as jfl
from repro.fed import rounds as jrd
from repro.kernels import ops as jops
from repro.privacy import dp as jdp
from repro.privacy import masking as jm
from repro.privacy.spec import PrivacySpec as JSpec
from repro_torch.core import flat as tfl
from repro_torch.fed import rounds as trd
from repro_torch.kernels import ops as tops
from repro_torch.privacy import dp as tdp
from repro_torch.privacy import masking as tm
from repro_torch.privacy.spec import PrivacySpec as TSpec

EXACT = ("fedpc", "fedpc_het", "fedpc_packed", "fedpc_packed_het", "m16",
         "m16_dp", "m32", "m32_dp", "tree2", "faults")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_sync")
    oracle = H.start_oracle(H.ORACLE, str(d / "oracle.npz"))
    port = {}
    for F, M in H.MESHES:
        port.update(H.run_ranks({"task": "sync", "F": F, "M": M}, str(d)))
    return H.oracle_result(oracle), port


def _keys(mesh, case):
    F, M = mesh
    return [f"{F}x{M}_t{t}_{case}" for t in H.ROUNDS]


@pytest.mark.parametrize("case", EXACT)
@pytest.mark.parametrize("mesh", H.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_exact_cases_bitwise(runs, mesh, case):
    oracle, port = runs
    for key in _keys(mesh, case):
        np.testing.assert_array_equal(port[key].view(np.uint32),
                                      oracle[key].view(np.uint32),
                                      err_msg=key)


@pytest.mark.parametrize("mesh", H.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_same_pilot_and_round_record_in_every_case(runs, mesh):
    """The pilot and every field of the round's telemetry record (counts,
    the cost average's sums, the wire tags) equal the JAX runtime's."""
    oracle, port = runs
    F, M = mesh
    keys = [k for k in oracle if k.startswith(f"{F}x{M}_") and
            k.endswith("_k")]
    assert len(keys) == 2 * (len(H.sync_cases()) - 2)
    for k in keys:
        assert int(port[k]) == int(oracle[k]), k
        rec = k[:-2] + "_rec"
        np.testing.assert_allclose(port[rec], oracle[rec], rtol=1e-6,
                                   err_msg=rec)


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


def _mult(x, t):
    if t <= 1:
        return np.float32(0.01)
    return np.float32(max(np.abs(p - q).max() for p, q in zip(
        H.flat(x["params"]), H.flat(x["params_prev"]))))


@pytest.mark.parametrize("het", (False, True))
@pytest.mark.parametrize("mesh", H.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_reduce_within_f16_bound(runs, mesh, het):
    oracle, port = runs
    F, M = mesh
    for t, key in zip(H.ROUNDS, _keys(mesh, "fedpc_reduce"
                                      + ("_het" if het else ""))):
        x = H.inputs(F, t)
        p = x["sizes"] / x["sizes"].sum()
        w = p * (x["betas"] if het and t > 1 else (1.0 if t <= 1 else 0.2))
        bound = (2 * (F - 1) * 2.0 ** -11 * (1 + 2.0 ** -11)
                 * np.abs(w).sum() * _mult(x, t) + 2 * _ulp(oracle[key]))
        diff = np.abs(port[key] - oracle[key])
        assert (diff <= bound).all(), (key, diff.max(), bound.max())


@pytest.mark.parametrize("het", (False, True))
@pytest.mark.parametrize("mesh", H.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_fedavg_within_f32_bound(runs, mesh, het):
    oracle, port = runs
    F, M = mesh
    for t, key in zip(H.ROUNDS, _keys(mesh, "fedavg"
                                      + ("_het" if het else ""))):
        x = H.inputs(F, t)
        wm = x["sizes"] * (x["mask"] if het else 1.0)
        w = (wm / wm.sum()).astype(np.float32)
        terms = np.abs(np.stack([w[k] * H.flat(x["local"][k])
                                 for k in range(F)])).sum(0)
        bound = 2 * (F - 1) * 2.0 ** -24 * terms + _ulp(oracle[key])
        diff = np.abs(port[key] - oracle[key])
        assert (diff <= bound).all(), (key, diff.max())


@pytest.mark.parametrize("spec", ("m16", "m16_dp"))
@pytest.mark.parametrize("mesh", H.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_masks_cancel_exactly(runs, mesh, spec):
    """Masks on == masks off (``mask_seed=None``), DP off and on: the
    pair masks leave no trace in the new model."""
    _, port = runs
    off = {"m16": "m16_off", "m16_dp": "m16_dp_off"}[spec]
    for key in _keys(mesh, spec):
        np.testing.assert_array_equal(port[key].view(np.uint32),
                                      port[key[:-len(spec)] + off].view(
                                          np.uint32),
                                      err_msg=key)


@pytest.mark.parametrize("mesh", H.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_options_change_the_update(runs, mesh):
    """DP, the 32-bit wire and the masked wire itself each change the new
    model (none is a silent no-op), while the tree gives the flat wire's
    bits."""
    _, port = runs
    for key in _keys(mesh, "m16"):
        base = key[:-len("m16")]
        for other in ("m16_dp", "m32", "fedpc_het"):
            assert not np.array_equal(port[key], port[base + other])
        np.testing.assert_array_equal(port[key], port[base + "tree2"])


# -- a rank's own streams and kernels, in process ------------------------------

def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", (2, 4, 10))
def test_row_forms_equal_the_jax_rows(n):
    part = (np.arange(n) % 3 != 1).astype(np.float32)
    for idx in range(n):
        for shard in (0, 1, 3):
            for t in (1, 7):
                _eq(tm.pair_stream_keys_row(5, idx, n,
                                            torch.tensor(t, dtype=torch.int32),
                                            shard),
                    jm.pair_stream_keys_row(5, idx, n, t, shard))
        _eq(tm.pair_signs_row(idx, n), jm.pair_signs_row(idx, n))
        _eq(tm.pair_signs_row(idx, n, participation=torch.from_numpy(part)),
            jm.pair_signs_row(idx, n, participation=part))
        for sib in (2, n):
            _eq(tm.tree_pair_signs_row(idx, n, sib,
                                       participation=torch.from_numpy(part)),
                jm.tree_pair_signs_row(idx, n, sib, participation=part))


@pytest.mark.parametrize("bits", (16, 32))
def test_slab_masks_and_rr_equal_the_jax_slabs(bits):
    shape = (6, 512)
    t = torch.tensor(3, dtype=torch.int32)
    pids = np.array([1, 7, 23], np.int32)
    _eq(tm._pair_values(9, torch.from_numpy(pids), t, 6 * 512 - 5, bits, 2),
        jm._pair_values(9, pids, 3, 6 * 512 - 5, bits, 2))
    part = np.array([1, 0, 1, 1, 1], np.float32)
    for idx in range(5):
        for shard in (0, 1):
            _eq(tm.net_mask_slab(9, idx, 5, t, shape, shard, word_bits=bits,
                                 participation=torch.from_numpy(part)),
                jm.net_mask_slab(9, idx, 5, 3, shape, shard, word_bits=bits,
                                 participation=part))
            sr = tm.tree_pair_signs_row(idx, 5, 2)
            _eq(tm.net_mask_slab(9, idx, 5, t, shape, shard, word_bits=bits,
                                 signs_row=sr),
                jm.net_mask_slab(9, idx, 5, 3, shape, shard, word_bits=bits,
                                 signs_row=jm.tree_pair_signs_row(idx, 5, 2)))
            _eq(tdp.rr_bits_worker(1, t, idx, shape, shard),
                jdp.rr_bits_worker(1, 3, idx, shape, shard))


def _slab_inputs(rows=64, seed=3):
    rng = np.random.default_rng(seed)
    p1 = (rng.standard_normal((rows, 128)) * 0.05).astype(np.float32)
    p2 = (p1 + rng.standard_normal((rows, 128)) * 0.01).astype(np.float32)
    q = (p1 + rng.standard_normal((rows, 128)) * 0.01).astype(np.float32)
    return q, p1, p2


@pytest.mark.parametrize("spec,t", (
    ({}, 1), ({"dp_epsilon": 2.0}, 3),
    ({"modulus_bits": 32, "fixpoint_bits": 24, "dp_epsilon": 2.0}, 3)),
    ids=("m16_t1", "m16_dp_t3", "m32_dp_t3"))
def test_uplink_masked_slab_equals_the_jax_slab(spec, t):
    """One worker (idx 2 of F = 4) at model shard 1: its (F,) key row
    salted by the shard, its sign row and RR key, the kernel at N = 1."""
    q, p1, p2 = _slab_inputs()
    F, idx, m_idx = 4, 2, 1
    jw = jrd.WirePath(jrd.WireConfig(), interpret=True, block_workers=1,
                      block_rows=16, privacy=JSpec(**spec))
    tw = trd.WirePath(trd.WireConfig(), block_workers=1, block_rows=16,
                      privacy=TSpec(**spec))
    part = np.array([1, 1, 1, 0], np.float32)
    wq = np.uint32(123456)
    want = jw.uplink_masked_slab(
        jnp.asarray(q), jnp.asarray(p1), jnp.asarray(p2), t=t, wq_own=wq,
        keys_row=jm.pair_stream_keys_row(0, idx, F, t, m_idx),
        signs_row=jm.pair_signs_row(idx, F, participation=part),
        rr_key=jdp.rr_stream_key(1, t, idx, m_idx), beta=0.3)
    tt = torch.tensor(t, dtype=torch.int32)
    got = tw.uplink_masked_slab(
        torch.from_numpy(q), torch.from_numpy(p1), torch.from_numpy(p2),
        t=tt, wq_own=tm.to_words(torch.tensor(int(wq)), 32),
        keys_row=tm.pair_stream_keys_row(0, idx, F, tt, m_idx),
        signs_row=tm.pair_signs_row(idx, F,
                                    participation=torch.from_numpy(part)),
        rr_key=tdp.rr_stream_key(1, tt, idx, m_idx),
        beta=torch.tensor(0.3))
    assert got.shape == (16, 512)
    _eq(got, want)


@pytest.mark.parametrize("t", (1, 3))
def test_master_with_the_pilot_apart(t):
    """#2 at Nq = 1: the pilot's buffer alone at index 0, as a mesh rank
    has it, against the JAX master that takes the pilot's buffer apart."""
    q, p1, p2 = _slab_inputs()
    rng = np.random.default_rng(4)
    packed = rng.integers(0, 256, (5, 16, 128), dtype=np.uint8)
    w = rng.random(5).astype(np.float32) / 5
    want = jops.flat_master_update(
        jnp.asarray(q), jnp.asarray(packed), jnp.asarray(w), jnp.asarray(p1),
        jnp.asarray(p2), t=t, alpha0=0.01, interpret=True, block_rows=16,
        block_workers=1)
    got = tops.flat_master_update(
        torch.from_numpy(q)[None], 0, torch.from_numpy(packed),
        torch.from_numpy(w), torch.from_numpy(p1), torch.from_numpy(p2),
        t=t, alpha0=0.01)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("shards", (1, 2, 4, 3))
def test_layout_shards_equal_the_jax_layout(shards):
    x = H.inputs(4, 1)["params"]
    jl = jfl.layout_of({k: jnp.asarray(v) for k, v in x.items()},
                       shards=shards)
    tl = tfl.layout_of({k: torch.from_numpy(np.array(v))
                        for k, v in x.items()}, shards=shards)
    assert (tl.rows, tl.shards, tl.shard_rows, tl.n) == (
        jl.rows, jl.shards, jl.shard_rows, jl.n)
    assert tl.rows % (32 * shards) == 0
    with pytest.raises(ValueError, match="shards must be >= 1"):
        tfl.layout_of(x, shards=0)


REFUSALS = (
    ("fedavg", {"privacy": {}}, 4),
    ("fedpc", {"tree": 2}, 4),
    ("fedpc", {"privacy": {}, "tree": 3}, 4),
    ("fedpc", {"privacy": {}, "tree": 2}, 6),
    ("fedpc", {"privacy": {}, "tree": 4}, 2),
    ("fedpc", {"privacy": {}, "faults": True}, 4),
)


@pytest.mark.parametrize("strategy,opts,F", REFUSALS)
def test_refusals_equal_the_jax_runtime(strategy, opts, F):
    """``build_fed_sync`` refuses what the JAX runtime refuses, with its
    ``ValueError`` text (a mesh of the right shape is all either reads
    before refusing)."""
    from types import SimpleNamespace

    from repro.core.tree import TreeSpec as JTree
    from repro.fed.distributed import build_fed_sync as jsync
    from repro.fed.faults import FaultPlan as JPlan
    from repro_torch.core.tree import TreeSpec as TTree
    from repro_torch.fed.distributed import build_fed_sync as tsync
    from repro_torch.fed.faults import FaultPlan as TPlan
    from repro_torch.launch.mesh import Mesh

    def kwargs(spec, tree, plan):
        kw = {}
        if "privacy" in opts:
            kw["privacy"] = spec(**opts["privacy"])
        if "tree" in opts:
            kw["tree"] = tree(fanout=opts["tree"])
        if opts.get("faults"):
            kw["faults"] = plan(**H.FAULTS)
        return kw
    with pytest.raises(ValueError) as want:
        jsync(None, SimpleNamespace(shape={"data": F, "model": 1}), "data",
              strategy, **kwargs(JSpec, JTree, JPlan))
    with pytest.raises(ValueError) as got:
        tsync(None, Mesh.meta(F), "data", strategy, device="cpu",
              **kwargs(TSpec, TTree, TPlan))
    assert str(got.value) == str(want.value)


def test_round_engine_shards_pad_to_whole_slabs():
    """``RoundEngine(shards=M)`` lays the buffer out as the mesh does;
    the padding is a fixed point of the wire, so the round's new model is
    the unsharded engine's, bit for bit."""
    x = H.inputs(4, 1)
    params = {k: torch.from_numpy(np.array(v)) for k, v in x["params"].items()}
    locs = [{k: torch.from_numpy(np.array(v)) for k, v in loc.items()}
            for loc in x["local"]]
    sizes = torch.from_numpy(x["sizes"])
    new = {}
    for shards in (1, 2, 4):
        eng = trd.RoundEngine(params, shards=shards, device="cpu")
        assert eng.layout.rows % (32 * shards) == 0
        bufs = eng.flatten_locals(locs)
        new[shards] = H.flat({k: v.numpy() for k, v in eng.run_round(
            bufs, 2, sizes / sizes.sum(), 1).items()})
    for shards in (2, 4):
        np.testing.assert_array_equal(new[shards].view(np.uint32),
                                      new[1].view(np.uint32))


# -- the wire's launch-plan knobs ----------------------------------------------

KNOBS = {"wire_block_rows": 8, "wire_block_workers": 2}
KNOB_CASES = (("fedpc_packed", None), ("fedpc", "m16_dp"))

KNOB_ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import _torch_dist as H
import test_torch_distributed as T
from repro.fed.distributed import build_fed_sync, fed_state_init
from repro.privacy import PrivacySpec

out = {}
for F, M in H.MESHES:
    mesh = Mesh(np.array(jax.devices()[:F * M]).reshape(F, M),
                ("data", "model"))
    for strategy, spec in T.KNOB_CASES:
        kw = dict(T.KNOBS, betas=jnp.asarray(H.inputs(F, 1)["betas"]))
        if spec:
            kw["privacy"] = PrivacySpec(**H.SPECS[spec])
        with mesh:
            sync = jax.jit(build_fed_sync(None, mesh, "data", strategy, **kw))
            for t in H.ROUNDS:
                x = H.inputs(F, t)
                state = fed_state_init(jax.tree_util.tree_map(
                    jnp.asarray, x["params"]), F)
                state["round"] = jnp.asarray(t, jnp.int32)
                state["params_prev"] = jax.tree_util.tree_map(
                    jnp.asarray, x["params_prev"])
                state["prev_costs"] = jnp.asarray(x["prev_costs"])
                params_F = {k: jnp.stack([jnp.asarray(l[k])
                                          for l in x["local"]])
                            for k in x["params"]}
                new, aux = sync(params_F, jnp.asarray(x["costs"]),
                                jnp.asarray(x["sizes"]), state,
                                jnp.asarray(x["mask"]))
                key = f"{F}x{M}_t{t}_{strategy}_{spec}"
                out[key] = H.flat(jax.tree_util.tree_map(np.asarray, new))
                out[key + "_k"] = np.asarray(aux["k_star"])
np.savez(sys.argv[2], **out)
"""

KNOB_RANK = r"""
import json, os, sys
sys.path.insert(0, os.path.dirname(sys.argv[1]))
import numpy as np
import torch
import torch.distributed as dist
job = json.load(open(sys.argv[2]))
rank, F, M = int(sys.argv[3]), job["F"], job["M"]
sys.path.insert(0, job["src"])
import _torch_dist as H
import test_torch_distributed as T
from repro_torch.fed import distributed as D
from repro_torch.fed.distributed import build_fed_sync, fed_state_init
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.privacy import PrivacySpec

dist.init_process_group("gloo", init_method="file://" + job["store"],
                        world_size=F * M, rank=rank)
plans = []
wire_path = D.rd.WirePath


def recording(*args, **kw):
    wire = wire_path(*args, **kw)
    plans.append((wire.block_rows, wire.block_workers))
    return wire


D.rd.WirePath = recording
try:
    mesh = make_debug_mesh(F, M)
    f = mesh.axes["data"].index
    tensors = lambda tree: {k: torch.from_numpy(np.array(v))
                            for k, v in tree.items()}
    out = {}
    for strategy, spec in T.KNOB_CASES:
        kw = dict(T.KNOBS, betas=torch.from_numpy(H.inputs(F, 1)["betas"]))
        if spec:
            kw["privacy"] = PrivacySpec(**H.SPECS[spec])
        sync = build_fed_sync(None, mesh, "data", strategy, device="cpu",
                              **kw)
        for t in H.ROUNDS:
            x = H.inputs(F, t)
            state = fed_state_init(tensors(x["params"]), F)
            state["round"] = torch.tensor(t, dtype=torch.int32)
            state["params_prev"] = tensors(x["params_prev"])
            state["prev_costs"] = torch.from_numpy(x["prev_costs"])
            new, aux = sync(tensors(x["local"][f]),
                            torch.from_numpy(x["costs"]),
                            torch.from_numpy(x["sizes"]), state,
                            torch.from_numpy(x["mask"]))
            key = f"{F}x{M}_t{t}_{strategy}_{spec}"
            out[key] = H.flat({k: v.numpy() for k, v in new.items()})
            out[key + "_k"] = aux["k_star"].numpy()
    out["plans"] = np.array(plans, np.int64)
    dist.barrier()
    if rank == 0:
        np.savez(job["out"], **out)
finally:
    dist.destroy_process_group()
"""


def _knob_ranks(F, M, tmp):
    """The port's side of the knob cases on F·M gloo ranks; rank 0's
    arrays."""
    import json
    import os
    import subprocess
    import sys
    job = {"F": F, "M": M, "src": H.SRC, "store": str(tmp / f"store{F}{M}"),
           "out": str(tmp / f"port{F}{M}.npz")}
    path = tmp / f"job{F}{M}.json"
    path.write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=H.SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", KNOB_RANK, H.__file__,
                               str(path), str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(F * M)]
    return procs, job["out"]


def test_wire_plan_knobs_equal_the_jax_sync(tmp_path):
    """``build_fed_sync(wire_block_rows=, wire_block_workers=)`` takes the
    JAX signature's knobs, hands them to every rank's ``WirePath`` and
    gives the JAX runtime's bits and pilot with the same knobs: the plain
    packed wire and the masked 16-bit wire with DP, rounds 1 and 3, on
    both meshes."""
    oracle = H.start_oracle(KNOB_ORACLE, str(tmp_path / "oracle.npz"))
    started = [_knob_ranks(F, M, tmp_path) for F, M in H.MESHES]
    port = {}
    for mesh, got in zip(H.MESHES, started):
        got = H.ranks_result(got)
        plans = got.pop("plans")
        assert plans.tolist() == [[KNOBS["wire_block_rows"],
                                   KNOBS["wire_block_workers"]]] * len(
                                       KNOB_CASES), (mesh, plans)
        port.update(got)
    want = H.oracle_result(oracle)
    assert sorted(port) == sorted(want)
    assert len(want) == 2 * len(H.MESHES) * len(KNOB_CASES) * len(H.ROUNDS)
    for key in want:
        if key.endswith("_k"):
            assert int(port[key]) == int(want[key]), key
        else:
            np.testing.assert_array_equal(port[key].view(np.uint32),
                                          want[key].view(np.uint32),
                                          err_msg=key)
