"""The port's dry run (``repro_torch.launch``: ``analysis``, ``hlo_stats``,
``specs``, ``dryrun``) against the JAX package's, on the CPU.

* ``active_params`` / ``model_flops`` equal the reference's for every
  registered config, and ``_collective_moved`` for every kind;
* the counter on small programs: one matmul (FLOPs and bytes), a matmul
  on DTensors (one device's share, the collective DTensor issues), the
  mLSTM/sLSTM time loops, the Mamba chunk loop and a reduced Jamba's
  prefill (unit stack, chunks, attention tiles) traced a body and
  counted ``trips`` times against the same loops traced in full;
* ``run_one`` on reduced dense, MoE (shard-local dispatch, ``s_blk`` 4),
  Mamba and xLSTM configs for train, prefill and decode on a (4, 2) fake
  mesh: ``ok``;
* ``run_fed``'s transport bytes a device against a real gloo run of the
  same fed step at (2, 2) (``tests/_torch_dist.py``'s ``fedbytes`` task);
* in one JAX subprocess (8 host devices, ``Mesh(devs, ...)``): the
  per-device dot FLOPs of a reduced dense config's compiled train step
  and prefill by the reference's ``hlo_stats.analyze``, which the port's
  count must meet: the prefill exactly, the train step within 5% (the
  reference's scanned stack rematerializes its units in the backward,
  and XLA's partitioner and DTensor's strategies place some products of
  the backward differently; the port counted 3.8% fewer), and the MoE's
  shard-local dispatch under ``jax.set_mesh`` against the port's at
  ``dp_size() == 4``: kept routes exactly, outputs within ``rtol=1e-4,
  atol=1e-5`` (``tests/test_torch_moe.py``'s serving tolerance).
"""
import numpy as np
import pytest
import torch

import _torch_dist as H
from repro.configs import get_config as jget
from repro.launch import analysis as jan
from repro.launch import hlo_stats as jhs
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_configs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import analysis as tan
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_stats as ths
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import scan_config, ssm
from repro_torch.sharding import activations as act

SERVE = dict(rtol=1e-4, atol=1e-5)
# Small shapes of each kind: a prefill over 1,024 keys takes the blocked
# attention (two 512-key blocks) and four Mamba chunks, rolled.
TEST_SHAPES = {"t_train": dict(kind="train", seq=64, batch=8),
               "t_prefill": dict(kind="prefill", seq=1024, batch=4),
               "t_decode": dict(kind="decode", seq=256, batch=8)}
MOE_EXPERTS = 5          # does not divide the model axis: s_blk = dp


def _reduced(arch):
    cfg = tget(arch).reduced()
    if cfg.n_experts:
        cfg = cfg.replace(n_experts=MOE_EXPERTS)
    return cfg


@pytest.fixture(scope="module")
def mesh42():
    return fake_mesh((4, 2), ("data", "model"))


@pytest.fixture()
def test_shapes(monkeypatch):
    for k, v in TEST_SHAPES.items():
        monkeypatch.setitem(tspecs.SHAPES, k, v)


# -- analytic counts -----------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_active_params_and_model_flops_equal_the_reference(arch):
    j, t = jget(arch), tget(arch)
    assert tan.active_params(t) == jan.active_params(j)
    for kind in ("train", "prefill", "decode"):
        assert tan.model_flops(t, 4096, kind) == jan.model_flops(j, 4096,
                                                                 kind)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "all-to-all",
                                  "ragged-all-to-all", "reduce-scatter",
                                  "collective-permute", "all-reduce-start"])
def test_collective_moved_equals_the_reference(kind):
    for g in (2, 4, 8, 16):
        assert ths._collective_moved(kind, 1 << 20, g) == \
            jhs._collective_moved(kind, 1 << 20, g)


# -- the hooks ------------------------------------------------------------------

@pytest.mark.parametrize("hook", ["residual", "heads", "ffn_hidden", "logits",
                                  "expert_buf", "expert_weights",
                                  "expert_hidden", "expert_block_buf",
                                  "expert_block_hidden", "ssm_state"])
def test_off_a_mesh_every_hook_returns_its_input(hook):
    for shape in ((2, 3, 4), (2, 3, 4, 5)):
        x = torch.zeros(shape)
        assert getattr(act, hook)(x) is x
    assert act.dp_size() == 1 and act.model_size() == 1
    x = torch.zeros((2, 3, 8))
    assert act.head_split(x, 3) is x and act.replicated("op", x) is x
    assert act.like("op", x, x) is x and act.local(x, 1) is x
    assert act.local_heads(lambda *a: a[0], x, x, x) is x
    before = list(act.REPLICATED_OPS)
    assert not act.on_mesh("op") and act.REPLICATED_OPS == before


# -- the counter on small programs --------------------------------------------

def test_counter_counts_one_matmul():
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")
    counter = ths.OpCounter()
    counter.hold_arguments(a, b)
    with counter:
        c = a @ b
    st = counter.stats
    assert st.flops == 2 * 64 * 32 * 16
    assert st.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert st.argument_bytes == 4 * (64 * 32 + 32 * 16)
    assert st.peak_bytes == st.argument_bytes + 4 * 64 * 16
    assert c.shape == (64, 16) and st.collective_device_bytes == 0


def test_counter_sees_one_devices_share_and_dtensors_collectives(mesh42):
    from repro_torch.sharding.specs import P
    x = tspecs.placed((64, 32), torch.float32, mesh42, P("data", None))
    w = tspecs.placed((32, 16), torch.float32, mesh42, P(None, "model"))
    counter = ths.OpCounter(ths.mesh_groups(mesh42))
    with act.use_mesh(mesh42), counter:
        y = act.constrain(x @ w, ("DP", None))    # gathers over model
    st = counter.stats
    assert st.flops == 2 * 16 * 32 * 8            # (64/4) x 32 x (16/2)
    assert st.collective_counts == {"all-gather": 1}
    # the (16, 8) shards gathered into (16, 16) over the 2-wide axis
    assert st.bytes_by_axis == {"model": 0.5 * 16 * 16 * 4}
    assert y.to_local().shape == (16, 16)


def _count(fn, *args, rolled: bool):
    counter = ths.OpCounter()
    ctx = scan_config.counting(counter if rolled else None)
    with ctx, counter:
        fn(*args)
    return counter.stats


@pytest.fixture()
def short_chunks():
    """Time-loop chunks of 4 steps: what is traced a chunk stays small."""
    before = ssm.LSTM_CHUNK[0]
    try:
        ssm.set_lstm_chunk(4)
        yield
    finally:
        ssm.set_lstm_chunk(before)


def _loop_case(mixer, grad):
    cfg = tget("xlstm-350m").reduced()
    init = {"mlstm": ssm.init_mlstm, "slstm": ssm.init_slstm}[mixer]
    train = {"mlstm": ssm.mlstm_train, "slstm": ssm.slstm_train}[mixer]
    p = {k: v.requires_grad_(grad) for k, v in init(cfg, None).items()}
    x = torch.empty((2, 4 * ssm.LSTM_CHUNK[0], cfg.d_model), device="meta",
                    requires_grad=grad)

    def run(p, x):
        with torch.set_grad_enabled(grad):
            y = train(p, cfg, x)
            if grad:
                torch.autograd.grad(y.sum(), [x, *p.values()])
    return run, p, x


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
@pytest.mark.parametrize("grad", [False, True])
def test_a_rolled_time_loop_counts_the_whole_loop(mixer, grad,
                                                  short_chunks):
    run, p, x = _loop_case(mixer, grad)
    rolled = _count(run, p, x, rolled=True)
    full = _count(run, p, x, rolled=False)
    assert rolled.loop_trip_counts == {f"{mixer}_time": 4}
    assert not full.loop_trip_counts
    if not grad:
        assert (rolled.flops, rolled.bytes) == (full.flops, full.bytes)
        assert rolled.flops > 0
        return
    # Under a gradient the traced chunk starts from the zero state, which
    # needs no gradient; each later chunk's does: the count misses that
    # first step's carry gradient (trips - 1) times, under a step's worth
    # of products in S. Nor does it sum the weights' and the inputs'
    # gradients across chunks (trips - 1 sums of each): bytes within 6%.
    assert rolled.flops == pytest.approx(full.flops, rel=1 / x.shape[1])
    assert rolled.bytes == pytest.approx(full.bytes, rel=0.06)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_the_naive_time_loop_is_counted_step_by_step(mixer, short_chunks):
    # set_lstm_chunk(None): no chunk to roll, so the dry run's counter
    # traces every one of the S steps, as the unrolled count does.
    run, p, x = _loop_case(mixer, True)
    try:
        ssm.set_lstm_chunk(None)
        rolled = _count(run, p, x, rolled=True)
        full = _count(run, p, x, rolled=False)
    finally:
        ssm.set_lstm_chunk(4)
    assert not rolled.loop_trip_counts and not full.loop_trip_counts
    assert (rolled.flops, rolled.bytes) == (full.flops, full.bytes)
    assert rolled.flops > 0


def test_the_mamba_chunk_loop_rolled_and_unrolled_count_alike():
    cfg = tget("jamba-1.5-large-398b").reduced()
    p = ssm.init_mamba(cfg, None)
    x = torch.empty((2, 1024, cfg.d_model), device="meta")
    with torch.no_grad():
        rolled = _count(ssm.mamba_train, p, cfg, x, rolled=True)
        scan_config.set_unroll(True)
        try:
            full = _count(ssm.mamba_train, p, cfg, x, rolled=True)
        finally:
            scan_config.set_unroll(False)
    assert rolled.loop_trip_counts == {"mamba_chunks": 4}
    assert rolled.flops == full.flops > 0
    assert rolled.bytes == pytest.approx(full.bytes, rel=1e-6)


def test_rolled_unit_stacks_count_as_unrolled_ones(mesh42, test_shapes):
    cfg = tget("jamba-1.5-large-398b").reduced().replace(n_layers=16)
    rolled = dryrun.run_one("jamba", "t_prefill", cfg=cfg, mesh=mesh42,
                            verbose=False)
    scan_config.set_unroll(True)
    try:
        full = dryrun.run_one("jamba", "t_prefill", cfg=cfg, mesh=mesh42,
                              verbose=False)
    finally:
        scan_config.set_unroll(False)
    assert rolled["loop_trip_counts"] == {"units": 2, "mamba_chunks": 4,
                                          "attn_q_tiles": 2,
                                          "attn_k_blocks": 2}
    assert full["loop_trip_counts"] == {}
    for key in ("flops_device", "collective_bytes_device"):
        assert rolled["roofline"][key] == full["roofline"][key], key
    # DTensor runs small bookkeeping ops (index arithmetic on plain
    # tensors) the first time it meets an op, which the unit that meets
    # it first counts: that unit counted twice moves a little more
    assert rolled["roofline"]["bytes_device"] == pytest.approx(
        full["roofline"]["bytes_device"], rel=5e-3)


# -- run_one / run_fed ---------------------------------------------------------

@pytest.mark.parametrize("shape", list(TEST_SHAPES))
@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-moe-16b",
                                  "jamba-1.5-large-398b", "xlstm-350m"])
def test_run_one_on_reduced_configs(arch, shape, mesh42, test_shapes,
                                    short_chunks, monkeypatch):
    blocks = []
    route = tmoe.route
    monkeypatch.setattr(tmoe, "route", lambda p, cfg, xf, s_blk=1: (
        blocks.append(s_blk), route(p, cfg, xf, s_blk=s_blk))[1])
    rec = dryrun.run_one(arch, shape, cfg=_reduced(arch), mesh=mesh42,
                         verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 8 and rec["mesh"] == "4x2"
    rl = rec["roofline"]
    assert rl["flops_device"] > 0 and rl["bytes_device"] > 0
    assert rec["memory"]["peak_size_in_bytes"] >= \
        rec["memory"]["argument_size_in_bytes"] > 0
    if arch == "deepseek-moe-16b":     # shard-local dispatch: a block a
        assert blocks and set(blocks) == {4}      # data shard
    if shape == "t_prefill" and arch == "xlstm-350m":
        assert rec["loop_trip_counts"] == {"mlstm_time": 256,
                                           "slstm_time": 256}


def test_fed_shardings_prepend_the_fed_axis(mesh42):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.fed.distributed import fed_shardings
    params = {"wq": torch.empty((8, 6), device="meta"),
              "norm": torch.empty((6,), device="meta")}
    got = fed_shardings(None, mesh42, "data", params)
    assert got["params"] == {"wq": (Shard(0), Shard(1)),
                             "norm": (Replicate(), Replicate())}
    assert got["params_F"] == {"wq": (Shard(1), Shard(2)),
                               "norm": (Shard(0), Replicate())}


def test_run_fed_bytes_equal_a_gloo_run(background):
    real = H.ranks_result(background["ranks"])
    mesh = fake_mesh((2, 2), ("data", "model"))
    cfg = tget(H.FED_BYTES["arch"]).reduced()
    by = {}
    for strat in dryrun.FED_STRATEGIES:
        rec = dryrun.run_fed(H.FED_BYTES["arch"], strat, cfg=cfg, mesh=mesh,
                             local_batch=H.FED_BYTES["batch"],
                             seq=H.FED_BYTES["seq"], verbose=False)
        assert rec["status"] == "ok", rec.get("traceback")
        tr = rec["transport"]
        got = [tr["calls"], tr["protocol_bytes"], tr["link_bytes"],
               tr["axis_bytes"].get("data", 0),
               tr["axis_bytes"].get("model", 0)]
        assert got == real[strat].tolist(), strat
        assert rec["fed_axis_bytes"] == real[strat][3]
        by[strat] = rec["fed_axis_bytes"]
    # 2-bit codes, int8 codes, f16 sums (two workers: the pilot's f32
    # slab keeps FedPC above FedAvg until more workers share a round)
    assert by["fedpc_packed"] < by["fedpc"] < by["fedpc_reduce"]


# -- against the reference, in one JAX subprocess -----------------------------

# The reference's side: its flops a device at ORACLE_SHAPES, and its MoE at
# MOE_EXPERTS experts under the mesh; argv[2] the .npz it writes.
ORACLE_SHAPES = {"t_train": dict(kind="train", seq=64, batch=8),
                 "t_prefill": dict(kind="prefill", seq=64, batch=8)}
ORACLE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.launch import hlo_stats
from repro.launch.specs import SHAPES, input_specs
from repro.models import moe as jmoe

SHAPES.update(%r)
mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
cfg = get_config("qwen3-14b").reduced()
flops = {}
for sh in ("t_train", "t_prefill"):
    spec = input_specs(cfg, sh, mesh)
    with jax.set_mesh(mesh):
        compiled = jax.jit(spec.fn).lower(*spec.args).compile()
    flops["flops_" + sh] = hlo_stats.analyze(compiled.as_text()).flops

mcfg = get_config("deepseek-moe-16b").reduced().replace(n_experts=%d)
p = jmoe.init_moe(mcfg, jax.random.PRNGKey(3))
x = np.random.default_rng(4).standard_normal(
    (2, 32, mcfg.d_model)).astype(np.float32)
with jax.set_mesh(mesh):
    y, aux = jax.jit(lambda p, x: jmoe.moe(p, mcfg, x))(p, jnp.asarray(x))
# the reference's block routing lines (moe.py) at s_blk = 4
s, K, E = 4, mcfg.top_k, mcfg.n_experts
xf = jnp.asarray(x).reshape(-1, mcfg.d_model)
probs = jax.nn.softmax(xf @ p["router"], axis=-1)
_, e_idx = jax.lax.top_k(probs, K)
flat_e = e_idx.reshape(s, -1)
onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - onehot,
                          flat_e[..., None], axis=2)[..., 0]
keep = pos < jmoe.capacity(mcfg, xf.shape[0] // s)
top = np.sort(np.asarray(probs), -1)[:, ::-1]
np.savez(sys.argv[2], x=x, y=np.asarray(y), e_idx=np.asarray(e_idx),
         pos=np.asarray(pos).reshape(-1), keep=np.asarray(keep).reshape(-1),
         gap=top[:, K - 1] - top[:, K], drop=float(aux["drop_frac"]),
         **flops,
         **{"p_" + k: np.asarray(v) for k, v in p.items()
            if not isinstance(v, dict)},
         **{"p_shared_" + k: np.asarray(v)
            for k, v in p.get("shared", {}).items()})
""" % (ORACLE_SHAPES, MOE_EXPERTS)


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The JAX oracle and the (2, 2) gloo ranks, started with the module so
    that they run beside its other tests."""
    tmp = tmp_path_factory.mktemp("dryrun")
    started = {"oracle": H.start_oracle(ORACLE, str(tmp / "oracle.npz")),
               "ranks": H.start_ranks({"task": "fedbytes", "F": 2, "M": 2},
                                      str(tmp))}
    yield started
    for proc in (started["oracle"][0], *started["ranks"][0]):
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def oracle(background):
    return H.oracle_result(background["oracle"])


def test_dot_flops_a_device_meet_the_reference(oracle, mesh42,
                                               monkeypatch):
    for k, v in ORACLE_SHAPES.items():
        monkeypatch.setitem(tspecs.SHAPES, k, v)
    cfg = tget("qwen3-14b").reduced()
    got = {sh: dryrun.run_one("qwen3-14b", sh, cfg=cfg, mesh=mesh42,
                              verbose=False)["roofline"]["flops_device"]
           for sh in ORACLE_SHAPES}
    assert got["t_prefill"] == oracle["flops_t_prefill"]
    assert got["t_train"] == pytest.approx(float(oracle["flops_t_train"]),
                                           rel=0.05)


def test_moe_shard_local_dispatch_matches_the_reference(oracle,
                                                        monkeypatch):
    z = oracle
    assert z["gap"].min() > 1e-5, "a near-tie in the seed's routing"
    cfg = tget("deepseek-moe-16b").reduced().replace(n_experts=MOE_EXPERTS)
    p = {k[2:]: z[k] for k in z if k.startswith("p_")
         and not k.startswith("p_shared_")}
    p["shared"] = {k[9:]: z[k] for k in z if k.startswith("p_shared_")}
    tp = params_from_numpy(p, device="cpu")
    x = torch.from_numpy(z["x"])
    _, _, _, e_idx, pos, keep = tmoe.route(tp, cfg, x.reshape(-1, 256),
                                           s_blk=4)
    np.testing.assert_array_equal(e_idx.numpy(), z["e_idx"])
    np.testing.assert_array_equal(pos.numpy(), z["pos"])
    np.testing.assert_array_equal(keep.numpy(), z["keep"])
    assert not bool(keep.all())        # the blocks' capacity drops some
    monkeypatch.setattr(act, "dp_size", lambda: 4)
    monkeypatch.setattr(act, "model_size", lambda: 2)
    y, aux = tmoe.moe(tp, cfg, x)
    np.testing.assert_allclose(y.numpy(), z["y"], **SERVE)
    np.testing.assert_allclose(float(aux["drop_frac"]), float(z["drop"]),
                               rtol=1e-6)
    # off a mesh (s_blk = 1) the dispatch is global: other drops
    monkeypatch.undo()
    _, aux1 = tmoe.moe(tp, cfg, x)
    assert float(aux1["drop_frac"]) != float(z["drop"])
