"""The port's checkpoint against ``repro.checkpoint`` and
``repro.fed.rounds.save_round_state`` / ``load_round_state``.

Held: the round trip of a tree of tensors (float32, bfloat16 through its
``uint16`` bits, int32, uint32 words, nested dicts, NamedTuples and
lists, ``None`` fields), ``latest_step``, the refusal of a shape that
differs and of a missing key, extra keys ignored, each leaf back in the
dtype and on the device of ``like``'s; the manifest's keys, dtypes and
shapes equal to the JAX package's for the same ``RoundState`` (with the
accountant and the telemetry carry); and a resumed run equal to an
uninterrupted one bit for bit: across the packages both ways on the plain
wire and on the masked wire with DP (a JAX checkpoint resumed in the
port, a port checkpoint resumed in the JAX package), and on both of the
port's drivers at the simulator level. The Pallas kernels of the JAX side
run in interpret mode with ``block_workers=1``.
"""
import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.fed import rounds as jrd
from repro.privacy.spec import PrivacySpec as JSpec
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.checkpoint import _flatten_with_path
from repro_torch.core import flat as fl
from repro_torch.core.fedpc import FedPCConfig as TCfg
from repro_torch.data.pipeline import federated_loaders
from repro_torch.data.synthetic import SyntheticClassification
from repro_torch.fed import rounds as trd
from repro_torch.fed.simulator import FedSimulator
from repro_torch.fed.worker import Worker, make_worker_configs
from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_and_grad
from repro_torch.privacy.spec import PrivacySpec as TSpec

N = 4
ROWS = 32


class Pair(NamedTuple):
    a: torch.Tensor
    b: object = None


def _tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).view(3, 4),
                   "b": torch.full((4,), 1.5, dtype=torch.bfloat16)},
        "round": torch.tensor(7, dtype=torch.int32),
        "words": torch.tensor([0, 1, 2**31, 2**32 - 1],
                              dtype=torch.int64).to(torch.uint32),
        "pair": Pair(a=torch.tensor([1.0, -2.0])),
        "seq": [torch.zeros(2, dtype=torch.int64), torch.ones(1)],
    }


def _leaves_equal(a, b) -> None:
    fa, fb = _flatten_with_path(a), _flatten_with_path(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (_, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), tree, step=3,
                           metadata={"algo": "fedpc"})
    assert path.endswith("ckpt_00000003.npz")
    restored, manifest = load_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 3
    assert manifest["metadata"]["algo"] == "fedpc"
    assert manifest["keys"] == ["pair/a", "params/b", "params/w", "round",
                                "seq/0", "seq/1", "words"]
    assert manifest["dtypes"]["words"] == "uint32"
    assert restored["pair"].b is None and isinstance(restored["pair"], Pair)
    _leaves_equal(restored, tree)
    # The manifest and the arrays read the same in the JAX package.
    jtree = {"params": {"w": jnp.zeros((3, 4)),
                        "b": jnp.zeros(4, jnp.bfloat16)},
             "round": jnp.asarray(0, jnp.int32),
             "words": jnp.zeros(4, jnp.uint32)}
    jrest, _ = jck.load_checkpoint(str(tmp_path), jtree)
    assert jrest["params"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jrest["params"]["b"],
                                             np.float32), 1.5)
    np.testing.assert_array_equal(np.asarray(jrest["words"]),
                                  [0, 1, 2**31, 2**32 - 1])


def test_latest_step_selection(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), _tree())
    tree = _tree()
    save_checkpoint(str(tmp_path), tree, step=1)
    tree["round"] = torch.tensor(9, dtype=torch.int32)
    save_checkpoint(str(tmp_path), tree, step=5)
    assert latest_step(str(tmp_path)) == 5
    restored, manifest = load_checkpoint(str(tmp_path), _tree())
    assert manifest["step"] == 5 and int(restored["round"]) == 9
    restored, manifest = load_checkpoint(str(tmp_path), _tree(), step=1)
    assert manifest["step"] == 1 and int(restored["round"]) == 7


def test_shape_mismatch_and_missing_key_rejected(tmp_path):
    save_checkpoint(str(tmp_path), _tree(), step=0)
    bad = _tree()
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="params/w"):
        load_checkpoint(str(tmp_path), bad)
    bad = _tree()
    bad["extra"] = torch.zeros(3)
    with pytest.raises(KeyError, match="extra"):
        load_checkpoint(str(tmp_path), bad)
    fewer = _tree()
    del fewer["seq"]                      # extra keys in the file: ignored
    restored, _ = load_checkpoint(str(tmp_path), fewer)
    _leaves_equal(restored, fewer)


def test_bfloat16_travels_as_uint16_and_casts_to_like(tmp_path):
    x = torch.tensor([1.0, -2.5, 3.140625, 1e-3], dtype=torch.bfloat16)
    save_checkpoint(str(tmp_path), {"x": x}, step=0)
    with np.load(tmp_path / "ckpt_00000000.npz") as data:
        assert data["x"].dtype == np.uint16
        np.testing.assert_array_equal(data["x"],
                                      x.view(torch.int16).numpy().view(
                                          np.uint16))
    manifest = json.loads((tmp_path / "ckpt_00000000.json").read_text())
    assert manifest["dtypes"]["x"] == "bfloat16"
    back, _ = load_checkpoint(str(tmp_path), {"x": torch.zeros(4,
                                                    dtype=torch.bfloat16)})
    assert torch.equal(back["x"].view(torch.int16), x.view(torch.int16))
    as_f32, _ = load_checkpoint(str(tmp_path), {"x": torch.zeros(4)})
    assert as_f32["x"].dtype == torch.float32
    assert torch.equal(as_f32["x"], x.float())
    # A bfloat16 leaf the JAX package wrote loads in the port.
    jx = jnp.asarray(np.asarray(x.float()), jnp.bfloat16)
    jck.save_checkpoint(str(tmp_path / "j"), {"x": jx}, step=0)
    back, manifest = load_checkpoint(str(tmp_path / "j"),
                                     {"x": torch.zeros(4,
                                                       dtype=torch.bfloat16)})
    assert manifest["dtypes"]["x"] == "bfloat16"
    assert torch.equal(back["x"].view(torch.int16), x.view(torch.int16))
    assert np.asarray(jx).dtype == ml_dtypes.bfloat16


# -- RoundState across the packages -------------------------------------------

def _spec(pkg, masked: bool):
    if not masked:
        return None
    return (JSpec if pkg == "jax" else TSpec)(dp_epsilon=2.0, enforce=False)


def _wires(masked: bool):
    jw = jrd.WirePath(jrd.WireConfig(), interpret=True, block_workers=1,
                      privacy=_spec("jax", masked))
    tw = trd.WirePath(trd.WireConfig(), block_workers=1,
                      privacy=_spec("torch", masked))
    return jw, tw


def _inputs(rounds: int):
    """Each round's worker deltas and costs, from a seed."""
    rng = np.random.default_rng(11)
    p0 = rng.standard_normal((ROWS, 128), dtype=np.float32) * 0.05
    sizes = rng.integers(50, 90, N).astype(np.float32)
    steps = [(rng.standard_normal((N, ROWS, 128), dtype=np.float32) * 0.02,
              rng.random(N, dtype=np.float32) + 0.5) for _ in range(rounds)]
    return p0, sizes, steps


def _run_jax(jw, js, sizes, steps):
    for deltas, costs in steps:
        bufs = np.asarray(js.buf_p1)[None] + deltas
        js, _, _ = jw.round_step(js, jnp.asarray(bufs), jnp.asarray(costs),
                                 jnp.asarray(sizes))
    return js


def _run_torch(tw, ts, sizes, steps):
    for deltas, costs in steps:
        bufs = ts.buf_p1[None] + torch.from_numpy(deltas)
        ts, _, _ = tw.round_step(ts, bufs, torch.from_numpy(costs),
                                 torch.from_numpy(sizes))
    return ts


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same_state(ts, js) -> None:
    tflat = dict(_flatten_with_path(ts._asdict()))
    jflat = {jck._path_str(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(js._asdict())[0]}
    assert sorted(tflat) == sorted(jflat)
    for k in tflat:
        np.testing.assert_array_equal(_bits(tflat[k]), _bits(jflat[k]),
                                      err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_manifest_matches_reference(tmp_path, masked):
    jw, tw = _wires(masked)
    p0, sizes, steps = _inputs(2)
    js = _run_jax(jw, jrd.init_round_state({"w": jnp.asarray(p0)}, N,
                                           privacy=jw.privacy), sizes, steps)
    ts = _run_torch(tw, trd.init_round_state({"w": torch.from_numpy(p0)}, N,
                                             privacy=tw.privacy,
                                             device="cpu"), sizes, steps)
    jrd.save_round_state(str(tmp_path / "j"), js, metadata={"run": 1})
    trd.save_round_state(str(tmp_path / "t"), ts, metadata={"run": 1})
    jm = json.loads((tmp_path / "j" / "ckpt_00000003.json").read_text())
    tm = json.loads((tmp_path / "t" / "ckpt_00000003.json").read_text())
    assert tm == jm
    assert tm["metadata"] == {"kind": "fedpc_round_state", "run": 1}
    assert "telemetry/rounds" in tm["keys"]
    assert ("accountant/eps_sum" in tm["keys"]) == masked
    with np.load(tmp_path / "j" / "ckpt_00000003.npz") as a, \
            np.load(tmp_path / "t" / "ckpt_00000003.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_resume_across_packages_both_ways(tmp_path, masked):
    jw, tw = _wires(masked)
    p0, sizes, steps = _inputs(4)
    jlike = jrd.init_round_state({"w": jnp.asarray(p0)}, N,
                                 privacy=jw.privacy)
    tlike = trd.init_round_state({"w": torch.from_numpy(p0)}, N,
                                 privacy=tw.privacy, device="cpu")
    j_full = _run_jax(jw, jlike, sizes, steps)
    t_full = _run_torch(tw, tlike, sizes, steps)
    # A JAX checkpoint after 2 rounds, resumed in the port.
    jrd.save_round_state(str(tmp_path / "j"), _run_jax(jw, jlike, sizes,
                                                       steps[:2]))
    loaded, manifest = trd.load_round_state(str(tmp_path / "j"), tlike)
    assert manifest["metadata"]["kind"] == "fedpc_round_state"
    assert int(loaded.round) == 3 and int(loaded.telemetry.rounds) == 2
    _same_state(_run_torch(tw, loaded, sizes, steps[2:]), j_full)
    _same_state(t_full, j_full)
    # A port checkpoint after 2 rounds, resumed in the JAX package.
    trd.save_round_state(str(tmp_path / "t"), _run_torch(tw, tlike, sizes,
                                                         steps[:2]))
    jloaded, _ = jrd.load_round_state(str(tmp_path / "t"), jlike)
    _same_state(t_full, _run_jax(jw, jloaded, sizes, steps[2:]))


def test_round_state_loads_onto_like_device_and_dtype(tmp_path):
    st = trd.init_round_state({"w": torch.ones(ROWS * 128)}, N,
                              privacy=_spec("torch", True), device="cpu")
    trd.save_round_state(str(tmp_path), st)
    like = st._replace(prev_costs=torch.zeros(N, dtype=torch.float64))
    back, _ = trd.load_round_state(str(tmp_path), like)
    assert back.prev_costs.dtype == torch.float64
    assert torch.isinf(back.prev_costs).all()
    assert back.accountant.spent_rounds.dtype == torch.int32
    no_carry = st._replace(telemetry=None)     # the file's carry: ignored
    back, _ = trd.load_round_state(str(tmp_path), no_carry)
    assert back.telemetry is None


# -- resume at the simulator, both drivers -----------------------------------

def _sim(cfg) -> FedSimulator:
    x, y = SyntheticClassification(n_samples=N * 64, n_features=16,
                                   n_classes=5, seed=0).generate()
    splits = [np.arange(k * 64, (k + 1) * 64) for k in range(N)]
    loaders = federated_loaders((x, y), splits, seed=0, batch_menu=(32,))
    cfgs = make_worker_configs(N, [64] * N, seed=0, batch_menu=(32,))
    workers = [Worker(cfg=cfgs[k], loader=loaders[k],
                      loss_and_grad=mlp_loss_and_grad) for k in range(N)]
    params = init_mlp_classifier(torch.Generator().manual_seed(0), 16, 5,
                                 hidden=(32,), device="cpu")
    return FedSimulator(workers, params, cfg, device="cpu")


@pytest.mark.parametrize("driver", ["run_fedpc", "run_fedpc_scan"])
@pytest.mark.parametrize("masked", [False, True])
def test_resumed_run_equals_one_run(tmp_path, driver, masked):
    cfg = TCfg(n_workers=N, privacy=_spec("torch", masked))
    full = getattr(_sim(cfg), driver)(rounds=3)
    sim = _sim(cfg)
    first = getattr(sim, driver)(rounds=2)
    trd.save_round_state(str(tmp_path), first.round_state)
    like = trd.init_round_state(sim.init_params, N,
                                fl.layout_of(sim.init_params),
                                privacy=cfg.privacy, device="cpu")
    loaded, _ = trd.load_round_state(str(tmp_path), like)
    rest = getattr(sim, driver)(rounds=1, state=loaded)
    assert first.pilot_history + rest.pilot_history == full.pilot_history
    assert first.costs + rest.costs == full.costs
    assert (first.telemetry.rounds + rest.telemetry.rounds
            == full.telemetry.rounds)
    _leaves_equal(rest.round_state._asdict(), full.round_state._asdict())
    _leaves_equal(rest.params, full.params)
