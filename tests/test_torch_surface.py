"""The reference's last public helpers in the port, against the JAX package.

Tolerances:

* ``core.protocol``: Eq. (8) and its relatives at ``weight_bits`` 8, 16
  and 32, N = 1..64, and ``model_size_bytes`` at ``force_itemsize`` 4, 2
  and ``None`` on float32 and bfloat16 trees: exactly equal (the same
  Python float arithmetic in the same order);
* ``core.flat``: ``FlatParams.from_tree`` / ``to_tree`` bitwise, and
  ``FlatLayout.packed_rows`` / ``packed_shard_rows`` / ``packed_bytes``
  equal;
* ``utils``: ``tree_ravel``, ``tree_sub`` and ``tree_allfinite`` equal in
  value and dtype; ``human_bytes`` / ``human_count`` the same strings;
  ``log2_int`` the same values and the same exception types;
* ``optim.momentum(nesterov=True)``: 5 steps within ``rtol=1e-6,
  atol=1e-7``. The port rounds ``decay·v`` and ``+ g`` on their own (two
  eager ops, no FMA); the bound leaves room for an XLA CPU build that
  contracts them into one FMA, which these steps did not need: they
  agree bitwise here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro.core import flat as jfl
from repro.core import protocol as jproto
from repro.optim import optimizers as jopt
from repro_torch import utils as tutils
from repro_torch.convert import params_from_numpy
from repro_torch.core import flat as tfl
from repro_torch.core import protocol as tproto
from repro_torch.optim import optimizers as topt
from repro_torch.utils import tree_leaves

NESTEROV = dict(rtol=1e-6, atol=1e-7)


def _tree_np(rng, dtype=np.float32):
    # layer10 sorts before layer2; ragged sizes leave a zero tail.
    return {"layer2": {"w": rng.standard_normal((5, 7)).astype(dtype)},
            "layer10": {"w": rng.standard_normal((3, 3)).astype(dtype),
                        "b": rng.standard_normal(3).astype(dtype)},
            "emb": rng.standard_normal(11).astype(dtype)}


def _both(tree_np):
    return (jax.tree_util.tree_map(jnp.asarray, tree_np),
            params_from_numpy(tree_np, device="cpu"))


def _bits(x) -> np.ndarray:
    a = np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def _assert_trees_bitwise(t, j):
    tl, jl = tree_leaves(t), jax.tree_util.tree_leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(_bits(a.float() if a.dtype ==
                                            torch.bfloat16 else a),
                                      _bits(np.asarray(b, np.float32)
                                            if b.dtype == jnp.bfloat16
                                            else b))


# --------------------------------------------------------------------------
# core.protocol: Eq. (8) at any weight width
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weight_bits", [8, 16, 32])
def test_eq8_at_any_weight_width(weight_bits):
    for n in range(1, 65):
        for v in (1.0, 4096.0, 84_000_000.0, 29_540_000_000.0):
            assert tproto.fedpc_bytes_per_round(v, n, weight_bits) == \
                jproto.fedpc_bytes_per_round(v, n, weight_bits)
            assert tproto.reduction_vs_fedavg(v, n, weight_bits) == \
                jproto.reduction_vs_fedavg(v, n, weight_bits)
            for code_bits in (2.0, 16.0, 32.0):
                assert tproto._fedpc_wire_bytes(v, n, code_bits,
                                                weight_bits) == \
                    jproto._fedpc_wire_bytes(v, n, code_bits, weight_bits)
    # the paper's R = 16 by default; R = 8 at 16-bit weights
    assert tproto.fedpc_bytes_per_round(16.0, 3) == 16 * 4 + 16 * 2 / 16
    assert tproto.fedpc_bytes_per_round(16.0, 3, 16) == 16 * 4 + 16 * 2 / 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("force_itemsize", [4, 2, None])
def test_model_size_bytes(dtype, force_itemsize):
    tree = _tree_np(np.random.default_rng(0))
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)
    tt = params_from_numpy(jax.tree_util.tree_map(np.asarray, jt),
                           device="cpu")
    got = tproto.model_size_bytes(tt, force_itemsize)
    assert got == jproto.model_size_bytes(jt, force_itemsize)
    itemsize = force_itemsize or {"float32": 4, "bfloat16": 2}[dtype]
    assert got == (35 + 9 + 3 + 11) * itemsize
    if force_itemsize == 4:
        assert tproto.model_size_bytes(tt) == got     # the paper's default


# --------------------------------------------------------------------------
# core.flat: FlatParams and the packed sizes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_params_round_trip_bitwise(dtype):
    jt, tt = _both(_tree_np(np.random.default_rng(1)))
    jt = jax.tree_util.tree_map(lambda a: a.astype(dtype), jt)
    tt = params_from_numpy(jax.tree_util.tree_map(np.asarray, jt),
                           device="cpu")
    jf, tf = jfl.FlatParams.from_tree(jt), tfl.FlatParams.from_tree(tt)
    assert isinstance(tf, tfl.FlatParams)
    assert tf.buf.dtype == torch.float32 and tf.buf.shape == jf.buf.shape
    np.testing.assert_array_equal(_bits(tf.buf), _bits(jf.buf))
    _assert_trees_bitwise(tf.to_tree(), jf.to_tree())
    # an explicit layout, as the reference takes one
    tl2 = tfl.layout_of(tt, shards=4)
    jl2 = jfl.layout_of(jt, shards=4)
    tf2 = tfl.FlatParams.from_tree(tt, tl2)
    np.testing.assert_array_equal(
        _bits(tf2.buf), _bits(jfl.FlatParams.from_tree(jt, jl2).buf))
    assert tf2.layout is tl2
    _assert_trees_bitwise(tf2.to_tree(), jt)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 4095, 4096, 4097, 20_000])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_packed_sizes(n, shards):
    tree_np = {"w": np.zeros(n, np.float32)}
    jt, tt = _both(tree_np)
    jl, tl = jfl.layout_of(jt, shards), tfl.layout_of(tt, shards)
    assert (tl.packed_rows, tl.packed_shard_rows, tl.packed_bytes) == \
        (jl.packed_rows, jl.packed_shard_rows, jl.packed_bytes)
    assert tl.packed_bytes == -(-n // 4)
    assert tl.packed_rows == tl.rows // 4
    assert tl.packed_shard_rows * shards == tl.packed_rows


# --------------------------------------------------------------------------
# utils
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["float32", "bfloat16", "mixed", "empty"])
def test_tree_ravel(kind):
    rng = np.random.default_rng(2)
    if kind == "empty":
        jt, tt = {}, {}
    elif kind == "mixed":
        tree = {"a": rng.standard_normal((2, 3)).astype(np.float32),
                "b": [rng.integers(-9, 9, (4,)).astype(np.int32),
                      rng.standard_normal(5).astype(np.float32)]}
        jt = jax.tree_util.tree_map(jnp.asarray, tree)
        jt["b"][1] = jt["b"][1].astype(jnp.bfloat16)
        tt = params_from_numpy(jax.tree_util.tree_map(np.asarray, jt),
                               device="cpu")
    else:
        jt, tt = _both(_tree_np(rng))
        jt = jax.tree_util.tree_map(lambda a: a.astype(kind), jt)
        tt = params_from_numpy(jax.tree_util.tree_map(np.asarray, jt),
                               device="cpu")
    jv, junravel = jutils.tree_ravel(jt)
    tv, tunravel = tutils.tree_ravel(tt)
    assert tv.dim() == 1
    assert str(tv.dtype).removeprefix("torch.") == str(jv.dtype)
    np.testing.assert_array_equal(_bits(tv.float()),
                                  _bits(np.asarray(jv, np.float32)))
    _assert_trees_bitwise(tunravel(tv), junravel(jv))
    # one dtype: the unravel keeps the vector's; several: it must be theirs
    if kind in ("float32", "bfloat16"):
        _assert_trees_bitwise(tunravel(tv.float() * 2),
                              junravel(jv.astype(jnp.float32) * 2))
    elif kind == "mixed":
        with pytest.raises(TypeError):
            junravel(jv.astype(jnp.float16))
        with pytest.raises(TypeError):
            tunravel(tv.half())


def test_tree_sub():
    rng = np.random.default_rng(3)
    (ja, ta), (jb, tb) = _both(_tree_np(rng)), _both(_tree_np(rng))
    _assert_trees_bitwise(tutils.tree_sub(ta, tb), jutils.tree_sub(ja, jb))


@pytest.mark.parametrize("poison", [None, np.inf, -np.inf, np.nan])
def test_tree_allfinite(poison):
    tree = _tree_np(np.random.default_rng(4))
    if poison is not None:
        tree["layer10"]["b"][1] = poison
    jt, tt = _both(tree)
    got = tutils.tree_allfinite(tt)
    assert isinstance(got, torch.Tensor) and got.dim() == 0
    assert got.dtype == torch.bool and got.device == torch.device("cpu")
    assert bool(got) == bool(jutils.tree_allfinite(jt)) == (poison is None)


def test_human_strings():
    for x in (0, 1, 1023, 1024, 1536.5, 10**6, 2**30, 7.5 * 2**40, 2**50,
              2**60, 2**70, -2048, 0.004):
        assert tutils.human_bytes(x) == jutils.human_bytes(x), x
    for x in (0, 1, 999, 1000, 12_345, 1.5e6, 3e9, 4e12, 5e15, 6e18, -2500,
              0.004):
        assert tutils.human_count(x) == jutils.human_count(x), x
    assert tutils.human_bytes(1536) == "1.50 KiB"
    assert tutils.human_count(1.5e6) == "1.50M"


@pytest.mark.parametrize("x", [1, 2, 4, 1024, 2**40, 0, 3, 6, 1000, -4])
def test_log2_int(x):
    def outcome(f):
        try:
            return f(x)
        except Exception as e:                      # noqa: BLE001
            return type(e)
    got, want = outcome(tutils.log2_int), outcome(jutils.log2_int)
    assert got == want
    if isinstance(want, int):
        assert 2 ** got == x
    else:
        assert want in (AssertionError, ValueError)


# --------------------------------------------------------------------------
# optim: Nesterov momentum
# --------------------------------------------------------------------------

@pytest.mark.parametrize("decay", [0.9, 0.5])
def test_momentum_nesterov(decay):
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    jo = jopt.momentum(decay, nesterov=True)
    to = topt.momentum(decay, nesterov=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(5):
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            params)
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           0.05)
        tu, ts = to.update(params_from_numpy(g, device="cpu"), ts, tp, 0.05)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        for t, j in ((tu, ju), (ts, js), (tp, jp)):
            for a, b in zip(tree_leaves(t), jax.tree_util.tree_leaves(j)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           **NESTEROV)
    # the Nesterov step is not heavy ball's
    hb = topt.momentum(decay)
    u_hb, _ = hb.update(params_from_numpy(g, device="cpu"), hb.init(tp),
                        tp, 0.05)
    u_n, _ = to.update(params_from_numpy(g, device="cpu"), to.init(tp), tp,
                       0.05)
    assert not torch.equal(u_hb["a"], u_n["a"])


# --------------------------------------------------------------------------
# FedPCConfig's wire widths
# --------------------------------------------------------------------------

def test_fedpc_config_fields_are_the_reference_s():
    import dataclasses

    from repro.core.fedpc import FedPCConfig as JConfig
    from repro_torch.core.fedpc import FedPCConfig as TConfig
    jf, tf = dataclasses.fields(JConfig), dataclasses.fields(TConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [f.default for f in tf] == [f.default for f in jf]
    cfg = TConfig(n_workers=3, weight_bits=16)
    assert (cfg.pack_bits, cfg.weight_bits) == (2, 16)
    assert tproto.fedpc_bytes_per_round(100.0, 3, cfg.weight_bits) == \
        jproto.fedpc_bytes_per_round(100.0, 3, 16)
