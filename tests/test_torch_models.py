"""The port's model layers, attention, optimizers and weight conversion
against the JAX package's, unit by unit, on the same numpy inputs.

Held in float32 within ``rtol=1e-5, atol=1e-6`` (norms, rotations,
sinusoids: elementwise float32 with XLA's and ATen's own ``pow``, ``cos``
and ``rsqrt``, a few ulps apart) and within ``rtol=1e-4, atol=1e-5``
where a product sums over a head or a sequence (attention, the blocked
online softmax, a prefill and its decode steps): XLA and ATen add in other
orders. The blocked path is held to the materialized one at S = 1,024
with 512-key blocks, and the sliding-window ring of reduced
``mistral-nemo-12b`` (window 64) through a 96-token prompt and decode
steps past the wrap. bfloat16 weights cross over bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import ffn as jffn
from repro.models import layers as jl
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import ffn as tffn
from repro_torch.models import layers as tl
from repro_torch.optim import optimizers as topt
from repro_torch.utils import tree_leaves

F32 = dict(rtol=1e-5, atol=1e-6)
SUMS = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=F32):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48), dtype=np.float32) * 3
    scale = rng.standard_normal(48, dtype=np.float32)
    bias = rng.standard_normal(48, dtype=np.float32)
    jd, td = jl.dtype_of(dtype), tl.dtype_of(dtype)
    jx = jnp.asarray(x, jd)
    tx = _t(x).to(td)
    out = tl.rms_norm(tx, _t(scale), 1e-5)
    assert out.dtype == td
    tol = F32 if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    _close(out, jl.rms_norm(jx, jnp.asarray(scale), 1e-5), tol)
    _close(tl.layer_norm(tx, _t(scale), _t(bias)),
           jl.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias)), tol)
    _close(tl.silu(_t(x)), jl.silu(jnp.asarray(x)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 64, theta)
    tc, ts = tl.rope_cos_sin(_t(pos), 64, theta)
    _close(tl.rope_freqs(64, theta), jl.rope_freqs(64, theta))
    _close(tc, jc, SUMS)
    _close(ts, js, SUMS)
    x = rng.standard_normal((2, 7, 3, 64), dtype=np.float32)
    # rotate-half, not interleaved: the same cos/sin on both packages
    _close(tl.apply_rope(_t(x), _t(jc), _t(js)),
           jl.apply_rope(jnp.asarray(x), jc, js))


def test_mrope():
    rng = np.random.default_rng(2)
    sections = (4, 6, 6)
    pos = rng.integers(0, 50, (3, 2, 9)).astype(np.int32)
    jc, js = jl.mrope_cos_sin(jnp.asarray(pos), 32, 1e6, sections)
    tc, ts = tl.mrope_cos_sin(_t(pos), 32, 1e6, sections)
    assert tc.shape == (2, 9, 16)
    _close(tc, jc, SUMS)
    _close(ts, js, SUMS)
    with pytest.raises(ValueError):
        tl.mrope_cos_sin(_t(pos), 32, 1e6, (4, 6, 5))


@pytest.mark.parametrize("pos", [0, 7, 1499])
def test_sinusoids(pos):
    want = jl.sinusoidal_at(jnp.asarray(pos, jnp.int32), 64)
    _close(tl.sinusoidal_at(pos, 64), want)
    _close(tl.sinusoidal_at(torch.tensor(pos), 64), want)
    np.testing.assert_array_equal(tl.sinusoidal_positions(40, 64),
                                  jl.sinusoidal_positions(40, 64))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    cfg = jget("fedpc-paper").reduced().replace(ffn_act=act)
    p = jffn.init_mlp(cfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(3).standard_normal((2, 5, cfg.d_model),
                                                 dtype=np.float32)
    _close(tffn.mlp(params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                      device="cpu"), cfg, _t(x)),
           jffn.mlp(p, cfg, jnp.asarray(x)), SUMS)


def _qkv(rng, b, sq, sk, h, hk, dh):
    return (rng.standard_normal((b, sq, h, dh), dtype=np.float32),
            rng.standard_normal((b, sk, hk, dh), dtype=np.float32),
            rng.standard_normal((b, sk, hk, dh), dtype=np.float32))


@pytest.mark.parametrize("h,hk", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("window", [None, 5])
def test_gqa_sdpa(h, hk, window):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 12, 12, h, hk, 16)
    jm = jattn.causal_mask(12, window)
    tm = tattn.causal_mask(12, window)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                       16)
    _close(tattn._sdpa(_t(q), _t(k), _t(v), tm, 16), want, SUMS)
    # no mask (cross attention), and KV-major head order: head i reads
    # KV head i // (h // hk)
    _close(tattn._sdpa(_t(q), _t(k), _t(v), None, 16),
           jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                       16), SUMS)


@pytest.mark.parametrize("window", [None, 300])
def test_blocked_equals_materialized_at_1024(window):
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 1024, 1024, 4, 2, 16)
    tq, tk, tv = _t(q), _t(k), _t(v)
    blocked = tattn._sdpa_blocked(tq, tk, tv, 16, True, window, 512)
    full = tattn._sdpa(tq, tk, tv, tattn.causal_mask(1024, window), 16)
    _close(blocked, full.numpy(), SUMS)
    _close(blocked, jattn._sdpa_blocked(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), 16, True, window,
                                        512), SUMS)
    # the prefill dispatcher takes the blocked path here, the train path
    # the materialized one
    assert tattn.ATTN_BLOCK_PREFILL[0] == 512
    assert tattn.ATTN_BLOCK[0] is None
    _close(tattn._sdpa_full_seq(tq, tk, tv, 16, True, window,
                                grad_path=False), blocked.numpy(), F32)
    _close(tattn._sdpa_full_seq(tq, tk, tv, 16, True, window), full.numpy(),
           F32)


_SWA = {}


def _swa_models():
    """Reduced mistral-nemo (window 64) in both packages, one set of
    weights."""
    if not _SWA:
        cfg = jget("mistral-nemo-12b").reduced()
        assert cfg.sliding_window == 64
        jm, tm = jbuild(cfg), tbuild(tget("mistral-nemo-12b").reduced())
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
        _SWA.update(cfg=cfg, jm=jm, tm=tm, jp=jp, tp=tp)
    return _SWA


@pytest.mark.parametrize("pos_kind", ["int", "tensor"])
def test_swa_ring_past_the_wrap(pos_kind):
    m = _swa_models()
    cfg, jm, tm = m["cfg"], m["jm"], m["tm"]
    B, S, steps = 2, 96, 40                    # 96 > 64: a ring prefill
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab, (B, S + steps)).astype(np.int32)
    js = jm.init_decode_state(B, 256)
    ts = tm.init_decode_state(B, 256, device="cpu")
    assert ts["units"]["b0"]["k"].shape[2] == 64
    jlog, js = jax.jit(jm.prefill)(m["jp"], {"tokens": jnp.asarray(
        toks[:, :S])}, js)
    with torch.no_grad():
        tlog, ts = tm.prefill(m["tp"], {"tokens": _t(toks[:, :S])}, ts)
    _close(tlog, jlog, SUMS)
    jdec = jax.jit(jm.decode_step)
    for i in range(S, S + steps):             # 96..135 wraps at 128
        tok = toks[:, i:i + 1]
        jlog, js = jdec(m["jp"], js, {"token": jnp.asarray(tok),
                                      "pos": jnp.asarray(i, jnp.int32)})
        with torch.no_grad():
            tlog, ts = tm.decode_step(m["tp"], ts, {
                "token": _t(tok),
                "pos": i if pos_kind == "int" else torch.tensor(i)})
        _close(tlog, jlog, SUMS)
    for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        _close(a, b, SUMS)


def test_swa_prefill_equals_sequential():
    m = _swa_models()
    cfg, tm = m["cfg"], m["tm"]
    toks = _t(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 96)).astype(np.int32))
    with torch.no_grad():
        a, sa = tm.prefill(m["tp"], {"tokens": toks},
                           tm.init_decode_state(2, 128, device="cpu"))
        b, sb = tm.prefill_sequential(m["tp"], {"tokens": toks},
                                      tm.init_decode_state(2, 128,
                                                           device="cpu"))
    _close(a, b.numpy(), SUMS)
    for x, y in zip(tree_leaves(sa), tree_leaves(sb)):
        _close(x, y.numpy(), SUMS)


def _grads(rng, params):
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)


@pytest.mark.parametrize("name,kw", [
    ("momentum", {}), ("momentum", {"accum_dtype": "bfloat16"}),
    ("adam", {}), ("adam", {"accum_dtype": "bfloat16"})])
def test_optimizers_match(name, kw):
    rng = np.random.default_rng(8)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    dt = kw.pop("accum_dtype", None)
    jkw, tkw = dict(kw), dict(kw)
    if dt is not None:
        jkw["accum_dtype"] = jl.dtype_of(dt)
        tkw["accum_dtype"] = tl.dtype_of(dt)
    jo, to = jopt.get(name, **jkw), topt.get(name, **tkw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    tol = F32 if dt is None else dict(rtol=2e-2, atol=2e-3)
    for _ in range(3):
        g = _grads(rng, params)
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           0.01)
        tu, ts = to.update(params_from_numpy(g, device="cpu"), ts, tp, 0.01)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
            assert a.dtype == tl.dtype_of(dt or "float32") or \
                a.dtype == torch.int32
            _close(a, b, tol)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            _close(a, b, tol)


def test_bfloat16_leaves_cross_bit_for_bit():
    rng = np.random.default_rng(9)
    tree = {"w": jnp.asarray(rng.standard_normal((4, 6)) * 100,
                             jnp.bfloat16),
            "n": {"s": jnp.asarray([1.0, -0.0, np.inf, 1e-40, 3.1415],
                                   jnp.bfloat16)},
            "f": jnp.asarray(rng.standard_normal(3), jnp.float32)}
    out = params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                            device="cpu")
    assert out["w"].dtype == out["n"]["s"].dtype == torch.bfloat16
    assert out["f"].dtype == torch.float32
    for t, j in ((out["w"], tree["w"]), (out["n"]["s"], tree["n"]["s"])):
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16))


def test_dense_init_draws_in_chunks_on_the_generators_device():
    g = torch.Generator().manual_seed(3)
    w = tl.dense_init(g, 64, 96)
    assert w.dtype == torch.float32 and w.shape == (64, 96)
    assert float(w.abs().max()) <= 2.0 / 8.0
    # a leaf of at most CHUNK values is one draw: the MLP's weights keep
    # the bits of a single (d_in, d_out) draw
    g = torch.Generator().manual_seed(3)
    u = torch.rand((64, 96), generator=g, dtype=torch.float64)
    z = np.sqrt(2.0) * torch.erfinv(2.0 * (tl._LO + u * (tl._HI - tl._LO))
                                    - 1.0)
    assert torch.equal(w, (z.clamp(-2.0, 2.0) / 8.0).float())
    e = tl.embed_init(torch.Generator().manual_seed(0), 50, 8,
                      torch.bfloat16)
    assert e.dtype == torch.bfloat16 and e.shape == (50, 8)


def test_tree_walks_free_their_leaves_without_the_cycle_collector():
    # init_stack flattens a unit's draw a unit at a time: a tree walk that
    # kept its leaves in a reference cycle would hold every draw (21 GB
    # of a 40-layer qwen3-14b) until the cyclic collector ran.
    import gc
    import weakref

    from repro_torch.utils import tree_flatten, tree_map, tree_unflatten
    leaf = torch.zeros(4)
    ref = weakref.ref(leaf)
    tree = {"a": leaf, "b": [torch.ones(2), (torch.ones(1),)]}
    gc.disable()
    try:
        leaves, treedef = tree_flatten(tree)
        assert tree_unflatten(treedef, leaves)["a"] is leaf
        tree_map(lambda x: x, tree)
        del leaves, tree, leaf
        assert ref() is None
    finally:
        gc.enable()
