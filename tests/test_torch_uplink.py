"""The port's one-worker uplinks and the round built from them, against the
JAX package.

The same numpy buffers go through ``repro.kernels.ops.flat_ternary_pack``
/ ``flat_ternary_pack_traced`` and ``repro.fed.rounds.WirePath.uplink`` /
``uplink_traced`` (Pallas in interpret mode on the CPU) and through the
port's counterparts, which take the plain PyTorch versions for CPU
tensors. The wire bytes are exact integer logic on the same float32
compares, so they are held **bitwise**. A round built a worker at a time
(one uplink each, then the fused master) is held bitwise against the
batched round of the port and against the JAX package's per-worker round.
``core/update.py`` reduces over the workers with a tensordot in an order
each backend picks, so its Eq. (3) outputs are held at the JAX package's
own tolerance (``rtol=1e-5, atol=1e-6``, ``tests/test_kernels.py``) and
its weights bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import update as jup
from repro.fed import rounds as jrd
from repro.kernels import ops as jops
from repro_torch.core import flat as tfl
from repro_torch.core import update as tup
from repro_torch.fed import rounds as trd
from repro_torch.kernels import fused_wire as tfw
from repro_torch.kernels import ops as tops

BETA, ALPHA0, ALPHA1 = 0.2, 0.01, 0.01
ROWS = 32
# A §3.3 wire byte whose four 2-bit fields all decode to code 0.
ZERO_CODES_BYTE = 0b01010101


def _buffers(rng, n, rows=ROWS):
    """(N, rows, 128) worker buffers near a (rows, 128) history, with
    step == 0, exact Eq. (5) ties at beta 0.2, an underflowing product and
    an all-zero tail row planted."""
    p1 = rng.standard_normal((rows, 128), dtype=np.float32) * 0.05
    p2 = p1 + rng.standard_normal((rows, 128), dtype=np.float32) * 0.02
    q = p1 + rng.standard_normal((n, rows, 128), dtype=np.float32) * 0.02
    p2[0, :32] = p1[0, :32]                           # step == 0
    p1[1], p2[1] = 0.0, -0.5                          # step == 0.5 ...
    q[:, 1, :32] = np.float32(BETA) * np.float32(0.5)     # ... exact ties
    q[:, 1, 32:64] = -(np.float32(BETA) * np.float32(0.5))
    p1[2, :32], p2[2, :32] = 1e-23, 0.0               # tiny step ...
    q[:, 2, :32] = 2e-23                              # ... and tiny delta
    p1[-1], p2[-1], q[:, -1] = 0.0, 0.0, 0.0          # zero tail row
    return q, p1, p2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("t", [1, 2, 3])
def test_flat_ternary_pack_bitwise(t):
    rng = np.random.default_rng(10 + t)
    q, p1, p2 = _buffers(rng, 2)
    twire = trd.WirePath(trd.WireConfig(ALPHA0, BETA, ALPHA1))
    jwire = jrd.WirePath(jrd.WireConfig(ALPHA0, BETA, ALPHA1))
    before = dict(tfw.LAUNCHES)
    for k in range(2):
        want = np.asarray(jops.flat_ternary_pack(
            q[k], p1, p2, t=t, beta=BETA, alpha1=ALPHA1, interpret=True))
        got = tops.flat_ternary_pack(_t(q[k]), _t(p1), _t(p2), t=t,
                                     beta=BETA, alpha1=ALPHA1).numpy()
        assert got.shape == (ROWS // 4, 128) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            twire.uplink(_t(q[k]), _t(p1), _t(p2), t=t).numpy(),
            np.asarray(jwire.uplink(q[k], p1, p2, t=t)))
        assert (got[-1, -32:] == ZERO_CODES_BYTE).all()   # zero row → code 0
    assert tfw.LAUNCHES == before                     # a CPU call launches nothing


def test_round1_uplink_never_reads_the_older_history():
    # Eq. (4) has no P^{t-2}: a NaN history there changes no byte.
    rng = np.random.default_rng(4)
    q, p1, p2 = _buffers(rng, 1)
    nan = np.full_like(p2, np.nan)
    a = tops.flat_ternary_pack(_t(q[0]), _t(p1), _t(p2), t=1, beta=BETA,
                               alpha1=ALPHA1)
    b = tops.flat_ternary_pack(_t(q[0]), _t(p1), _t(nan), t=1, beta=BETA,
                               alpha1=ALPHA1)
    assert torch.equal(a, b)


@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("per_worker", [False, True])
def test_flat_ternary_pack_traced_bitwise(t, per_worker):
    n = 3
    rng = np.random.default_rng(20 + t + 5 * per_worker)
    q, p1, p2 = _buffers(rng, n)
    betas = (np.array([0.1, 0.2, 0.3], np.float32) if per_worker
             else np.full(n, BETA, np.float32))
    twire = trd.WirePath(trd.WireConfig(ALPHA0, BETA, ALPHA1))
    jwire = jrd.WirePath(jrd.WireConfig(ALPHA0, BETA, ALPHA1))
    tt = torch.tensor(t, dtype=torch.int32)
    tb = _t(betas)
    for k in range(n):
        want = np.asarray(jops.flat_ternary_pack_traced(
            q[k], p1, p2, t=jnp.int32(t), beta=jnp.float32(betas[k]),
            alpha1=ALPHA1, interpret=True))
        got = tops.flat_ternary_pack_traced(
            _t(q[k]), _t(p1), _t(p2), t=tt, beta=tb[k], alpha1=ALPHA1)
        np.testing.assert_array_equal(got.numpy(), want)
        beta_k = tb[k] if per_worker else None       # None: the shared cfg.beta
        np.testing.assert_array_equal(
            twire.uplink_traced(_t(q[k]), _t(p1), _t(p2), t=tt,
                                beta=beta_k).numpy(),
            np.asarray(jwire.uplink_traced(
                q[k], p1, p2, t=jnp.int32(t),
                beta=None if beta_k is None else jnp.float32(betas[k]))))
        # The traced uplink at a known round is the static one's bytes.
        if not per_worker:
            np.testing.assert_array_equal(
                got.numpy(), twire.uplink(_t(q[k]), _t(p1), _t(p2),
                                          t=t).numpy())


def test_static_round_refuses_device_values():
    buf = torch.zeros((ROWS, 128))
    wire = trd.WirePath()
    with pytest.raises(TypeError):
        wire.uplink(buf, buf, buf, t=torch.tensor(2))
    with pytest.raises(TypeError):
        tops.flat_ternary_pack(buf, buf, buf, t=2, beta=torch.tensor(0.2),
                               alpha1=ALPHA1)
    v = buf.view(8, 512)
    with pytest.raises(ValueError):            # history of another shape
        tfw.ternary_pack(v, v[:4], v, 0.2)
    with pytest.raises(ValueError):            # round index not int32
        tfw.ternary_pack_any(v, v, v, torch.tensor(2), torch.tensor(0.2),
                             torch.tensor(0.01))
    with pytest.raises(ValueError):            # one beta_k, not a vector
        tfw.ternary_pack_any(v, v, v, torch.tensor(2, dtype=torch.int32),
                             torch.full((2,), 0.2), torch.tensor(0.01))


@pytest.mark.parametrize("n", [2, 5])
@pytest.mark.parametrize("t", [1, 2, 3])
def test_per_worker_round_equals_batched_round(n, t):
    """One uplink a worker, the pilot's included (its weight is 0), then
    the fused master: the batched round's bytes and new buffer, bit for
    bit, and the JAX package's per-worker round (pilot row zero-filled,
    ``tests/test_rounds.py``) bit for bit."""
    rng = np.random.default_rng(30 + 10 * n + t)
    q, p1, p2 = _buffers(rng, n)
    shares = np.linspace(0.5, 1.5, n).astype(np.float32)
    shares /= shares.sum()
    k_star = n // 2
    twire = trd.WirePath(trd.WireConfig(ALPHA0, BETA, ALPHA1))
    tq, tp1, tp2 = _t(q), _t(p1), _t(p2)
    w = twire.weights(_t(shares), torch.tensor(k_star), t)
    packed = torch.stack([twire.uplink(tq[k], tp1, tp2, t=t)
                          for k in range(n)])
    new = twire.master(tq, torch.tensor(k_star), packed, w, tp1, tp2, t=t)
    want_new, want_packed = twire.round_from_stacked(
        tq, torch.tensor(k_star), w, tp1, tp2, t=t)
    assert torch.equal(packed, want_packed)
    assert torch.equal(new.view(torch.int32), want_new.view(torch.int32))

    betas = np.ones(n) if t == 1 else np.full(n, BETA)
    jw = jup.masked_weights(jnp.asarray(shares), jnp.asarray(betas,
                                                             jnp.float32),
                            k_star)
    np.testing.assert_array_equal(w.numpy().view(np.uint32),
                                  np.asarray(jw).view(np.uint32))
    jpacked = [np.full((ROWS // 4, 128), ZERO_CODES_BYTE, np.uint8)
               if k == k_star else np.asarray(jops.flat_ternary_pack(
                   q[k], p1, p2, t=t, beta=BETA, alpha1=ALPHA1,
                   interpret=True)) for k in range(n)]
    jnew = jops.flat_master_update(q[k_star], jnp.stack(jpacked), jw, p1, p2,
                                   t=t, alpha0=ALPHA0, interpret=True)
    np.testing.assert_array_equal(new.numpy().view(np.uint32),
                                  np.asarray(jnew).view(np.uint32))


def test_traced_round_matches_batched_round_with_per_worker_beta():
    n, t = 4, 3
    rng = np.random.default_rng(7)
    q, p1, p2 = _buffers(rng, n)
    betas = _t(np.array([0.1, 0.25, 0.2, 0.3], np.float32))
    shares = torch.full((n,), 1.0 / n)
    twire = trd.WirePath()
    tq, tp1, tp2 = _t(q), _t(p1), _t(p2)
    tt = torch.tensor(t, dtype=torch.int32)
    k = torch.tensor(1)
    w = twire.weights(shares, k, tt, betas=betas)
    packed = torch.stack([twire.uplink_traced(tq[i], tp1, tp2, t=tt,
                                              beta=betas[i])
                          for i in range(n)])
    new = twire.master(tq, k, packed, w, tp1, tp2, t=tt)
    want_new, want_packed = twire.round_from_stacked(tq, k, w, tp1, tp2,
                                                     t=tt, betas=betas)
    assert torch.equal(packed, want_packed)
    assert torch.equal(new.view(torch.int32), want_new.view(torch.int32))


# -- core/update.py ---------------------------------------------------------

def _tree(rng):
    return {"w0": rng.standard_normal((33, 17), dtype=np.float32),
            "b0": rng.standard_normal(17, dtype=np.float32),
            "scalar": rng.standard_normal((), dtype=np.float32)}


def test_masked_weights_bitwise():
    shares = np.array([0.1, 0.4, 0.2, 0.3], np.float32)
    betas = np.array([0.2, 0.1, 0.3, 0.25], np.float32)
    for k in range(4):
        got = tup.masked_weights(_t(shares), _t(betas), torch.tensor(k))
        want = jup.masked_weights(shares, betas, k)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
        assert got[k] == 0


@pytest.mark.parametrize("t", [1, 3])
def test_master_update_tree_matches(t):
    rng = np.random.default_rng(40 + t)
    n, k_star = 5, 2
    q = _tree(rng)
    p1 = _tree(rng)
    p2 = {k: v * np.float32(0.9) for k, v in p1.items()}
    tern = {k: rng.integers(-1, 2, (n,) + np.shape(v)).astype(np.int8)
            for k, v in q.items()}
    shares = rng.random(n).astype(np.float32)
    shares /= shares.sum()
    betas = np.full(n, BETA, np.float32)
    want = jup.master_update_tree(q, tern, shares, betas, k_star, p1, p2, t,
                                  ALPHA0)
    conv = (lambda tree: {k: torch.from_numpy(np.asarray(v))
                          for k, v in tree.items()})
    got = tup.master_update_tree(conv(q), conv(tern), _t(shares), _t(betas),
                                 torch.tensor(k_star), conv(p1), conv(p2),
                                 torch.tensor(t), ALPHA0)
    for name in q:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # Each branch on its own.
    fn = (jup.master_update_round1(q["w0"], tern["w0"], shares, k_star,
                                   ALPHA0) if t == 1 else
          jup.master_update(q["w0"], tern["w0"], shares, betas, k_star,
                            p1["w0"], p2["w0"]))
    tn = (tup.master_update_round1(_t(q["w0"]), _t(tern["w0"]), _t(shares),
                                   k_star, ALPHA0) if t == 1 else
          tup.master_update(_t(q["w0"]), _t(tern["w0"]), _t(shares),
                            _t(betas), k_star, _t(p1["w0"]), _t(p2["w0"])))
    np.testing.assert_allclose(tn.numpy(), np.asarray(fn), rtol=1e-5,
                               atol=1e-6)


def test_flat_round_matches_master_update_tree():
    """Per-worker uplinks + fused master over a flattened tree == the tree
    reference of ``core/update.py`` on the same codes (the JAX package's
    ``tests/test_flat_wire.py`` check, on the port)."""
    rng = np.random.default_rng(50)
    n, t, k_star = 4, 3, 1
    tree = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    layout = tfl.layout_of(tree)
    p1 = tree
    p2 = {k: v * 0.9 for k, v in tree.items()}
    locals_ = [{k: v + 0.02 * (i + 1) * torch.sign(v)
                for k, v in tree.items()} for i in range(n)]
    shares = torch.linspace(0.5, 1.5, n)
    shares = shares / shares.sum()
    wire = trd.WirePath(trd.WireConfig(ALPHA0, BETA, ALPHA1))
    b1, b2 = tfl.flatten_tree(p1, layout), tfl.flatten_tree(p2, layout)
    bufs = torch.stack([tfl.flatten_tree(x, layout) for x in locals_])
    packed = torch.stack([wire.uplink(bufs[k], b1, b2, t=t)
                          for k in range(n)])
    betas = torch.full((n,), BETA)
    w = tup.masked_weights(shares, betas, k_star)
    got = tfl.unflatten_tree(wire.master(bufs, k_star, packed, w, b1, b2,
                                         t=t), layout)
    codes = {k: torch.stack([wire.codes(x[k], p1[k], p2[k], t)
                             for x in locals_]) for k in tree}
    want = tup.master_update_tree(locals_[k_star], codes, shares, betas,
                                  k_star, p1, p2, t, ALPHA0)
    for name in tree:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
