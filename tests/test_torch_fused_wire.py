"""The port's wire kernels against the JAX package's Pallas kernels.

The same numpy inputs go through ``repro.kernels.fused_wire`` (interpret
mode on the CPU) and through the port's wrappers, which take the plain
PyTorch version for CPU tensors. Both are held **bitwise**: the uplink is
exact integer logic on the same float32 compares, and the master folds
workers in the same order and rounds ``field·w − w`` and
``q − coeff·mult`` once each, as XLA:CPU contracts them into fused
multiply-adds under jit.

``test_torch_kernels_gpu`` holds the CUDA kernels against these plain
versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_wire as jfw
from repro.kernels import ref as jref
from repro_torch.kernels import fused_wire as tfw
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

ALPHA1 = 0.01
ALPHA0 = 0.01


def _history(rng, n, r):
    """q (N, R, 512), p1/p2 (R, 512) with the edge cases planted: exact
    |delta| == beta·|step| ties for every beta, step == 0, a product
    delta·step that underflows to 0, and an all-zero tail row."""
    q = rng.standard_normal((n, r, 512), dtype=np.float32) * 0.05
    p1 = rng.standard_normal((r, 512), dtype=np.float32) * 0.05
    p2 = p1 + rng.standard_normal((r, 512), dtype=np.float32) * 0.02
    p2[0, :64] = p1[0, :64]                       # step == 0
    p1[0, 64:128], p2[0, 64:128] = 0.0, -0.5      # step == 0.5 from p1 = 0
    p1[0, 128:192], p2[0, 128:192] = 1e-23, 0.0   # tiny step ...
    q[:, 0, 128:192] = 2e-23                      # ... and tiny delta
    p1[-1], p2[-1], q[:, -1] = 0.0, 0.0, 0.0      # zero tail row
    return q, p1, p2


def _plant_ties(q, beta):
    """At p1 = 0, p2 = -0.5: q = ±fl(beta·0.5) is an exact tie."""
    b = np.broadcast_to(np.asarray(beta, np.float32).reshape(-1, 1),
                        (q.shape[0], 32))
    half = (b * np.float32(0.5)).astype(np.float32)
    q[:, 0, 64:96] = half
    q[:, 0, 96:128] = -half


def _t(t):
    return torch.tensor(t, dtype=torch.int32)


@pytest.mark.parametrize("n", [1, 3, 10])
@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("vector_beta", [False, True])
def test_uplink_plain_bitwise(n, t, vector_beta):
    rng = np.random.default_rng(100 * n + 10 * t + vector_beta)
    r = 8
    q, p1, p2 = _history(rng, n, r)
    beta = (rng.choice([0.1, 0.2, 0.3], n).astype(np.float32)
            if vector_beta else np.float32(0.2))
    _plant_ties(q, beta)
    want = np.asarray(jfw.ternary_pack_stacked_2d(
        jnp.asarray(q), jnp.asarray(p1), jnp.asarray(p2), t,
        jnp.asarray(beta), ALPHA1, interpret=True, block_rows=r,
        block_workers=n))
    before = dict(tfw.LAUNCHES)
    got = tfw.ternary_pack_stacked(
        torch.from_numpy(q), torch.from_numpy(p1), torch.from_numpy(p2),
        _t(t), ops.per_worker(torch.from_numpy(np.asarray(beta)), n,
                              torch.device("cpu")), ALPHA1).numpy()
    assert tfw.LAUNCHES == before             # a CPU call launches nothing
    np.testing.assert_array_equal(got, want)
    assert (got[:, -1] == 0b01010101).all()   # zero tail → code 0 fields
    if t == 2:                                # the planted cases
        assert (got[:, 0, :16] == 0b01010101).all()     # step == 0
        assert (got[:, 0, 32:48] == 0b01010101).all()   # underflow → 0


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("n,block_workers", [(1, 1), (3, 3), (10, 1),
                                             (10, 10)])
def test_master_plain_bitwise(t, n, block_workers):
    rng = np.random.default_rng(7 * n + t)
    r = 8
    q, p1, p2 = _history(rng, n, r)
    # Every byte value, the unused field 3 included: the fold's fused
    # multiply-add gives the reference's bits there too.
    packed = rng.integers(0, 256, (n, r, 128)).astype(np.uint8)
    packed[:, -1] = 0b01010101                 # zero tail on the wire
    w = rng.random(n, dtype=np.float32) / n
    k_star = int(rng.integers(n))
    w[k_star] = 0.0                            # the pilot's zeroed weight
    q_pilot = q[k_star]
    block_rows = r if block_workers == n else r // 2
    want = np.asarray(jfw.packed_master_update_2d(
        jnp.asarray(q_pilot), jnp.asarray(packed), jnp.asarray(w),
        jnp.asarray(p1), jnp.asarray(p2), t, ALPHA0, interpret=True,
        block_rows=block_rows, block_workers=block_workers))
    before = dict(tfw.LAUNCHES)
    got = tfw.packed_master_update(
        torch.from_numpy(q), torch.tensor(k_star), torch.from_numpy(packed),
        torch.from_numpy(w), torch.from_numpy(p1), torch.from_numpy(p2),
        _t(t), ALPHA0).numpy()
    assert tfw.LAUNCHES == before
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not got[-1].any()                   # the zero tail stays zero


def test_wrappers_refuse_what_the_kernel_does_not_take():
    q = torch.zeros((2, 8, 512))
    p = torch.zeros((8, 512))
    beta = torch.full((2,), 0.2)
    with pytest.raises(ValueError):            # wrong history shape
        tfw.ternary_pack_stacked(q, p[:4], p, _t(1), beta, ALPHA1)
    with pytest.raises(ValueError):            # float64 input
        tfw.ternary_pack_stacked(q.double(), p, p, _t(1), beta, ALPHA1)
    with pytest.raises(ValueError):            # non-contiguous
        tfw.ternary_pack_stacked(q.transpose(0, 1).contiguous()
                                 .transpose(0, 1), p, p, _t(1), beta, ALPHA1)
    packed = torch.zeros((2, 8, 128), dtype=torch.uint8)
    with pytest.raises(ValueError):            # round index not int32
        tfw.packed_master_update(q, torch.tensor(0), packed, beta, p, p,
                                 torch.tensor(1), ALPHA0)
    with pytest.raises(ValueError):            # pilot index not int64
        tfw.packed_master_update(q, _t(0), packed, beta, p, p, _t(1), ALPHA0)
    with pytest.raises(ValueError):            # one worker's view, not all
        tfw.packed_master_update(q[0], torch.tensor(0), packed, beta, p, p,
                                 _t(1), ALPHA0)


def test_flat_oracles_match():
    # The flat-vector oracles of kernels/ref.py against the JAX package's:
    # Eq. (5) + pack bitwise, and the order-exact master against its jitted
    # twin (the kernels always run under jit, where XLA:CPU fuses the
    # combine).
    rng = np.random.default_rng(3)
    q, p1, p2 = _history(rng, 1, 8)
    q, p1, p2 = q.reshape(-1), p1.reshape(-1), p2.reshape(-1)
    np.testing.assert_array_equal(
        tref.ternary_pack_ref(*map(torch.from_numpy, (q, p1, p2)),
                              0.2).numpy(),
        np.asarray(jref.ternary_pack_ref(q, p1, p2, 0.2)))
    packed = rng.integers(0, 256, (4, q.size // 4)).astype(np.uint8)
    w = rng.random(4, dtype=np.float32)
    w[2] = 0.0
    jit_ref = jax.jit(jref.packed_master_accum_ref, static_argnums=6)
    for t in (1, 2):
        got = tref.packed_master_accum_ref(
            *map(torch.from_numpy, (q, packed, w, p1, p2)), t, ALPHA0)
        want = jit_ref(q, packed, w, p1, p2, t, ALPHA0)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
