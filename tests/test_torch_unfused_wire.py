"""The port's arbitrary-shape kernel API — the unfused §3.3 composition
encode → pack → wire → unpack → Eq. (3), and the fused uplinks over any
shape — against the JAX package.

The same numpy inputs go through ``repro.kernels.ops`` (Pallas in
interpret mode on the CPU) and ``repro_torch.kernels.ops`` (the plain
PyTorch versions for CPU tensors). Codes and bytes are held **bitwise**,
at shapes whose size is not a multiple of 4 or of 512, so the zero pad and
the cut back to n codes or ceil(n/4) bytes are exercised. The unfused
master reduces the workers with a tensordot in the JAX package (an order
XLA picks) and strictly in order in the port, so it is held at the JAX
package's own tolerance, ``rtol=1e-5, atol=1e-6``
(``tests/test_kernels.py``), and **bitwise** against the port's fused
packed master on the same codes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import master_update as tmu
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pack2bit as tpk
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ternary_encode as tte

SHAPES = [(128,), (1000,), (999,), (8, 128), (64, 37), (3, 5, 7), (4096,),
          (2048, 2), (1,)]
BETA, ALPHA = 0.2, 0.01


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _history(shape, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape, dtype=np.float32)
    p1 = rng.standard_normal(shape, dtype=np.float32)
    p2 = rng.standard_normal(shape, dtype=np.float32)
    flat = p2.reshape(-1)
    flat[::7] = p1.reshape(-1)[::7]                  # step == 0 now and then
    return q, p1, p2


@pytest.mark.parametrize("shape", SHAPES)
def test_encode_and_fused_pack_bitwise(shape):
    q, p1, p2 = _history(shape, len(shape) * 1000 + sum(shape))
    tq, tp1, tp2 = _t(q), _t(p1), _t(p2)
    codes = tops.ternary_encode(tq, tp1, tp2, BETA)
    assert codes.shape == shape and codes.dtype == torch.int8
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jops.ternary_encode(q, p1, p2, BETA,
                                                      interpret=True)))
    codes1 = tops.ternary_encode_round1(tq, tp1, ALPHA)
    np.testing.assert_array_equal(
        codes1.numpy(), np.asarray(jops.ternary_encode_round1(
            q, p1, ALPHA, interpret=True)))
    fused = tops.ternary_pack(tq, tp1, tp2, BETA)
    np.testing.assert_array_equal(
        fused.numpy(), np.asarray(jops.ternary_pack(q, p1, p2, BETA,
                                                    interpret=True)))
    fused1 = tops.ternary_pack_round1(tq, tp1, ALPHA)
    np.testing.assert_array_equal(
        fused1.numpy(), np.asarray(jops.ternary_pack_round1(
            q, p1, ALPHA, interpret=True)))
    # fused == pack2bit(encode), as tests/test_flat_wire.py holds the
    # JAX package's kernels.
    assert torch.equal(fused, tops.pack2bit(codes))
    assert torch.equal(fused1, tops.pack2bit(codes1))
    n = codes.numel()
    assert fused.numel() == -(-n // 4)
    if n % 4:        # the zero pad's fields in the last byte are code 0
        tail = int(fused[-1]) >> (2 * (n % 4))
        assert tail == 0b01010101 >> (2 * (n % 4))


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_and_unpack_bitwise(shape):
    rng = np.random.default_rng(sum(shape) + 3)
    codes = rng.integers(-1, 2, shape).astype(np.int8)
    packed = tops.pack2bit(_t(codes))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jops.pack2bit(codes, interpret=True)))
    n = codes.size
    back = tops.unpack2bit(packed, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jops.unpack2bit(jnp.asarray(packed.numpy()),
                                                 n, interpret=True)))
    np.testing.assert_array_equal(back.numpy(), codes.reshape(-1))


@pytest.mark.parametrize("values", ["fields", "int8"])
def test_pack_truncates_as_xla_does(values):
    """Field values {-1, 0, 1, 2} and a random int8 sample: the low 8 bits
    of the int32 sum of (c + 1)·4^j, as the JAX kernel converts it."""
    rng = np.random.default_rng(11)
    lo, hi = (-1, 3) if values == "fields" else (-128, 128)
    codes = rng.integers(lo, hi, 5003).astype(np.int8)
    got = tops.pack2bit(_t(codes)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.pack2bit(codes, interpret=True)))
    padded = np.concatenate([codes, np.zeros(1, np.int8)])
    np.testing.assert_array_equal(
        got, np.asarray(jref.pack2bit_ref(padded)))
    np.testing.assert_array_equal(tref.pack2bit_ref(_t(padded)).numpy(), got)


def test_unpack_every_byte():
    b = np.arange(256, dtype=np.uint8)
    got = tops.unpack2bit(_t(b), 1024).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.unpack2bit(b, 1024, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jref.unpack2bit_ref(b)))
    np.testing.assert_array_equal(tref.unpack2bit_ref(_t(b)).numpy(), got)
    assert got.min() == -1 and got.max() == 2        # field 3 → code 2
    # Every byte survives unpack → pack.
    np.testing.assert_array_equal(tops.pack2bit(_t(got)).numpy(), b)


def _ulp_gap(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(1 << 31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(1 << 31)) - ib, ib)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("shape", [(1000,), (64, 37), (3, 5, 7), (4096,)])
@pytest.mark.parametrize("n_workers", [1, 3, 10])
@pytest.mark.parametrize("codes_from", ["ternary", "int8"])
def test_master_update_matches(shape, n_workers, codes_from):
    rng = np.random.default_rng(n_workers * 100 + sum(shape))
    q, p1, p2 = _history(shape, sum(shape) + 1)
    lo, hi = (-1, 2) if codes_from == "ternary" else (-128, 128)
    tern = rng.integers(lo, hi, (n_workers,) + shape).astype(np.int8)
    w = rng.uniform(0, 0.2, n_workers).astype(np.float32)
    w[n_workers // 2] = 0.0                          # the pilot's weight
    got = tops.master_update(_t(q), _t(tern), _t(w), _t(p1), _t(p2)).numpy()
    want = np.asarray(jops.master_update(q, tern, w, p1, p2, interpret=True))
    assert got.shape == shape and got.dtype == np.float32
    gap = _ulp_gap(got, want)
    print(f"master_update vs JAX, {shape} N={n_workers} {codes_from}: "
          f"largest gap {gap} ulp")
    oracle = tref.master_update_ref(
        _t(q).reshape(-1), _t(tern).reshape(n_workers, -1), _t(w),
        _t(p1).reshape(-1), _t(p2).reshape(-1)).numpy().reshape(shape)
    if codes_from == "ternary":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)
        return
    # Codes outside {-1, 0, 1} make each product T_k·w_k inexact, and the
    # two sums then round in different orders; where the terms cancel, the
    # result is far smaller than they are. Each side is held within the
    # forward error bound of an (N + 2)-step float32 evaluation, twice
    # over (one for each side): 2·(N + 2)·2^-24 of the absolute terms.
    step = p1.astype(np.float64) - p2.astype(np.float64)
    terms = np.tensordot(np.abs(w.astype(np.float64)),
                         np.abs(tern.astype(np.float64)), 1) * np.abs(step)
    bound = 2 * (n_workers + 2) * 2.0 ** -24 * (terms + np.abs(q)
                                                + np.abs(step))
    exact = q - np.tensordot(w.astype(np.float64), tern.astype(np.float64),
                             1) * step
    for other in (want, oracle, exact):
        assert (np.abs(got - other) <= bound).all()


@pytest.mark.parametrize("n_workers", [1, 4, 10])
def test_master_update_is_the_fused_masters_bits(n_workers):
    """On the wire's codes {-1, 0, 1} the unfused master equals the fused
    packed master over the same codes, bit for bit."""
    rng = np.random.default_rng(n_workers)
    rows = 64
    q = rng.standard_normal((n_workers, rows, 128), dtype=np.float32)
    p1 = rng.standard_normal((rows, 128), dtype=np.float32)
    p2 = rng.standard_normal((rows, 128), dtype=np.float32)
    codes = rng.integers(-1, 2, (n_workers, rows, 128)).astype(np.int8)
    w = rng.uniform(0, 0.2, n_workers).astype(np.float32)
    k_star = n_workers - 1
    w[k_star] = 0.0
    packed = torch.stack([tops.pack2bit(_t(c)).view(rows // 4, 128)
                          for c in codes])
    fused = tops.flat_master_update(_t(q), torch.tensor(k_star), packed,
                                    _t(w), _t(p1), _t(p2), t=2, alpha0=0.01)
    got = tops.master_update(_t(q[k_star]), _t(codes), _t(w), _t(p1),
                             _t(p2))
    assert torch.equal(got.view(torch.int32), fused.view(torch.int32))
    assert torch.equal(got, tmu.master_update_plain(
        _t(q[k_star]), _t(codes), _t(w), _t(p1), _t(p2)))


def test_flat_oracles_match():
    """The new oracles of kernels/ref.py against the JAX package's."""
    q, p1, p2 = _history((4096,), 5)
    tq, tp1, tp2 = _t(q), _t(p1), _t(p2)
    for got, want in (
            (tref.ternary_encode_ref(tq, tp1, tp2, BETA),
             jref.ternary_encode_ref(q, p1, p2, BETA)),
            (tref.ternary_encode_round1_ref(tq, tp1, ALPHA),
             jref.ternary_encode_round1_ref(q, p1, ALPHA)),
            (tref.ternary_pack_round1_ref(tq, tp1, ALPHA),
             jref.ternary_pack_round1_ref(q, p1, ALPHA))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(6)
    packed = rng.integers(0, 256, (4, 1024)).astype(np.uint8)
    w = rng.random(4).astype(np.float32)
    for t in (1, 3):
        np.testing.assert_allclose(
            tref.packed_master_update_ref(tq, _t(packed), _t(w), tp1, tp2, t,
                                          0.01).numpy(),
            np.asarray(jref.packed_master_update_ref(q, packed, w, p1, p2, t,
                                                     0.01)),
            rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    f = torch.zeros((8, 128))
    with pytest.raises(ValueError):            # float64 operand
        tte.ternary_encode(f.double(), f, f, BETA)
    with pytest.raises(ValueError):            # history of another shape
        tte.ternary_encode(f, f[:4], f, BETA)
    codes = torch.zeros((8, 512), dtype=torch.int8)
    with pytest.raises(ValueError):            # codes must be int8
        tpk.pack2bit(codes.to(torch.int16))
    with pytest.raises(ValueError):            # a view that is not contiguous
        tpk.pack2bit(torch.zeros((8, 1024), dtype=torch.int8)[:, ::2])
    with pytest.raises(ValueError):            # bytes must be uint8
        tpk.unpack2bit(torch.zeros((8, 128), dtype=torch.int8))
    tern = torch.zeros((2, 8, 128), dtype=torch.int8)
    with pytest.raises(ValueError):            # one weight a worker
        tmu.master_update(f, tern, torch.zeros(3), f, f)
    with pytest.raises(ValueError):            # at least one worker
        tmu.master_update(f, tern[:0], torch.zeros(0), f, f)
