"""The port's privacy building blocks against ``repro.privacy``: the
counter streams, pair structure, net masks, fixed-point weights and RR of
``masking``/``dp`` bitwise; ``PrivacySpec``'s derived values and refusals
equal; the accountant's sums equal, its ``e·(exp(e) − 1)`` sum within
``rtol=1e-6`` (float32 ``exp`` differs by an ulp between XLA and ATen).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.privacy import dp as jdp
from repro.privacy import masking as jm
from repro.privacy.accountant import PrivacyAccountant as JAcc
from repro.privacy.spec import PrivacySpec as JSpec
from repro_torch.privacy import dp as tdp
from repro_torch.privacy import masking as tm
from repro_torch.privacy.accountant import PrivacyAccountant as TAcc
from repro_torch.privacy.spec import PrivacySpec as TSpec

WORDS = np.array([0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                  0xDEADBEEF, 0xFFFFFFFF], np.uint32)


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_mix32_and_streams():
    rng = np.random.default_rng(0)
    x = np.concatenate([WORDS, rng.integers(0, 2**32, 256, dtype=np.uint32)])
    _eq(tm.mix32(torch.from_numpy(x)), jm.mix32(x))
    _eq(tm.mix32(0xDEADBEEF), jm.mix32(0xDEADBEEF))
    key = np.uint32(0x1234ABCD)
    _eq(tm.mask_stream(int(key), torch.from_numpy(x)), jm.mask_stream(key, x))
    _eq(tm.halves16(torch.from_numpy(x)), jm.halves16(jnp.asarray(x)))
    for bits in (16, 32):
        for base in (0, 1024):
            th = tm.index_hash(64, bits, base)
            _eq(th, jm.index_hash(64, bits, base))
            _eq(tm.stream_values(int(key), th, bits),
                jm.stream_values(key, jm.index_hash(64, bits, base), bits))


@pytest.mark.parametrize("domain", [jm.MASK_DOMAIN, jm.RR_DOMAIN,
                                    jm.FAULT_DOMAIN])
def test_stream_key_grid(domain):
    ids = np.arange(40, dtype=np.int32)
    for seed in (0, 1, 7, 2**32 - 1):
        for t in (1, 2, 1000):
            for shard in (0, 3):
                _eq(tm.stream_key(seed, torch.from_numpy(ids),
                                  torch.tensor(t, dtype=torch.int32), shard,
                                  domain=domain),
                    jm.stream_key(seed, ids, t, shard, domain=domain))


@pytest.mark.parametrize("n", [1, 2, 5])
def test_pair_structure(n):
    c, i_idx, j_idx = tm.pair_incidence(n)
    for a, b in zip((c, i_idx, j_idx), jm.pair_incidence(n)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    idx = torch.arange(n)
    _eq(tm.pair_index(idx[:, None], idx[None, :], n).int(),
        jm.pair_index(jnp.arange(n)[:, None], jnp.arange(n)[None, :], n))
    t = torch.tensor(4, dtype=torch.int32)
    _eq(tm.pair_stream_keys(3, n, t), jm.pair_stream_keys(3, n, 4))
    _eq(tm.pair_signs(n), jm.pair_signs(n))
    part = (np.arange(n) % 2 == 0).astype(np.float32)
    _eq(tm.pair_signs(n, participation=torch.from_numpy(part)),
        jm.pair_signs(n, participation=part))


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_net_masks(bits, n):
    shape = (3, 512)
    t = torch.tensor(3, dtype=torch.int32)
    got = tm.net_masks(7, n, t, shape, word_bits=bits)
    _eq(got, jm.net_masks(7, n, 3, shape, word_bits=bits))
    total = tm.as_u64(got).sum(0) & ((1 << bits) - 1)
    assert not total.any()                       # cancels exactly
    part = np.array([1, 0, 1, 1, 0][:n], np.float32)
    got = tm.net_masks(7, n, t, (5, 7), word_bits=bits,
                       participation=torch.from_numpy(part))
    _eq(got, jm.net_masks(7, n, 3, (5, 7), word_bits=bits,
                          participation=part))
    assert not tm.as_u64(got)[part == 0].any()   # non-participants: zero


def test_quantize_weights():
    w = np.array([0.0, 0.1, 0.25, 0.5 / 2**14, 1.5 / 2**14, 2.5 / 2**24,
                  0.999, 1.0], np.float32)      # ties round to even
    for bits in (8, 14, 24, 26):
        _eq(tm.quantize_weights(torch.from_numpy(w), bits),
            jm.quantize_weights(w, bits))


def test_randomized_response():
    t = torch.tensor(5, dtype=torch.int32)
    for worker in (0, 3):
        _eq(tdp.rr_stream_key(1, t, worker), jdp.rr_stream_key(1, 5, worker))
    _eq(tdp.rr_stream_keys(1, t, 6), jdp.rr_stream_keys(1, 5, 6))
    bits = tdp.rr_bits(1, t, 3, (4, 512))
    _eq(bits, jdp.rr_bits(1, 5, 3, (4, 512)))
    fields = np.random.default_rng(2).integers(0, 3, (3, 4, 512)).astype(
        np.uint32)
    jbits = np.asarray(bits.numpy())
    for thr in (0, 1, 3277, 65535):
        _eq(tdp.rr_fields(torch.from_numpy(fields), bits, thr),
            jdp.rr_fields(fields, jbits, thr))


EPSILONS = [None, 1e-4, 0.05, 0.5, 1.0, 2.0, 5.0, 10.0, 12.0,
            float(np.log(3 * 2**17 - 2))]


@pytest.mark.parametrize("eps", EPSILONS)
@pytest.mark.parametrize("bits", [16, 32])
def test_spec_derived_values(eps, bits):
    for kw in ({}, {"fixpoint_bits": 8}, {"mask_seed": None},
               {"secure_agg": False}):
        ts = TSpec(modulus_bits=bits, dp_epsilon=eps, **kw)
        js = JSpec(modulus_bits=bits, dp_epsilon=eps, **kw)
        for name in ("fixpoint_bits", "dp_on", "masking_on", "active",
                     "rr_threshold", "flip_prob", "eps_round", "scale",
                     "scale_mult"):
            assert getattr(ts, name) == getattr(js, name), name
        assert ts.wrap_headroom_workers() == js.wrap_headroom_workers()
        assert ts.word_dtype == {16: torch.uint16, 32: torch.uint32}[bits]


@pytest.mark.parametrize("kw", [
    {"modulus_bits": 8}, {"modulus_bits": 16, "fixpoint_bits": 15},
    {"modulus_bits": 32, "fixpoint_bits": 27}, {"fixpoint_bits": 7},
    {"dp_epsilon": 0.0}, {"dp_epsilon": 1e-9}, {"dp_epsilon": 13.0},
    {"delta": 0.0}, {"delta": 1.0}, {"recovery_threshold": 1}])
def test_spec_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError) as jerr:
        JSpec(**kw)
    with pytest.raises(ValueError) as terr:
        TSpec(**kw)
    assert str(terr.value) == str(jerr.value)


def test_accountant_composition():
    ta, ja = TAcc.zero(), JAcc.zero()
    for eps in (TSpec(dp_epsilon=2.0).eps_round, 0.5, 3.0, 0.5):
        ta, ja = ta.add(eps), ja.add(eps)
    assert int(ta.spent_rounds) == int(ja.spent_rounds) == 4
    for name in ("eps_sum", "eps_sq_sum"):
        assert getattr(ta, name).dtype == torch.float32
        assert float(getattr(ta, name)) == float(getattr(ja, name))
    np.testing.assert_allclose(float(ta.eps_lin_sum), float(ja.eps_lin_sum),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ta.epsilon(1e-5)),
                               float(ja.epsilon(1e-5)), rtol=1e-6)
    np.testing.assert_allclose(float(ta.best_epsilon(1e-5)),
                               float(ja.best_epsilon(1e-5)), rtol=1e-6)
    assert float(ta.epsilon()) == float(ta.eps_sum)
