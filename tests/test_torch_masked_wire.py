"""The port's masked wire kernels against the JAX package's Pallas kernels.

The same numpy inputs go through ``repro.kernels.ops`` (the Pallas
kernels in interpret mode on the CPU) and through the port's wrappers,
which take the plain PyTorch version for CPU tensors. The masked wire is
integer end to end, so both kernels are held **bitwise**: the uplink's
words at both moduli, RR on and off, masks on and off, with and without
participation; the master's float output, whose combine ``q − coeff·mult``
XLA:CPU rounds once (a fused multiply-add) when ``t`` and ``scale_mult``
are runtime operands, as the port's kernel and twin do — held at a
power-of-two ``scale_mult`` and at DP's, which is not one.

``test_torch_kernels_gpu`` holds the CUDA kernels against these plain
versions on the card.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.privacy import masking as jm
from repro.privacy import dp as jdp
from repro_torch.kernels import masked_wire as tmw
from repro_torch.kernels import ops as tops
from repro_torch.privacy import dp as tdp
from repro_torch.privacy import masking as tm
from repro_torch.privacy.spec import PrivacySpec

FIX_BITS = {16: 14, 32: 24}
ROWS = 32                       # flat rows; the kernel view has 8


def _fixture(rng, n, rows=ROWS):
    p1 = rng.standard_normal((rows, 128), dtype=np.float32) * 0.05
    p2 = p1 + rng.standard_normal((rows, 128), dtype=np.float32) * 0.02
    q = p1[None] + rng.standard_normal((n, rows, 128),
                                       dtype=np.float32) * 0.03
    p1[-1], p2[-1], q[:, -1] = 0.0, 0.0, 0.0     # zero tail row
    w = np.linspace(0.01, 0.05, n).astype(np.float32)
    if n > 2:
        w[n // 2] = 0.0                          # the pilot
    return q, p1, p2, w


def _tt(t):
    return torch.tensor(t, dtype=torch.int32)


def _uplinks(q, p1, p2, w, t, betas, bits, thr, *, use_masks=True,
             part=None, sibling=None, block_workers=1):
    """(port, reference) wire words for the same inputs; ``sibling`` scopes
    the signs to a tree's sibling groups."""
    n, rows = q.shape[:2]
    wq = jm.quantize_weights(w, FIX_BITS[bits])
    tpart = None if part is None else torch.from_numpy(part)
    if sibling is None:
        jsigns = jm.pair_signs(n, participation=part)
        tsigns = tm.pair_signs(n, participation=tpart)
    else:
        jsigns = jm.tree_pair_signs(n, sibling, participation=part)
        tsigns = tm.tree_pair_signs(n, sibling, participation=tpart)
    want = jops.flat_ternary_pack_masked(
        jnp.asarray(q), jnp.asarray(p1), jnp.asarray(p2), t=t, beta=betas,
        alpha1=0.01, wq=wq, pair_keys=jm.pair_stream_keys(0, n, t),
        pair_signs=jsigns, rr_keys=jdp.rr_stream_keys(1, t, n),
        rr_threshold=thr, word_bits=bits, use_masks=use_masks,
        interpret=True, block_rows=rows // 4, block_workers=block_workers)
    tt = _tt(t)
    got = tops.flat_ternary_pack_masked(
        torch.from_numpy(q), torch.from_numpy(p1), torch.from_numpy(p2),
        t=tt, beta=torch.from_numpy(betas),
        alpha1=0.01, wq=tm.quantize_weights(torch.from_numpy(w),
                                            FIX_BITS[bits]),
        pair_keys=tm.pair_stream_keys(0, n, tt), pair_signs=tsigns,
        rr_keys=tdp.rr_stream_keys(1, tt, n), rr_threshold=thr,
        word_bits=bits, use_masks=use_masks)
    return got, np.asarray(want)


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("n", [1, 2, 8, 33])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("thr", [0, 3277])
def test_masked_uplink_plain_bitwise(bits, n, t, thr):
    rng = np.random.default_rng(1000 * n + 10 * t + bits + thr)
    q, p1, p2, w = _fixture(rng, n)
    betas = np.linspace(0.1, 0.3, n).astype(np.float32)
    before = dict(tmw.LAUNCHES)
    got, want = _uplinks(q, p1, p2, w, t, betas, bits, thr)
    assert tmw.LAUNCHES == before              # a CPU call launches nothing
    assert got.dtype == {16: torch.uint16, 32: torch.uint32}[bits]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("n", [17, 33])
def test_masked_uplink_plain_bitwise_whole_cohort(bits, n):
    # The reference's whole-cohort branch (block_workers = N: each
    # unordered pair expanded once and folded into both workers), the
    # branch the tile kernel ports above 16 workers, RR on; a few rows,
    # for its trace unrolls N (N - 1) / 2 pairs.
    rng = np.random.default_rng(70 + n + bits)
    q, p1, p2, w = _fixture(rng, n, rows=8)
    betas = np.linspace(0.1, 0.3, n).astype(np.float32)
    assert tmw.cohort_kernel(n, n) == "tiles"
    got, want = _uplinks(q, p1, p2, w, 2, betas, bits, 3277, block_workers=n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [16, 32])
def test_masked_uplink_unmasked_and_participation(bits):
    rng = np.random.default_rng(bits)
    q, p1, p2, w = _fixture(rng, 5)
    betas = np.full(5, 0.2, np.float32)
    part = np.array([1, 0, 1, 1, 0], np.float32)
    w = w * part
    for kw in ({"use_masks": False}, {"part": part},
               {"part": part, "use_masks": False}):
        got, want = _uplinks(q, p1, p2, w, 2, betas, bits, 3277, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    # Non-participants' words carry no mask: only W_k·field, and W_k = 0.
    got, _ = _uplinks(q, p1, p2, w, 2, betas, bits, 0, part=part)
    assert not tm.as_u64(got[part == 0]).any()


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("n,block_workers", [(10, 10), (17, 1)])
def test_masked_uplink_plain_bitwise_under_tree_signs(bits, n,
                                                      block_workers):
    # A tree's leaf signs, scoped to sibling groups of 4 with a worker
    # sitting out, RR on. At N = 10 the Pallas kernel holds the whole
    # cohort and expands each pair once (the pair kernel's form); at N = 17
    # each worker folds its row (the row-fold kernel's form), where the
    # port's tile kernel expands each pair once: the words are the same.
    rng = np.random.default_rng(50 + n + bits)
    q, p1, p2, w = _fixture(rng, n)
    betas = np.linspace(0.1, 0.3, n).astype(np.float32)
    part = np.ones(n, np.float32)
    part[[1, n - 3]] = 0.0
    got, want = _uplinks(q, p1, p2, w * part, 2, betas, bits, 3277,
                         part=part, sibling=4, block_workers=block_workers)
    assert tmw.uses_pair_kernel(n, n)
    assert tmw.cohort_kernel(n, n) == ("pairs" if block_workers == n
                                       else "tiles")
    np.testing.assert_array_equal(got.numpy(), want)
    got_plain = tmw.ternary_pack_masked_plain(
        torch.from_numpy(q).view(n, ROWS // 4, 512),
        torch.from_numpy(p1).view(ROWS // 4, 512),
        torch.from_numpy(p2).view(ROWS // 4, 512), _tt(2),
        torch.from_numpy(betas),
        0.01, tm.quantize_weights(torch.from_numpy(w * part), FIX_BITS[bits]),
        tm.pair_stream_keys(0, n, _tt(2)),
        tm.tree_pair_signs(n, 4, participation=torch.from_numpy(part)),
        tdp.rr_stream_keys(1, _tt(2), n), rr_threshold=3277, word_bits=bits)
    np.testing.assert_array_equal(got_plain.numpy().reshape(want.shape),
                                  want)


@pytest.mark.parametrize("n", [1, 2, 10, 16, 17, 24, 25, 33, 64, 170, 171])
def test_pair_kernel_dispatch(n):
    # A square key matrix has each unordered pair expanded once: the pair
    # kernel up to 16 workers, the tile kernel (groups of 8: 24 fills
    # three, 25 starts a fourth) up to the cap, 170, the most the
    # wrapper's staged keys allow; the row-fold kernel any other shape.
    # The constants are the CUDA source's.
    src = (Path(tmw.__file__).parent / "csrc" / "masked_wire.cu").read_text()
    assert "constexpr int kPairMaxWorkers = 16;" in src
    assert "constexpr int kTileMaxWorkers = 170;" in src
    assert "constexpr int kTileWorkers = 8;" in src
    assert tmw.PAIR_MAX_WORKERS == 16
    assert tmw.COHORT_MAX_WORKERS == 170
    cap = tmw.COHORT_MAX_WORKERS
    assert 8 * cap ** 2 <= tmw.MAX_STAGED_BYTES < 8 * (cap + 1) ** 2
    assert tmw.uses_pair_kernel(n, n) == (n <= cap)
    assert tmw.cohort_kernel(n, n) == ("pairs" if n <= 16 else
                                       "tiles" if n <= cap else "rows")
    assert not tmw.uses_pair_kernel(n, n + 1)
    assert not tmw.uses_pair_kernel(n, 33 if n != 33 else 10)
    assert not tmw.uses_pair_kernel(n + 1, n)
    if n > cap:                 # the wrapper refuses such a key matrix
        z = torch.zeros((n, 1, 512))
        p = torch.zeros((1, 512))
        with pytest.raises(ValueError, match="shared memory"):
            tmw.ternary_pack_masked(
                z, p, p, _tt(2), torch.zeros(n), 0.01,
                torch.zeros(n, dtype=torch.uint32),
                torch.zeros((n, n), dtype=torch.uint32),
                torch.zeros((n, n), dtype=torch.int32),
                torch.zeros(n, dtype=torch.uint32))


@pytest.mark.parametrize("n", [1, 2, 3, 10, 16, 17])
@pytest.mark.parametrize("participation", [False, True])
@pytest.mark.parametrize("sibling", [None, 2, 4])
def test_pair_kernel_contract(n, participation, sibling):
    # The pair kernel reads only the upper triangle: the keys the port
    # builds are symmetric, the signs antisymmetric with a zero diagonal,
    # flat or scoped to a tree's sibling groups, with participation folded
    # in; and they equal the JAX package's.
    rng = np.random.default_rng(n)
    part = ((rng.random(n) < 0.7).astype(np.float32) if participation
            else None)
    tpart = None if part is None else torch.from_numpy(part)
    keys = tm.pair_stream_keys(0, n, _tt(2))
    if sibling is None:
        signs = tm.pair_signs(n, participation=tpart)
        want = jm.pair_signs(n, participation=part)
    else:
        signs = tm.tree_pair_signs(n, sibling, participation=tpart)
        want = jm.tree_pair_signs(n, sibling, participation=part)
    assert keys.dtype == torch.uint32 and signs.dtype == torch.int32
    assert torch.equal(tm.as_u64(keys), tm.as_u64(keys).t())
    assert torch.equal(signs, -signs.t())
    assert not signs.diagonal().any()
    np.testing.assert_array_equal(signs.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tm.as_u64(keys).numpy(),
                                  np.asarray(jm.pair_stream_keys(0, n, 2)))


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("dp", [False, True])
def test_masked_master_plain_bitwise(bits, n, t, dp):
    rng = np.random.default_rng(100 * n + 10 * t + dp)
    q, p1, p2, w = _fixture(rng, n)
    got_words, words = _uplinks(q, p1, p2, w, t, np.full(n, 0.2, np.float32),
                                bits, 3277 if dp else 0)
    spec = PrivacySpec(modulus_bits=bits, dp_epsilon=2.0 if dp else None)
    assert (spec.scale_mult * spec.scale == 1.0) != dp   # DP: not 2**-k
    wq = jm.quantize_weights(w, FIX_BITS[bits])
    k_star = int(rng.integers(n))
    want = np.asarray(jops.flat_masked_master_update(
        jnp.asarray(q[k_star]), jnp.asarray(words), jnp.sum(wq),
        jnp.asarray(p1), jnp.asarray(p2), t=t, alpha0=0.01,
        scale_mult=spec.scale_mult, interpret=True))
    got = tops.flat_masked_master_update(
        torch.from_numpy(q), torch.tensor(k_star), got_words,
        int(np.sum(np.asarray(wq), dtype=np.uint64)), torch.from_numpy(p1),
        torch.from_numpy(p2), t=_tt(t), alpha0=0.01,
        scale_mult=spec.scale_mult)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    if not dp:                                 # RR flips the tail's fields
        assert not got[-1].any()               # the zero tail stays zero


@pytest.mark.parametrize("bits", [16, 32])
def test_masks_cancel_in_the_master(bits):
    # Masked and unmasked words differ almost everywhere, yet the master
    # gives the same bits: the modular sum cancels the masks exactly.
    rng = np.random.default_rng(7)
    q, p1, p2, w = _fixture(rng, 6)
    betas = np.full(6, 0.2, np.float32)
    outs, words = [], []
    for use_masks in (True, False):
        y, _ = _uplinks(q, p1, p2, w, 3, betas, bits, 0, use_masks=use_masks)
        words.append(y)
        outs.append(tops.flat_masked_master_update(
            torch.from_numpy(q), torch.tensor(3), y,
            tm.as_u64(tm.quantize_weights(torch.from_numpy(w),
                                          FIX_BITS[bits])).sum(),
            torch.from_numpy(p1), torch.from_numpy(p2), t=_tt(3),
            alpha0=0.01, scale_mult=2.0 ** -FIX_BITS[bits]))
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    same = (tm.as_u64(words[0]) == tm.as_u64(words[1])).float().mean()
    assert float(same) < 0.01


def test_wrappers_refuse_what_the_kernel_does_not_take():
    n, r = 2, 8
    q = torch.zeros((n, r, 512))
    p = torch.zeros((r, 512))
    t, beta = _tt(1), torch.full((n,), 0.2)
    wq = torch.zeros(n, dtype=torch.uint32)
    keys = torch.zeros((n, n), dtype=torch.uint32)
    signs = torch.zeros((n, n), dtype=torch.int32)
    rrk = torch.zeros(n, dtype=torch.uint32)
    ok = (q, p, p, t, beta, 0.01, wq, keys, signs, rrk)

    def bad(i, value, **kw):
        args = list(ok)
        args[i] = value
        with pytest.raises(ValueError):
            tmw.ternary_pack_masked(*args, **kw)
    bad(6, wq.view(torch.int32))                 # weights not uint32
    bad(7, keys[:, :1].contiguous(), )           # keys not (N, L) of signs
    bad(8, signs.to(torch.int64))                # signs not int32
    bad(7, keys.t(), )                           # not contiguous
    bad(0, q, word_bits=8)                       # no such modulus
    bad(0, q, rr_threshold=1 << 16)              # threshold past 16 bits
    big = torch.zeros((n, 16000), dtype=torch.uint32)
    with pytest.raises(ValueError, match="shared memory"):
        tmw.ternary_pack_masked(q, p, p, t, beta, 0.01, wq, big,
                                big.view(torch.int32), rrk)
    words = torch.zeros((n, r, 512), dtype=torch.uint16)
    k, sw = torch.tensor(0), torch.zeros((), dtype=torch.uint32)
    with pytest.raises(ValueError):              # words of another dtype
        tmw.masked_master_update(q, k, words.view(torch.int16), sw, p, p, t,
                                 0.01, 1.0)
    with pytest.raises(ValueError):              # sum_wq not uint32
        tmw.masked_master_update(q, k, words, sw.to(torch.int64), p, p, t,
                                 0.01, 1.0)
    with pytest.raises(ValueError):              # words of other rows R
        tmw.masked_master_update(q, k, words[:, :1].contiguous(), sw, p, p,
                                 t, 0.01, 1.0)
    with pytest.raises(ValueError):              # no word row at all
        tmw.masked_master_update(q, k, words[:0].contiguous(), sw, p, p, t,
                                 0.01, 1.0)
