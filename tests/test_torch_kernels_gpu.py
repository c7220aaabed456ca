"""The CUDA wire kernels against their plain PyTorch versions, on the card:
the plain round's uplink and master, the masked round's, the tree's two
partial sums and the dropout repair (out of place, in place and
write-only), the one-worker uplinks, the unfused encode, pack, unpack and
master, and the round core's tree and fault branches chained on the card
and on the CPU.

Needs a CUDA card and ``nvcc``; every test here is marked ``gpu`` and skips
where ``torch.cuda.is_available()`` is false. It imports nothing of JAX, so
it runs on a machine with the port alone::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.tree import TreeSpec
from repro_torch.fed import rounds as rd
from repro_torch.fed.faults import FaultPlan
from repro_torch.kernels import fused_wire as tfw
from repro_torch.kernels import master_update as tmu
from repro_torch.kernels import masked_wire as tmw
from repro_torch.kernels import ops
from repro_torch.kernels import pack2bit as tpk
from repro_torch.kernels import partial_sum as tps
from repro_torch.kernels import ternary_encode as tte
from repro_torch.privacy import dp as pdp
from repro_torch.privacy import masking as pvm
from repro_torch.privacy.spec import PrivacySpec

ALPHA1 = 0.01
ALPHA0 = 0.01


def _history(rng, n, r):
    """q (N, R, 512), p1/p2 (R, 512): worker views near a shared history,
    with step == 0, exact ties, an underflowing product and a zero tail."""
    q = rng.standard_normal((n, r, 512), dtype=np.float32) * 0.05
    p1 = rng.standard_normal((r, 512), dtype=np.float32) * 0.05
    p2 = p1 + rng.standard_normal((r, 512), dtype=np.float32) * 0.02
    p2[0, :64] = p1[0, :64]                       # step == 0
    p1[0, 64:128], p2[0, 64:128] = 0.0, -0.5      # step == 0.5 from p1 = 0
    p1[0, 128:192], p2[0, 128:192] = 1e-23, 0.0   # tiny step ...
    q[:, 0, 128:192] = 2e-23                      # ... and tiny delta
    p1[-1], p2[-1], q[:, -1] = 0.0, 0.0, 0.0      # zero tail row
    return q, p1, p2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,r", [(1, 8), (3, 8), (10, 64)])
@pytest.mark.parametrize("t", [1, 2])
def test_kernels_match_plain_on_card(cuda, n, r, t):
    rng = np.random.default_rng(n + r + t)
    q, p1, p2 = _history(rng, n, r)
    beta = rng.choice([0.1, 0.2, 0.3], n).astype(np.float32)
    half = (beta * np.float32(0.5)).astype(np.float32)[:, None]
    q[:, 0, 64:96], q[:, 0, 96:128] = half, -half  # exact ties
    dq, dp1, dp2 = (torch.from_numpy(a).to(cuda) for a in (q, p1, p2))
    dt = torch.tensor(t, dtype=torch.int32, device=cuda)
    db = torch.from_numpy(beta).to(cuda)
    before = tfw.LAUNCHES["uplink_stacked"]
    packed = tfw.ternary_pack_stacked(dq, dp1, dp2, dt, db, ALPHA1)
    assert tfw.LAUNCHES["uplink_stacked"] == before + 1
    plain = tfw.ternary_pack_stacked_plain(dq, dp1, dp2, dt, db, ALPHA1)
    torch.testing.assert_close(packed, plain, rtol=0, atol=0)

    w = torch.from_numpy(rng.random(n, dtype=np.float32) / n).to(cuda)
    k = torch.tensor(n - 1, device=cuda)          # the pilot, read in place
    w[n - 1] = 0.0
    out = tfw.packed_master_update(dq, k, packed, w, dp1, dp2, dt, ALPHA0)
    plain = tfw.packed_master_update_plain(dq, k, packed, w, dp1, dp2, dt,
                                           ALPHA0)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), plain.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4, 10])
@pytest.mark.parametrize("t", [1, 2])
def test_master_with_the_pilot_apart_matches_plain_on_card(cuda, n, t):
    # A mesh rank's form of #2: the pilot's buffer alone (Nq = 1, index
    # 0) beside N workers' packed codes; an index outside [0, 1) is NaN.
    rng = np.random.default_rng(50 + n + t)
    q, p1, p2 = _history(rng, n + 1, 64)
    dq, dp1, dp2 = (torch.from_numpy(a).to(cuda) for a in (q, p1, p2))
    dt = torch.tensor(t, dtype=torch.int32, device=cuda)
    packed = torch.from_numpy(rng.integers(0, 256, (n, 64, 128),
                                           dtype=np.uint8)).to(cuda)
    w = torch.from_numpy(rng.random(n, dtype=np.float32) / n).to(cuda)
    pilot = dq[n:].contiguous()
    zero = torch.tensor(0, device=cuda)
    before = tfw.LAUNCHES["master"]
    out = tfw.packed_master_update(pilot, zero, packed, w, dp1, dp2, dt,
                                   ALPHA0)
    assert tfw.LAUNCHES["master"] == before + 1
    plain = tfw.packed_master_update_plain(pilot, zero, packed, w, dp1, dp2,
                                           dt, ALPHA0)
    stacked = tfw.packed_master_update(
        torch.cat([dq[:n], pilot]), torch.tensor(n, device=cuda),
        torch.cat([packed, packed[:1] * 0]),
        torch.cat([w, w.new_zeros(1)]), dp1, dp2, dt, ALPHA0)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), plain.view(torch.int32))
    assert torch.equal(out.view(torch.int32), stacked.view(torch.int32))
    bad = tfw.packed_master_update(pilot, torch.tensor(1, device=cuda),
                                   packed, w, dp1, dp2, dt, ALPHA0)
    assert bool(bad.isnan().all())


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("cohort", [4, 10])
@pytest.mark.parametrize("thr", [0, 3277])
def test_masked_uplink_of_one_rank_matches_plain_on_card(cuda, bits, cohort,
                                                         thr):
    # A mesh rank's form of #6: N = 1 with its (1, L) key and sign row
    # salted by a model-shard index (the row-fold kernel), on a slab.
    rng = np.random.default_rng(70 + cohort + bits + thr)
    q, p1, p2 = _history(rng, 1, 64)
    dq, dp1, dp2 = (torch.from_numpy(a).to(cuda) for a in (q, p1, p2))
    assert not tmw.uses_pair_kernel(1, cohort)
    for t in (1, 2):
        dt = torch.tensor(t, dtype=torch.int32, device=cuda)
        idx = cohort - 2
        keys = pvm.pair_stream_keys_row(0, idx, cohort, dt, 1)[None]
        part = torch.ones(cohort, device=cuda)
        part[0] = 0.0
        signs = pvm.pair_signs_row(idx, cohort, participation=part)[None]
        rrk = pdp.rr_stream_key(1, dt, idx, 1).reshape(1)
        wq = pvm.to_words(torch.tensor([12345], device=cuda), 32)
        beta = torch.full((1,), 0.2, device=cuda)
        kw = dict(rr_threshold=thr, word_bits=bits)
        before = tmw.LAUNCHES["uplink_masked"]
        words = tmw.ternary_pack_masked(dq, dp1, dp2, dt, beta, ALPHA1, wq,
                                        keys, signs, rrk, **kw)
        assert tmw.LAUNCHES["uplink_masked"] == before + 1
        plain = tmw.ternary_pack_masked_plain(dq, dp1, dp2, dt, beta, ALPHA1,
                                              wq, keys, signs, rrk, **kw)
        torch.cuda.synchronize()
        assert torch.equal(pvm.as_u64(words), pvm.as_u64(plain))


@pytest.mark.gpu
def test_master_refuses_a_pilot_outside_the_workers(cuda):
    # An index outside [0, N) gives NaN, not a read past the buffers.
    q = torch.zeros((3, 8, 512), device=cuda)
    p = torch.zeros((8, 512), device=cuda)
    packed = torch.zeros((3, 8, 128), dtype=torch.uint8, device=cuda)
    w = torch.zeros(3, device=cuda)
    t = torch.tensor(2, dtype=torch.int32, device=cuda)
    for k in (-1, 3):
        out = tfw.packed_master_update(q, torch.tensor(k, device=cuda),
                                       packed, w, p, p, t, ALPHA0)
        assert bool(out.isnan().all())


@pytest.mark.gpu
def test_round_step_on_card_matches_cpu(cuda):
    # The whole round core, chained: the card's kernels and the CPU's
    # plain versions give the same bits.
    rng = np.random.default_rng(5)
    n, rows = 4, 96
    p0 = rng.standard_normal((rows, 128), dtype=np.float32) * 0.1
    sizes = np.array([300.0, 100.0, 500.0, 200.0], np.float32)
    wire = rd.WirePath(rd.WireConfig())
    states = {d: rd.RoundState(torch.from_numpy(p0).to(d),
                               torch.zeros((rows, 128), device=d),
                               torch.full((n,), float("inf"), device=d),
                               torch.ones((), dtype=torch.int32, device=d))
              for d in ("cpu", cuda)}
    before = dict(tfw.LAUNCHES)
    for _ in range(4):
        bufs = (states["cpu"].buf_p1.numpy()[None]
                + rng.standard_normal((n, rows, 128), dtype=np.float32) * .01)
        costs = rng.random(n, dtype=np.float32) + 0.5
        for d in states:
            states[d], _, info = wire.round_step(
                states[d], torch.from_numpy(bufs).to(d),
                torch.from_numpy(costs).to(d), torch.from_numpy(sizes).to(d))
    assert tfw.LAUNCHES["uplink_stacked"] == before["uplink_stacked"] + 4
    assert tfw.LAUNCHES["master"] == before["master"] + 4
    for a, b in zip(states["cpu"][:4], states[cuda][:4]):   # bitwise
        assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))


def _masked_operands(rng, n, r, t, bits, participation, dev, sibling=None):
    """Every operand of the masked uplink, on ``dev``; ``sibling`` scopes
    the signs to a tree's sibling groups."""
    q, p1, p2 = _history(rng, n, r)
    dq, dp1, dp2 = (torch.from_numpy(a).to(dev) for a in (q, p1, p2))
    dt = torch.tensor(t, dtype=torch.int32, device=dev)
    beta = torch.from_numpy(rng.choice([0.1, 0.2, 0.3], n).astype(
        np.float32)).to(dev)
    w = torch.from_numpy(rng.random(n, dtype=np.float32) / n).to(dev)
    part = None
    if participation:
        part = torch.from_numpy((rng.random(n) < 0.7).astype(
            np.float32)).to(dev)
        w = w * part
    wq = pvm.quantize_weights(w, 14 if bits == 16 else 24)
    keys = pvm.pair_stream_keys(0, n, dt)
    if sibling is None:
        signs = pvm.pair_signs(n, participation=part, device=dev)
    else:
        signs = pvm.tree_pair_signs(n, sibling, participation=part,
                                    device=dev)
    rrk = pdp.rr_stream_keys(1, dt, n)
    return dq, dp1, dp2, dt, beta, wq, keys, signs, rrk


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("n,r,participation,sibling", [
    (1, 8, False, None), (2, 8, False, None), (3, 8, True, None),
    (10, 64, False, None), (33, 8, True, None), (16, 8, False, None),
    (17, 8, True, None), (10, 8, True, 4), (16, 8, False, 2),
    (17, 8, True, 4)])
@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("thr", [0, 3277])
def test_masked_kernels_match_plain_on_card(cuda, bits, n, r, participation,
                                            sibling, t, thr):
    # Up to 16 workers the wrapper takes the pair kernel, beyond them the
    # tile kernel (counted apart); the row-fold kernel's private entry runs
    # at every N.
    rng = np.random.default_rng(1000 * n + 10 * t + bits + thr)
    ops = _masked_operands(rng, n, r, t, bits, participation, cuda, sibling)
    dq, dp1, dp2, dt, _, wq, _, _, _ = ops
    kind = ("uplink_masked_tiles" if tmw.cohort_kernel(n, n) == "tiles"
            else "uplink_masked")
    for use_masks in (True, False):
        kw = dict(rr_threshold=thr, word_bits=bits, use_masks=use_masks)
        before = dict(tmw.LAUNCHES)
        words = tmw.ternary_pack_masked(*ops[:5], ALPHA1, *ops[5:], **kw)
        assert tmw.LAUNCHES[kind] == before[kind] + 1
        rows = tmw._ternary_pack_masked_rows(*ops[:5], ALPHA1, *ops[5:],
                                             **kw)
        assert tmw.LAUNCHES["uplink_masked"] == (
            before["uplink_masked"] + 1 + (kind == "uplink_masked"))
        plain = tmw.ternary_pack_masked_plain(*ops[:5], ALPHA1, *ops[5:],
                                              **kw)
        assert words.dtype == rows.dtype == plain.dtype
        assert torch.equal(pvm.as_u64(words), pvm.as_u64(plain))
        assert torch.equal(pvm.as_u64(rows), pvm.as_u64(words))

    sum_wq = pvm.to_words(pvm.as_u64(wq).sum(), 32)
    spec = PrivacySpec(modulus_bits=bits, dp_epsilon=2.0 if thr else None)
    k = torch.tensor(n - 1, device=cuda)
    out = tmw.masked_master_update(dq, k, words, sum_wq, dp1, dp2, dt,
                                   ALPHA0, spec.scale_mult)
    plain = tmw.masked_master_update_plain(dq, k, words, sum_wq, dp1, dp2,
                                           dt, ALPHA0, spec.scale_mult)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), plain.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("n", [17, 24, 32, 33, 48, 64,
                               tmw.COHORT_MAX_WORKERS])
@pytest.mark.parametrize("thr", [0, 3277])
def test_tile_kernel_matches_plain_and_row_fold_on_card(cuda, bits, n, thr):
    # The tile kernel (N > 16 up to the cap) bitwise against the plain twin
    # and the row fold: masks off and on, t = 1, 2, all pairs active, a
    # participation fold, and a tree's signs scoped to sibling groups of 2
    # and 4 (sparse tiles), at R = 8 and at a ragged R = 3 (not a whole
    # block of 256 positions where a block holds 8 position groups).
    assert tmw.cohort_kernel(n, n) == "tiles"
    for r, participation, sibling in ((8, False, None), (3, True, None),
                                      (8, True, 2), (3, False, 4)):
        for t in (1, 2):
            rng = np.random.default_rng(n + 10 * r + t + bits + thr)
            ops = _masked_operands(rng, n, r, t, bits, participation, cuda,
                                   sibling)
            for use_masks in (True, False):
                kw = dict(rr_threshold=thr, word_bits=bits,
                          use_masks=use_masks)
                before = tmw.LAUNCHES["uplink_masked_tiles"]
                words = tmw.ternary_pack_masked(*ops[:5], ALPHA1, *ops[5:],
                                                **kw)
                assert tmw.LAUNCHES["uplink_masked_tiles"] == before + 1
                rows = tmw._ternary_pack_masked_rows(*ops[:5], ALPHA1,
                                                     *ops[5:], **kw)
                plain = tmw.ternary_pack_masked_plain(*ops[:5], ALPHA1,
                                                      *ops[5:], **kw)
                torch.cuda.synchronize()
                where = (r, participation, sibling, t, use_masks)
                assert words.dtype == plain.dtype, where
                assert torch.equal(pvm.as_u64(words), pvm.as_u64(plain)), where
                assert torch.equal(pvm.as_u64(rows), pvm.as_u64(plain)), where


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("n", [1, 3, 8, 10, 16])
def test_tile_kernel_equals_the_pair_kernel_on_card(cuda, bits, n):
    # Below 17 workers the wrapper takes the pair kernel; the tile kernel,
    # forced, gives its bits (one group, padded where N < 8).
    rng = np.random.default_rng(300 + n + bits)
    for t, participation in ((1, False), (2, True)):
        ops = _masked_operands(rng, n, 8, t, bits, participation, cuda)
        for thr in (0, 3277):
            kw = dict(rr_threshold=thr, word_bits=bits)
            pairs = tmw.ternary_pack_masked(*ops[:5], ALPHA1, *ops[5:], **kw)
            tiles = tmw._ternary_pack_masked_tiles(*ops[:5], ALPHA1,
                                                   *ops[5:], **kw)
            torch.cuda.synchronize()
            assert torch.equal(pvm.as_u64(tiles), pvm.as_u64(pairs))


def _c_pack(ops, bits, kernel, n, cohort, r, block_rows, block_workers):
    """The masked uplink's C entry called as is, with no check of the
    wrapper's: its CUDA error code."""
    q, p1, p2, t, beta, wq, keys, signs, rrk = ops
    out = torch.empty((n, r, 512), dtype=torch.uint16 if bits == 16
                      else torch.uint32, device=q.device)
    return tmw._lib().mw_ternary_pack_masked(
        q.data_ptr(), p1.data_ptr(), p2.data_ptr(), beta.data_ptr(),
        wq.data_ptr(), keys.data_ptr(), signs.data_ptr(), rrk.data_ptr(),
        t.data_ptr(), ALPHA1, 0, bits, 1, kernel, out.data_ptr(), n, cohort,
        r * 128, block_rows, block_workers, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
def test_tile_kernel_refuses_other_plans_on_card(cuda, bits):
    # The tile kernel honours one plan, the pair kernel's (2 rows, all N):
    # the wrapper refuses another, ops snaps to it, and the C entry (kernel
    # 2; 1 is the pair kernel, 0 the row fold) refuses it, a cohort past
    # the cap, and the pair kernel past 16 workers.
    n, r = 20, 8
    rng = np.random.default_rng(bits)
    ops = _masked_operands(rng, n, r, 2, bits, False, cuda)
    kind = "uplink_masked16" if bits == 16 else "uplink_masked"
    for br, bw in ((8, None), (None, 4), (1, 20), (2, 1)):
        with pytest.raises(ValueError, match="nearest plan"):
            tmw.ternary_pack_masked(*ops[:5], ALPHA1, *ops[5:],
                                    word_bits=bits, block_rows=br,
                                    block_workers=bw)
    from repro_torch.kernels import tune
    assert tune.fit_cuda_plan(kind, r, n, 8, 4, pairs=True) == (2, n)
    assert _c_pack(ops, bits, 2, n, n, r, 2, n) == 0
    for br, bw in ((8, n), (2, 4), (1, n)):
        assert _c_pack(ops, bits, 2, n, n, r, br, bw) != 0, (br, bw)
    assert _c_pack(ops, bits, 1, n, n, r, 2, n) != 0
    assert _c_pack(ops, bits, 3, n, n, r, 2, n) != 0
    big = tmw.COHORT_MAX_WORKERS + 1
    assert _c_pack(_masked_operands(rng, big, 1, 2, bits, False, cuda), bits,
                   2, big, big, 1, 2, big) != 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
def test_masked_master_refuses_a_pilot_outside_the_workers(cuda, bits):
    q = torch.zeros((3, 8, 512), device=cuda)
    p = torch.zeros((8, 512), device=cuda)
    words = torch.zeros((3, 8, 512), device=cuda, dtype=torch.int32).to(
        torch.int16 if bits == 16 else torch.int32).view(
        torch.uint16 if bits == 16 else torch.uint32)
    sum_wq = pvm.to_words(torch.zeros((), dtype=torch.int64, device=cuda), 32)
    t = torch.tensor(2, dtype=torch.int32, device=cuda)
    for k in (-1, 3):
        out = tmw.masked_master_update(q, torch.tensor(k, device=cuda),
                                       words, sum_wq, p, p, t, ALPHA0, 1.0)
        assert bool(out.isnan().all())


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
def test_masked_round_step_on_card_matches_cpu(cuda, bits):
    # The masked round core chained with DP on and a participation mask:
    # the card's kernels and the CPU's plain versions give the same bits.
    rng = np.random.default_rng(6)
    n, rows = 4, 96
    p0 = rng.standard_normal((rows, 128), dtype=np.float32) * 0.1
    sizes = np.array([300.0, 100.0, 500.0, 200.0], np.float32)
    spec = PrivacySpec(modulus_bits=bits, dp_epsilon=2.0, enforce=False)
    wire = rd.WirePath(rd.WireConfig(), privacy=spec, renorm_shares=True)
    states = {d: rd.init_round_state({"w": torch.from_numpy(p0).to(d)}, n,
                                     privacy=spec, device=d)
              for d in ("cpu", cuda)}
    masks = [None, np.array([1, 0, 1, 1], np.float32), None,
             np.array([1, 1, 1, 0], np.float32)]
    before = dict(tmw.LAUNCHES)
    for mask in masks:
        bufs = (states["cpu"].buf_p1.numpy()[None]
                + rng.standard_normal((n, rows, 128), dtype=np.float32) * .01)
        costs = rng.random(n, dtype=np.float32) + 0.5
        for d in states:
            states[d], _, info = wire.round_step(
                states[d], torch.from_numpy(bufs).to(d),
                torch.from_numpy(costs).to(d), torch.from_numpy(sizes).to(d),
                mask=None if mask is None else torch.from_numpy(mask).to(d))
    assert tmw.LAUNCHES["uplink_masked"] == before["uplink_masked"] + 4
    assert tmw.LAUNCHES["master_masked"] == before["master_masked"] + 4
    for a, b in zip(states["cpu"][:4], states[cuda][:4]):   # bitwise
        assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))
    acc_cpu, acc_card = states["cpu"].accountant, states[cuda].accountant
    assert int(acc_card.spent_rounds) == 4
    assert float(acc_card.eps_sum) == float(acc_cpu.eps_sum)


def _u(x: torch.Tensor) -> np.ndarray:
    return pvm.as_u64(x).cpu().numpy()


def _rand_words(rng, shape, bits, dev):
    a = rng.integers(0, 1 << bits, shape, dtype=np.uint64)
    return pvm.to_words(torch.from_numpy(a.astype(np.int64)), bits).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("c,fanout", [(5, 2), (7, 4), (10, 4), (10, 8),
                                      (8, 8), (7, 3)])
@pytest.mark.parametrize("r", [8, 64])
def test_partial_sum_matches_plain_on_card(cuda, bits, c, fanout, r):
    rng = np.random.default_rng(c * fanout + bits + r)
    packed = torch.from_numpy(rng.integers(0, 256, (c, r, 128),
                                           dtype=np.uint8)).to(cuda)
    wq = pvm.to_words(torch.from_numpy(rng.integers(
        0, 1 << (14 if bits == 16 else 24), c)), 32).to(cuda)
    before = tps.LAUNCHES["partial_sum"]
    out = tps.partial_sum(packed, wq, fanout=fanout, word_bits=bits)
    assert tps.LAUNCHES["partial_sum"] == before + 1
    plain = tps.partial_sum_plain(packed, wq, fanout=fanout, word_bits=bits)
    torch.cuda.synchronize()
    assert out.dtype == plain.dtype and out.shape == plain.shape
    assert np.array_equal(_u(out), _u(plain))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("c,fanout,sib", [(4, 4, 1), (4, 2, 2), (9, 3, 3),
                                          (10, 2, 2), (10, 2, 5), (7, 4, 2),
                                          (10, 4, 3)])
def test_masked_partial_sum_matches_plain_on_card(cuda, bits, c, fanout,
                                                  sib):
    rng = np.random.default_rng(c + 10 * fanout + bits + sib)
    r = 64
    g = -(-c // fanout)
    words = _rand_words(rng, (c, r, 512), bits, cuda)
    t = torch.tensor(3, dtype=torch.int32, device=cuda)
    keys = pvm.pair_stream_keys(pvm.tree_level_seed(7, 1), g, t)
    act = torch.from_numpy((rng.random(g) < 0.7).astype(np.float32)).to(cuda)
    for part in (None, act):
        signs = pvm.tree_pair_signs(g, sib, participation=part, device=cuda)
        for use_masks in (True, False):
            before = tps.LAUNCHES["masked_partial_sum"]
            out = tps.masked_partial_sum(words, keys, signs, fanout=fanout,
                                         sibling=sib, use_masks=use_masks)
            assert tps.LAUNCHES["masked_partial_sum"] == before + 1
            plain = tps.masked_partial_sum_plain(
                words, keys, signs, fanout=fanout, sibling=sib,
                use_masks=use_masks)
            torch.cuda.synchronize()
            assert out.dtype == words.dtype
            assert np.array_equal(_u(out), _u(plain))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("p", [1, 3, 9, 45])
def test_mask_repair_matches_plain_on_card(cuda, bits, p):
    rng = np.random.default_rng(bits + p)
    y = _rand_words(rng, (64, 512), bits, cuda)
    keys = pvm.to_words(torch.from_numpy(rng.integers(0, 1 << 32, p)),
                        32).to(cuda)
    for coeff in (rng.integers(-1, 2, p), np.zeros(p, np.int64)):
        cf = torch.from_numpy(coeff.astype(np.int32)).to(cuda)
        before = tmw.LAUNCHES["mask_repair"]
        out = tmw.mask_repair(y, keys, cf)
        assert tmw.LAUNCHES["mask_repair"] == before + 1
        plain = tmw.mask_repair_plain(y, keys, cf)
        torch.cuda.synchronize()
        assert out.data_ptr() != y.data_ptr()
        assert np.array_equal(_u(out), _u(plain))
        if not coeff.any():
            assert np.array_equal(_u(out), _u(y))


def _repair_coeffs(rng, p):
    """Random, all-zero and all-live coefficient vectors of P pairs."""
    return (rng.integers(-1, 2, p), np.zeros(p, np.int64),
            rng.choice([-3, -1, 1, 2], p))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("r,p", [(1, 1), (1, 13), (3, 9), (17, 45),
                                 (1000, 13), (41016, 13), (64, 2000)])
def test_mask_repair_in_place_and_write_only_match_plain_on_card(cuda, bits,
                                                                 r, p):
    # R = 1 and R not a multiple of a block's span of chunks (1,024 chunks:
    # 16 rows at 16 bits, 8 at 32), a main-path row that takes several
    # passes of the persistent grid, and P past 48 KB of shared memory.
    rng = np.random.default_rng(bits * r + p)
    y = _rand_words(rng, (r, 512), bits, cuda)
    keys = pvm.to_words(torch.from_numpy(rng.integers(0, 1 << 32, p)),
                        32).to(cuda)
    zero = torch.zeros_like(y)
    for coeff in _repair_coeffs(rng, p):
        cf = torch.from_numpy(coeff.astype(np.int32)).to(cuda)
        want = _u(tmw.mask_repair_plain(y, keys, cf))
        before = tmw.LAUNCHES["mask_repair"]
        inplace = y.clone()
        got = tmw.mask_repair(inplace, keys, cf, out=inplace)
        out = torch.full_like(y, 7)
        into = tmw.mask_repair(y, keys, cf, out=out)
        term = torch.full_like(y, 7)
        alone = tmw.mask_repair(None, keys, cf, out=term)
        assert tmw.LAUNCHES["mask_repair"] == before + 3
        torch.cuda.synchronize()
        assert got is inplace and into is out and alone is term
        assert np.array_equal(_u(inplace), want)
        assert np.array_equal(_u(out), want)
        assert np.array_equal(_u(term),
                              _u(tmw.mask_repair_plain(zero, keys, cf)))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
def test_mask_repair_at_most_staged_pairs_on_card(cuda, bits):
    # P = MAX_STAGED_BYTES / 8, every block's shared memory full of pairs,
    # with one live pair and with all live.
    rng = np.random.default_rng(bits)
    p = tmw.MAX_STAGED_BYTES // 8
    y = _rand_words(rng, (2, 512), bits, cuda)
    keys = pvm.to_words(torch.from_numpy(rng.integers(0, 1 << 32, p)),
                        32).to(cuda)
    one = np.zeros(p, np.int64)
    one[p // 2] = -1
    for coeff in (one, rng.choice([-1, 1], p)):
        cf = torch.from_numpy(coeff.astype(np.int32)).to(cuda)
        out = tmw.mask_repair(y, keys, cf)
        plain = tmw.mask_repair_plain(y, keys, cf)
        torch.cuda.synchronize()
        assert np.array_equal(_u(out), _u(plain))
    with pytest.raises(ValueError):
        tmw.mask_repair(y, torch.cat([keys, keys[:1]]),
                        torch.zeros(p + 1, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
def test_mask_repair_without_pairs_launches_nothing_on_card(cuda, bits):
    rng = np.random.default_rng(bits)
    y = _rand_words(rng, (3, 512), bits, cuda)
    none = torch.zeros(0, dtype=torch.uint32, device=cuda)
    cf = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = tmw.LAUNCHES["mask_repair"]
    assert tmw.mask_repair(y, none, cf) is y
    out = torch.full_like(y, 7)
    assert tmw.mask_repair(y, none, cf, out=out) is out
    term = tmw.mask_repair(None, none, cf, out=torch.full_like(y, 7))
    assert tmw.LAUNCHES["mask_repair"] == before
    assert np.array_equal(_u(out), _u(y))
    assert not _u(term).any()


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("t", [1, 2])
def test_masked_master_over_c_rows_matches_plain_on_card(cuda, bits, t):
    rng = np.random.default_rng(bits + t)
    n, c, r = 10, 3, 64
    q, p1, p2 = _history(rng, n, r)
    dq, dp1, dp2 = (torch.from_numpy(a).to(cuda) for a in (q, p1, p2))
    words = _rand_words(rng, (c, r, 512), bits, cuda)
    sum_wq = pvm.to_words(torch.tensor(12345, device=cuda), 32)
    dt = torch.tensor(t, dtype=torch.int32, device=cuda)
    spec = PrivacySpec(modulus_bits=bits, dp_epsilon=2.0)
    for k in (0, 9):
        kk = torch.tensor(k, device=cuda)
        out = tmw.masked_master_update(dq, kk, words, sum_wq, dp1, dp2, dt,
                                       ALPHA0, spec.scale_mult)
        plain = tmw.masked_master_update_plain(dq, kk, words, sum_wq, dp1,
                                               dp2, dt, ALPHA0,
                                               spec.scale_mult)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), plain.view(torch.int32))
    for k in (-1, n):                       # the pilot bound is N, not C
        out = tmw.masked_master_update(dq, torch.tensor(k, device=cuda),
                                       words, sum_wq, dp1, dp2, dt, ALPHA0,
                                       1.0)
        assert bool(out.isnan().all())


@pytest.mark.gpu
@pytest.mark.parametrize("bits,fanout", [(None, 2), (16, 4), (32, 3),
                                         (16, None)])
def test_tree_and_fault_round_steps_on_card_match_cpu(cuda, bits, fanout):
    # The tree and fault branches of the round core, chained: the card's
    # kernels and the CPU's plain versions give the same bits, with one
    # partial-sum launch a level and one repair launch a masked round.
    rng = np.random.default_rng(7)
    n, rows = 10, 96
    p0 = rng.standard_normal((rows, 128), dtype=np.float32) * 0.1
    sizes = rng.integers(100, 900, n).astype(np.float32)
    spec = (None if bits is None else
            PrivacySpec(modulus_bits=bits, dp_epsilon=2.0,
                        recovery_threshold=2, enforce=False))
    wire = rd.WirePath(rd.WireConfig(), privacy=spec,
                       tree=None if fanout is None else TreeSpec(fanout),
                       faults=FaultPlan(seed=3, drop_before_uplink=0.1,
                                        drop_after_uplink=0.25,
                                        straggler=0.1))
    states = {d: rd.init_round_state({"w": torch.from_numpy(p0).to(d)}, n,
                                     privacy=spec, device=d)
              for d in ("cpu", cuda)}
    before = {**tmw.LAUNCHES, **tps.LAUNCHES}
    for _ in range(4):
        bufs = (states["cpu"].buf_p1.numpy()[None]
                + rng.standard_normal((n, rows, 128), dtype=np.float32) * .01)
        costs = rng.random(n, dtype=np.float32) + 0.5
        for d in states:
            states[d], _, info = wire.round_step(
                states[d], torch.from_numpy(bufs).to(d),
                torch.from_numpy(costs).to(d), torch.from_numpy(sizes).to(d))
    after = {**tmw.LAUNCHES, **tps.LAUNCHES}
    levels = 0 if fanout is None else TreeSpec(fanout).n_levels(n)
    launched = {k: after[k] - before[k] for k in after}
    assert launched["master_masked"] == (0 if bits is None and fanout is None
                                         else 4)
    assert launched["mask_repair"] == (0 if bits is None else 4)
    assert (launched["partial_sum"] + launched["masked_partial_sum"]
            == 4 * levels)
    for a, b in zip(states["cpu"][:4], states[cuda][:4]):   # bitwise
        assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal (floats compared as their int32 bits)."""
    torch.cuda.synchronize()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [8, 64])
@pytest.mark.parametrize("t", [1, 2, 3])
def test_one_worker_uplinks_match_plain_on_card(cuda, r, t):
    rng = np.random.default_rng(r + t)
    q, p1, p2 = _history(rng, 1, r)
    q[0, 0, 64:96], q[0, 0, 96:128] = 0.1, -0.1     # exact ties at beta 0.2
    dq, dp1, dp2 = (torch.from_numpy(a).to(cuda) for a in (q[0], p1, p2))
    before = dict(tfw.LAUNCHES)
    if t == 1:
        out = tfw.ternary_pack_round1(dq, dp1, ALPHA1)
        assert _same(out, tfw.ternary_pack_round1_plain(dq, dp1, ALPHA1))
    else:
        out = tfw.ternary_pack(dq, dp1, dp2, 0.2)
        assert _same(out, tfw.ternary_pack_plain(dq, dp1, dp2, 0.2))
    betas = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    dt = torch.tensor(t, dtype=torch.int32, device=cuda)
    da = torch.tensor(ALPHA1, device=cuda)
    for k in range(3):                               # a slice of a vector
        got = tfw.ternary_pack_any(dq, dp1, dp2, dt, betas[k], da)
        assert _same(got, tfw.ternary_pack_any_plain(dq, dp1, dp2, dt,
                                                     betas[k], da))
    assert _same(got.view(1, r, 128), tfw.ternary_pack_stacked(
        dq[None], dp1, dp2, dt, betas[2:], ALPHA1))
    kind = "uplink_round1" if t == 1 else "uplink"
    assert tfw.LAUNCHES[kind] == before[kind] + 1
    assert tfw.LAUNCHES["uplink_traced"] == before["uplink_traced"] + 3


@pytest.mark.gpu
@pytest.mark.parametrize("r", [2, 16, 250])
def test_encode_matches_plain_on_card(cuda, r):
    rng = np.random.default_rng(r)
    q, p1, p2 = _history(rng, 1, r)
    dq, dp1, dp2 = (torch.from_numpy(a.reshape(-1, 128)).to(cuda)
                    for a in (q[0], p1, p2))
    before = dict(tte.LAUNCHES)
    codes = tte.ternary_encode(dq, dp1, dp2, 0.2)
    assert _same(codes, tte.ternary_encode(dq.cpu(), dp1.cpu(), dp2.cpu(),
                                           0.2).to(cuda))
    codes1 = tte.ternary_encode_round1(dq, dp1, ALPHA1)
    assert _same(codes1, tte.ternary_encode_round1(dq.cpu(), dp1.cpu(),
                                                   ALPHA1).to(cuda))
    assert tte.LAUNCHES == {k: v + 1 for k, v in before.items()}
    # Packed, the codes are the fused uplinks' bytes.
    rr = dq.shape[0] // 4
    packed = tpk.pack2bit(codes.view(rr, 512))
    assert _same(packed, tfw.ternary_pack(dq.view(rr, 512), dp1.view(rr, 512),
                                          dp2.view(rr, 512), 0.2))


@pytest.mark.gpu
def test_pack_and_unpack_match_plain_on_card(cuda):
    # Every byte value; codes in the fields' range and over all of int8;
    # unpack also over 1, 3 and 8 rows of random bytes.
    every = torch.arange(256, dtype=torch.uint8, device=cuda)
    b = every.repeat(32).view(64, 128)
    before = dict(tpk.LAUNCHES)
    codes = tpk.unpack2bit(b)
    assert _same(codes, tpk.unpack2bit_plain(b))
    assert _same(tpk.pack2bit(codes), b)              # the round trip
    gen = torch.Generator(device=cuda).manual_seed(1)
    for r in (1, 3, 8):
        b = torch.randint(0, 256, (r, 128), generator=gen, device=cuda,
                          dtype=torch.uint8)
        assert _same(tpk.unpack2bit(b), tpk.unpack2bit_plain(b))
    for lo, hi in ((-1, 3), (-128, 128)):
        c = torch.randint(lo, hi, (64, 512), generator=gen, device=cuda,
                          dtype=torch.int8)
        assert _same(tpk.pack2bit(c), tpk.pack2bit_plain(c))
    assert tpk.LAUNCHES == {"pack": before["pack"] + 3,
                            "unpack": before["unpack"] + 4}


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 10, 33])
def test_master_update_matches_plain_on_card(cuda, n):
    rng = np.random.default_rng(n)
    r = 64
    q = torch.from_numpy(rng.standard_normal((n, r, 128), dtype=np.float32)
                         ).to(cuda)
    p1, p2 = (torch.from_numpy(rng.standard_normal((r, 128),
                                                   dtype=np.float32)).to(cuda)
              for _ in range(2))
    w = torch.from_numpy(rng.random(n, dtype=np.float32) / n).to(cuda)
    w[0] = 0.0
    before = tmu.LAUNCHES["master_update"]
    for lo, hi in ((-1, 2), (-128, 128)):
        tern = torch.from_numpy(rng.integers(lo, hi, (n, r, 128)).astype(
            np.int8)).to(cuda)
        out = tmu.master_update(q[0], tern, w, p1, p2)
        assert _same(out, tmu.master_update_plain(q[0], tern, w, p1, p2))
    assert tmu.LAUNCHES["master_update"] == before + 2
    # On ternary codes: the fused packed master's bits.
    packed = torch.stack([tpk.pack2bit(tern_k.view(r // 4, 512))
                          for tern_k in tern.clamp(-1, 1)])
    fused = tfw.packed_master_update(
        q.view(n, r // 4, 512), torch.tensor(0, device=cuda), packed, w,
        p1.view(r // 4, 512), p2.view(r // 4, 512),
        torch.tensor(2, dtype=torch.int32, device=cuda), ALPHA0)
    out = tmu.master_update(q[0], tern.clamp(-1, 1), w, p1, p2)
    assert _same(out, fused.view(r, 128))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(999,), (3, 5, 7), (64, 37), (2048, 10)])
def test_arbitrary_shape_ops_on_card_match_cpu(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    q, p1, p2 = (rng.standard_normal(shape, dtype=np.float32)
                 for _ in range(3))
    tern = rng.integers(-1, 2, (4,) + shape).astype(np.int8)
    w = rng.random(4, dtype=np.float32) / 4
    args = {d: [torch.from_numpy(a).to(d) for a in (q, p1, p2, tern, w)]
            for d in ("cpu", cuda)}
    outs = {}
    for d, (dq, dp1, dp2, dt, dw) in args.items():
        codes = ops.ternary_encode(dq, dp1, dp2, 0.2)
        packed = ops.pack2bit(codes)
        outs[d] = [codes, ops.ternary_encode_round1(dq, dp1, ALPHA1), packed,
                   ops.unpack2bit(packed, codes.numel()),
                   ops.ternary_pack(dq, dp1, dp2, 0.2),
                   ops.ternary_pack_round1(dq, dp1, ALPHA1),
                   ops.master_update(dq, dt, dw, dp1, dp2)]
    for a, b in zip(outs["cpu"], outs[cuda]):
        assert _same(a.to(cuda), b)
    assert torch.equal(outs[cuda][2], outs[cuda][4])   # fused == composed


# -- local training and the scan driver -------------------------------------

def _uniform_federation(n: int, per: int, seed: int = 0):
    from repro_torch.data.pipeline import federated_loaders
    from repro_torch.data.synthetic import SyntheticClassification
    from repro_torch.fed.worker import Worker, make_worker_configs
    from repro_torch.models.mlp import mlp_loss_and_grad
    x, y = SyntheticClassification(n_samples=n * per, n_features=16,
                                   n_classes=5, seed=seed).generate()
    splits = [np.arange(i * per, (i + 1) * per) for i in range(n)]
    loaders = federated_loaders((x, y), splits, seed=seed)
    cfgs = make_worker_configs(n, [per] * n, seed=seed)
    return [Worker(cfg=cfgs[k], loader=loaders[k],
                   loss_and_grad=mlp_loss_and_grad) for k in range(n)]


def _mlp(dev):
    from repro_torch.models.mlp import init_mlp_classifier
    return init_mlp_classifier(torch.Generator().manual_seed(0), 16, 5,
                               hidden=(32,), device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["momentum", "adam", "sgd"])
def test_graphed_train_step_equals_eager_step_on_card(cuda, optimizer):
    from repro_torch.utils import tree_leaves
    w = _uniform_federation(1, 256)[0]
    w.cfg.optimizer = optimizer
    w.__post_init__()
    params = _mlp(cuda)
    opt_state = w.opt.init(params)
    idx = torch.from_numpy(w.round_indices()).to(cuda)
    batches = w.gather(idx)
    step = torch.tensor(7, dtype=torch.int32, device=cuda)
    ts = w.train_step(params, opt_state, batches)
    assert ts.graph is not None
    outs = []
    for replay in (True, False):
        ts.load(params, opt_state, step, batches)
        for _ in range(idx.shape[0]):
            ts.graph.replay() if replay else ts()
        outs.append([x.clone() for x in tree_leaves(
            (ts.params, ts.opt_state, ts.step, ts.total))])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0][-2]) == 7 + idx.shape[0]


@pytest.mark.gpu
@pytest.mark.parametrize("participation", [None, 0.5])
def test_drivers_bitwise_on_card(cuda, participation):
    from repro_torch.fed import simulator as sim_mod
    from repro_torch.utils import tree_leaves
    res = []
    for driver in ("run_fedpc", "run_fedpc_scan"):
        sim = sim_mod.FedSimulator(_uniform_federation(4, 256), _mlp(cuda),
                                   device=cuda)
        inner = rd.scan_rounds

        def guarded(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return inner(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        rd.scan_rounds = guarded
        try:
            res.append(getattr(sim, driver)(4, participation=participation,
                                            participation_seed=1))
        finally:
            rd.scan_rounds = inner
    assert res[0].pilot_history == res[1].pilot_history
    assert res[0].costs == res[1].costs
    assert np.isfinite(res[0].costs).all()
    for a, b in zip(tree_leaves(res[0].params), tree_leaves(res[1].params)):
        assert torch.equal(a, b)


# -- the baselines and the evasion defence ----------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 10])
def test_fedavg_aggregate_card_equals_cpu(cuda, n):
    # A product and a sum a launch, each rounded on its own: the card's
    # bits are the CPU's.
    from repro_torch.core import baselines as bl
    from repro_torch.utils import tree_leaves
    rng = np.random.default_rng(n)
    trees = [{"w": rng.standard_normal((300, 77), dtype=np.float32),
              "b": rng.standard_normal((77,), dtype=np.float32)}
             for _ in range(n)]
    sizes = rng.integers(10, 2000, n).astype(np.float32)
    out = {}
    for d in ("cpu", cuda):
        local = [{k: torch.from_numpy(v).to(d) for k, v in t.items()}
                 for t in trees]
        out[d] = (bl.fedavg_aggregate(local, sizes),
                  bl.fedavg_aggregate_stacked(
                      {k: torch.stack([t[k] for t in local])
                       for k in ("w", "b")}, sizes))
    for a, b in zip(tree_leaves(out["cpu"]), tree_leaves(out[cuda])):
        assert torch.equal(a.to(cuda), b)


@pytest.mark.gpu
def test_evasion_picks_the_same_pilots_on_card_and_cpu(cuda):
    from repro_torch.data.pipeline import federated_loaders
    from repro_torch.data.synthetic import (SyntheticClassification,
                                            random_share_split)
    from repro_torch.fed.simulator import FedSimulator
    from repro_torch.fed.worker import Worker, make_worker_configs
    from repro_torch.models.mlp import (init_mlp_classifier,
                                        mlp_loss_and_grad)
    runs = []
    for d in (cuda, torch.device("cpu")):
        x, y = SyntheticClassification(n_samples=1500, n_features=24,
                                       n_classes=6, seed=0).generate()
        splits = random_share_split(y, n_workers=3, seed=1)
        loaders = federated_loaders((x, y), splits, seed=2)
        cfgs = make_worker_configs(3, [len(s) for s in splits], seed=3)
        workers = [Worker(cfg=cfgs[k], loader=loaders[k],
                          loss_and_grad=mlp_loss_and_grad) for k in range(3)]
        params = init_mlp_classifier(torch.Generator().manual_seed(0), 24,
                                     6, device=d)
        sim = FedSimulator(workers, params, evade_streak=2, device=d)
        runs.append((sim.run_fedpc(rounds=8), sim.ledger.events))
    (card, card_events), (cpu, cpu_events) = runs
    assert card.pilot_history == cpu.pilot_history
    assert card_events == cpu_events
    np.testing.assert_allclose(card.costs, cpu.costs, rtol=1e-3)


# -- the telemetry layer and the checkpoint on the card -----------------------

def _telemetry_wire(kind: str):
    if kind == "plain":
        return rd.WirePath(rd.WireConfig()), {"uplink_stacked": 1,
                                              "master": 1}
    spec = PrivacySpec(modulus_bits=16, dp_epsilon=2.0,
                       recovery_threshold=2, enforce=False)
    wire = rd.WirePath(rd.WireConfig(), privacy=spec, tree=TreeSpec(4),
                       faults=FaultPlan(seed=0, drop_before_uplink=0.05,
                                        drop_after_uplink=0.15,
                                        straggler=0.05))
    return wire, {"uplink_masked": 1, "masked_partial_sum": 1,
                  "mask_repair": 1, "master_masked": 1}


def _launch_counts() -> dict:
    return {**tfw.LAUNCHES, **tmw.LAUNCHES, **tps.LAUNCHES}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["plain", "masked_tree_faults"])
def test_round_step_with_telemetry_on_card(cuda, kind):
    # The record and the carry add no host sync and no launch of the
    # wire's kernels; the card's record is the CPU's, bit for bit.
    wire, per_round = _telemetry_wire(kind)
    rng = np.random.default_rng(5)
    n, rows = 10, 96
    p0 = rng.standard_normal((rows, 128), dtype=np.float32) * 0.1
    sizes = rng.integers(100, 900, n).astype(np.float32)
    states = {(d, on): rd.init_round_state(
        {"w": torch.from_numpy(p0)}, n, privacy=wire.privacy, telemetry=on,
        device=d) for d in ("cpu", cuda) for on in (True, False)}
    for _ in range(3):
        bufs = (states["cpu", True].buf_p1.numpy()[None]
                + rng.standard_normal((n, rows, 128), dtype=np.float32) * .01)
        costs = rng.random(n, dtype=np.float32) + 0.5
        recs = {}
        for (d, on), st in states.items():
            args = (torch.from_numpy(bufs).to(d),
                    torch.from_numpy(costs).to(d),
                    torch.from_numpy(sizes).to(d))
            before = _launch_counts()
            if d != "cpu":
                torch.cuda.set_sync_debug_mode("error")
            try:
                states[d, on], _, info = wire.round_step(st, *args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            launched = {k: v - before[k] for k, v in _launch_counts().items()
                        if v != before[k]}
            assert launched == ({} if d == "cpu" else per_round)
            assert ("telemetry" in info) == on
            recs[d, on] = info.get("telemetry")
        for a, b in zip(recs["cpu", True], recs[cuda, True]):
            assert b.device.type == "cuda"
            assert _same(a, b.cpu())
    for a, b in zip(states["cpu", True].telemetry,
                    states[cuda, True].telemetry):
        assert _same(a, b.cpu())
    for a, b in zip(states[cuda, True][:4], states[cuda, False][:4]):
        assert _same(a, b)
    assert int(states[cuda, True].telemetry.rounds) == 3


@pytest.mark.gpu
def test_round_state_checkpoint_round_trips_on_card(cuda, tmp_path):
    spec = PrivacySpec(dp_epsilon=2.0, enforce=False)
    wire = rd.WirePath(rd.WireConfig(), privacy=spec)
    n, rows = 4, 64
    p0 = torch.linspace(-1.0, 1.0, rows * 128, device=cuda)
    st = rd.init_round_state({"w": p0}, n, privacy=spec, device=cuda)
    st, _, _ = wire.round_step(st, st.buf_p1[None] + torch.linspace(
        -0.02, 0.02, n * rows * 128, device=cuda).view(n, rows, 128),
        torch.arange(1.0, n + 1.0, device=cuda),
        torch.full((n,), 50.0, device=cuda))
    rd.save_round_state(str(tmp_path), st)
    like = rd.init_round_state({"w": p0}, n, privacy=spec, device=cuda)
    back, manifest = rd.load_round_state(str(tmp_path), like)
    assert manifest["step"] == 2
    from repro_torch.checkpoint.checkpoint import _flatten_with_path
    got, want = _flatten_with_path(back), _flatten_with_path(st)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert _same(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["plain", "masked_tree_faults"])
def test_profile_session_holds_a_scope_a_launch(cuda, kind):
    from repro_torch.telemetry import profile as tprof
    wire, per_round = _telemetry_wire(kind)
    n, rows = 10, 96
    st = rd.init_round_state({"w": torch.zeros(rows * 128)}, n,
                             privacy=wire.privacy, device=cuda)
    bufs = torch.linspace(-0.1, 0.1, n * rows * 128,
                          device=cuda).view(n, rows, 128)
    costs = torch.arange(1.0, n + 1.0, device=cuda)
    sizes = torch.full((n,), 50.0, device=cuda)
    before = _launch_counts()
    with tprof.profile_session() as prof:
        wire.round_step(st, bufs, costs, sizes)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    launched = sum(v - before[k] for k, v in _launch_counts().items())
    assert launched == sum(per_round.values())
    ranges = {d: sorted(e.name for e in prof.events()
                        if e.name.startswith("wire/") and e.device_type == d)
              for d in (DeviceType.CPU, DeviceType.CUDA)}
    scopes = ranges[DeviceType.CPU]
    assert len(scopes) == launched
    assert all(s.endswith("/cuda") and f"/r{rows // 4}n" in s
               for s in scopes)
    # Where the profiler records CUDA activity, each range's kernels run
    # inside its device-side twin.
    assert ranges[DeviceType.CUDA] in ([], scopes)


# -- the §4.2 audit: the pilot slot and the enforced round -------------------

@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("t", [1, 2])
def test_masters_ignore_poisoned_stack_rows_on_card(cuda, t, bits):
    # The masters declare the (N, R, 512) stack their pilot slot: they read
    # the pilot's row in place at k_star and nothing else of it, so NaN,
    # inf and garbage in every other row change no bit, kernel or plain.
    rng = np.random.default_rng(t + bits)
    n, r = 10, 64
    q, p1, p2 = _history(rng, n, r)
    dq, dp1, dp2 = (torch.from_numpy(a).to(cuda) for a in (q, p1, p2))
    dt = torch.tensor(t, dtype=torch.int32, device=cuda)
    packed = torch.from_numpy(rng.integers(0, 256, (n, r, 128),
                                           dtype=np.uint8)).to(cuda)
    w = torch.from_numpy(rng.random(n, dtype=np.float32) / n).to(cuda)
    words = pvm.to_words(torch.from_numpy(rng.integers(
        0, 1 << bits, (3, r, 512))).to(cuda), bits)
    sum_wq = pvm.to_words(torch.tensor(12345, device=cuda), 32)
    for k in (0, 7):
        ks = torch.tensor(k, device=cuda)
        junk = torch.from_numpy(rng.standard_normal(
            (n, r, 512), dtype=np.float32) * 1e30).to(cuda)
        junk.view(-1)[::3] = float("nan")
        junk.view(-1)[1::7] = float("-inf")
        keep = torch.arange(n, device=cuda) == k
        bad = torch.where(keep[:, None, None], dq, junk)
        for fn in (tfw.packed_master_update, tfw.packed_master_update_plain):
            a = fn(dq, ks, packed, w, dp1, dp2, dt, ALPHA0)
            b = fn(bad, ks, packed, w, dp1, dp2, dt, ALPHA0)
            assert bool(torch.isfinite(a).all()) and _same(a, b)
        for fn in (tmw.masked_master_update, tmw.masked_master_update_plain):
            a = fn(dq, ks, words, sum_wq, dp1, dp2, dt, ALPHA0, 2.0 ** -14)
            b = fn(bad, ks, words, sum_wq, dp1, dp2, dt, ALPHA0, 2.0 ** -14)
            assert bool(torch.isfinite(a).all()) and _same(a, b)


@pytest.mark.gpu
def test_enforced_masked_run_on_card(cuda):
    # PrivacySpec() enforces (the default): the audit runs once on meta
    # tensors before round 1 and launches nothing on the card; the rounds
    # launch and give what the unenforced run does, bit for bit.
    from repro_torch.core.fedpc import FedPCConfig
    from repro_torch.fed import simulator as sim_mod
    from repro_torch.utils import tree_leaves
    runs, launched = [], []
    for enforce in (True, False):
        sim = sim_mod.FedSimulator(
            _uniform_federation(4, 256), _mlp(cuda),
            FedPCConfig(n_workers=4, privacy=PrivacySpec(
                dp_epsilon=2.0, enforce=enforce)), device=cuda)
        before = _launch_counts()
        runs.append(sim.run_fedpc(3))
        torch.cuda.synchronize()
        launched.append({k: v - before[k]
                         for k, v in _launch_counts().items()})
        assert len(sim.ledger.audits) == int(enforce)
    assert launched[0] == launched[1]
    assert launched[0]["uplink_masked"] == launched[0]["master_masked"] == 3
    assert runs[0].pilot_history == runs[1].pilot_history
    assert runs[0].costs == runs[1].costs
    for a, b in zip(tree_leaves(runs[0].params), tree_leaves(runs[1].params)):
        assert torch.equal(a, b)


# -- launch plans: every plan gives the default plan's and the twin's bits --

@pytest.fixture
def empty_table(monkeypatch):
    from repro_torch.kernels import tune
    monkeypatch.setattr(tune, "_TABLE", {})
    return tune


@pytest.mark.gpu
@pytest.mark.parametrize("sweep,args,kw", [
    ("autotune_stacked", (37, 3), {}), ("autotune_stacked", (37, 10), {}),
    ("autotune_master", (37, 3), {}), ("autotune_master", (37, 10), {}),
    ("autotune_masked_uplink", (37, 10), {"word_bits": 16}),
    ("autotune_masked_uplink", (37, 10), {"word_bits": 32}),
    ("autotune_masked_uplink", (37, 17), {"word_bits": 16}),
    ("autotune_masked_uplink", (37, 17), {"word_bits": 32}),
    ("autotune_masked_master", (37, 3), {"word_bits": 16}),
    ("autotune_masked_master", (37, 10), {"word_bits": 32}),
    ("autotune_partial_sum", (37, 2, 10), {}),
    ("autotune_partial_sum", (37, 4, 10), {"word_bits": 16}),
    ("autotune_partial_sum", (37, 2, 10), {"masked": True,
                                           "word_bits": 16}),
    ("autotune_partial_sum", (37, 4, 7), {"masked": True, "word_bits": 32}),
    ("autotune_mask_repair", (37, 13), {"word_bits": 16}),
    ("autotune_mask_repair", (37, 13), {"word_bits": 32})])
def test_every_sweep_candidate_gives_the_same_bits_on_card(
        cuda, empty_table, sweep, args, kw):
    # verify: each candidate bitwise against the plain twin and the
    # default plan, which is the first candidate; R = 37 leaves a ragged
    # CTA under every block_rows but 1 and 37.
    rec = getattr(empty_table, sweep)(*args, device=cuda, reps=1,
                                      verify=True, **kw)
    assert rec["verified"] and rec["backend"] == "cuda"
    first = rec["timings"][0]
    assert {k: first[k] for k in ("block_rows", "block_workers")} == \
        rec["default"]
    # the masked uplink's pair and tile kernels (a square cohort up to
    # the cap: N = 10 and 17 here) and the leaf partial sum honour their
    # default alone
    alone = ((sweep == "autotune_masked_uplink"
              and tmw.uses_pair_kernel(args[1], args[1]))
             or (sweep == "autotune_partial_sum" and not kw.get("masked")))
    if alone:
        assert len(rec["timings"]) == 1
    else:
        assert len(rec["timings"]) >= 3 or sweep == "autotune_masked_master"


def _plans(kind, r, ext, pairs=False):
    """A spread of honoured plans over R rows and an axis of ``ext``."""
    from repro_torch.kernels import tune
    raw = [(1, 1), (2, ext), (3, 2), (r, ext), (r + 5, 3), (7, 8), (64, 4)]
    return sorted({tune.fit_cuda_plan(kind, r, ext, br, bw, pairs=pairs)
                   for br, bw in raw})


@pytest.mark.gpu
@pytest.mark.parametrize("n,r", [(3, 8), (10, 37)])
@pytest.mark.parametrize("t", [1, 2])
def test_plain_round_kernels_under_every_plan_on_card(cuda, n, r, t):
    rng = np.random.default_rng(7 * n + r + t)
    q, p1, p2 = _history(rng, n, r)
    dq, dp1, dp2 = (torch.from_numpy(a).to(cuda) for a in (q, p1, p2))
    dt = torch.tensor(t, dtype=torch.int32, device=cuda)
    db = torch.from_numpy(rng.choice([0.1, 0.2], n).astype(np.float32)
                          ).to(cuda)
    plain = tfw.ternary_pack_stacked_plain(dq, dp1, dp2, dt, db, ALPHA1)
    for br, bw in _plans("uplink_stacked", r, n):
        got = tfw.ternary_pack_stacked(dq, dp1, dp2, dt, db, ALPHA1,
                                       block_rows=br, block_workers=bw)
        assert torch.equal(got, plain), (br, bw)
    w = torch.from_numpy(rng.random(n, dtype=np.float32) / n).to(cuda)
    k = torch.tensor(0, device=cuda)
    w[0] = 0.0
    want = tfw.packed_master_update_plain(dq, k, plain, w, dp1, dp2, dt,
                                          ALPHA0)
    for br, bw in _plans("master", r, n):
        got = tfw.packed_master_update(dq, k, plain, w, dp1, dp2, dt, ALPHA0,
                                       block_rows=br, block_workers=bw)
        assert _same(got, want), (br, bw)
    one = tfw.ternary_pack_plain(dq[0], dp1, dp2, 0.2)
    for br, _ in _plans("uplink", r, 1):
        assert torch.equal(tfw.ternary_pack(dq[0], dp1, dp2, 0.2,
                                            block_rows=br), one), br


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("n", [10, 17, 33])
def test_masked_kernels_under_every_plan_on_card(cuda, bits, n):
    # The wrapper's kernel (the pair kernel at N = 10, the tile kernel at
    # 17 and 33) under the plans it honours, its default alone; the row
    # fold under a spread of its own.
    rng = np.random.default_rng(n + bits)
    r = 37
    ops = _masked_operands(rng, n, r, 2, bits, True, cuda)
    dq, dp1, dp2, dt, _, wq, _, _, _ = ops
    kw = dict(rr_threshold=3277, word_bits=bits)
    plain = tmw.ternary_pack_masked_plain(*ops[:5], ALPHA1, *ops[5:], **kw)
    pairs = tmw.uses_pair_kernel(n, n)
    assert pairs
    kind = "uplink_masked16" if bits == 16 else "uplink_masked"
    assert _plans(kind, r, n, pairs=pairs) == [(2, n)]
    for br, bw in _plans(kind, r, n, pairs=pairs):
        got = tmw.ternary_pack_masked(*ops[:5], ALPHA1, *ops[5:], **kw,
                                      block_rows=br, block_workers=bw)
        assert torch.equal(pvm.as_u64(got), pvm.as_u64(plain)), (br, bw)
    for br, bw in _plans("uplink_masked", r, n):       # the row fold
        got = tmw._ternary_pack_masked_rows(*ops[:5], ALPHA1, *ops[5:], **kw,
                                            block_rows=br, block_workers=bw)
        assert torch.equal(pvm.as_u64(got), pvm.as_u64(plain)), (br, bw)
    sum_wq = pvm.to_words(pvm.as_u64(wq).sum(), 32)
    k = torch.tensor(1, device=cuda)
    want = tmw.masked_master_update_plain(dq, k, plain, sum_wq, dp1, dp2, dt,
                                          ALPHA0, 2.0 ** -14)
    for br, bw in _plans("master_masked", r, n):
        got = tmw.masked_master_update(dq, k, plain, sum_wq, dp1, dp2, dt,
                                       ALPHA0, 2.0 ** -14, block_rows=br,
                                       block_workers=bw)
        assert _same(got, want), (br, bw)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
def test_tree_and_repair_kernels_under_every_plan_on_card(cuda, bits):
    rng = np.random.default_rng(bits)
    r, c, fanout = 37, 10, 4
    g = -(-c // fanout)
    packed = torch.from_numpy(rng.integers(0, 256, (c, r, 128),
                                           dtype=np.uint8)).to(cuda)
    wq = pvm.to_words(torch.from_numpy(rng.integers(0, 1 << 14, c)),
                      32).to(cuda)
    want = tps.partial_sum_plain(packed, wq, fanout=fanout, word_bits=bits)
    for br, bg in _plans("partial_sum", r, g):
        got = tps.partial_sum(packed, wq, fanout=fanout, word_bits=bits,
                              block_rows=br, block_groups=bg)
        assert torch.equal(pvm.as_u64(got), pvm.as_u64(want)), (br, bg)
    words = _rand_words(rng, (c, r, 512), bits, cuda)
    keys = pvm.pair_stream_keys(5, g, 3, device=cuda)
    signs = pvm.tree_pair_signs(g, 2, device=cuda)
    want = tps.masked_partial_sum_plain(words, keys, signs, fanout=fanout,
                                        sibling=2)
    for br, bg in _plans("partial_sum_masked", r, g):
        got = tps.masked_partial_sum(words, keys, signs, fanout=fanout,
                                     sibling=2, block_rows=br,
                                     block_groups=bg)
        assert torch.equal(pvm.as_u64(got), pvm.as_u64(want)), (br, bg)
    y = _rand_words(rng, (1000, 512), bits, cuda)
    rkeys = pvm.to_words(torch.from_numpy(rng.integers(0, 1 << 32, 13)),
                         32).to(cuda)
    coeff = torch.from_numpy(rng.integers(-1, 2, 13).astype(np.int32)
                             ).to(cuda)
    want = tmw.mask_repair_plain(y, rkeys, coeff)
    term = tmw.mask_repair_plain(torch.zeros_like(y), rkeys, coeff)
    kind = "mask_repair16" if bits == 16 else "mask_repair"
    from repro_torch.kernels import tune
    for br in tune.repair_rows(kind):
        got = tmw.mask_repair(y, rkeys, coeff, block_rows=br)
        assert torch.equal(pvm.as_u64(got), pvm.as_u64(want)), br
        z = torch.full_like(y, 7)
        tmw.mask_repair(None, rkeys, coeff, out=z, block_rows=br)
        assert torch.equal(pvm.as_u64(z), pvm.as_u64(term)), br


@pytest.mark.gpu
def test_a_plan_a_kernel_would_change_raises_on_card(cuda):
    rng = np.random.default_rng(3)
    n, r = 10, 8
    q, p1, p2 = _history(rng, n, r)
    dq, dp1, dp2 = (torch.from_numpy(a).to(cuda) for a in (q, p1, p2))
    dt = torch.tensor(2, dtype=torch.int32, device=cuda)
    packed = torch.zeros((n, r, 128), dtype=torch.uint8, device=cuda)
    w = torch.zeros(n, device=cuda)
    k = torch.tensor(0, device=cuda)
    with pytest.raises(ValueError, match="nearest plan"):
        tfw.packed_master_update(dq, k, packed, w, dp1, dp2, dt, ALPHA0,
                                 block_workers=3)
    ops = _masked_operands(rng, n, r, 2, 16, False, cuda)
    with pytest.raises(ValueError, match="nearest plan"):
        tmw.ternary_pack_masked(*ops[:5], ALPHA1, *ops[5:], word_bits=16,
                                block_workers=4)
    with pytest.raises(ValueError, match="nearest plan"):   # the pair kernel
        tmw.ternary_pack_masked(*ops[:5], ALPHA1, *ops[5:], word_bits=16,
                                block_rows=8)
    wq = pvm.to_words(torch.zeros(n, dtype=torch.int64), 32).to(cuda)
    with pytest.raises(ValueError, match="nearest plan"):   # the leaf sum
        tps.partial_sum(packed, wq, fanout=2, block_rows=8)
    y = _rand_words(rng, (r, 512), 16, cuda)
    rkeys = pvm.to_words(torch.from_numpy(rng.integers(0, 1 << 32, 3)),
                         32).to(cuda)
    coeff = torch.ones(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="nearest plan"):
        tmw.mask_repair(y, rkeys, coeff, block_rows=5)


@pytest.mark.gpu
@pytest.mark.parametrize("bits,fanout,block_rows,block_workers", [
    (None, None, 8, 3), (16, None, 3, 4), (16, 4, 5, 2), (None, 2, 8, 2),
    (32, 2, 1, 8)])
def test_round_steps_under_a_pinned_plan_on_card(cuda, bits, fanout,
                                                 block_rows, block_workers):
    # A pinned plan through WirePath, faults on (the repair runs): every
    # launch snapped to its kernel, as many launches, the default plan's
    # bits, the CPU's bits.
    rng = np.random.default_rng(11)
    n, rows = 10, 96
    p0 = rng.standard_normal((rows, 128), dtype=np.float32) * 0.1
    sizes = rng.integers(100, 900, n).astype(np.float32)
    spec = (None if bits is None else
            PrivacySpec(modulus_bits=bits, dp_epsilon=2.0,
                        recovery_threshold=2, enforce=False))
    plan = FaultPlan(seed=3, drop_before_uplink=0.1, drop_after_uplink=0.25,
                     straggler=0.1)
    tree = None if fanout is None else TreeSpec(fanout)
    wires = {
        "default": rd.WirePath(rd.WireConfig(), privacy=spec, tree=tree,
                               faults=plan),
        "pinned": rd.WirePath(rd.WireConfig(), privacy=spec, tree=tree,
                              faults=plan, block_rows=block_rows,
                              block_workers=block_workers)}
    runs = [("cpu", "pinned"), (cuda, "default"), (cuda, "pinned")]
    states = {run: rd.init_round_state({"w": torch.from_numpy(p0).to(
        run[0])}, n, privacy=spec, device=run[0]) for run in runs}
    launched = {}
    for _ in range(3):
        bufs = (states[runs[0]].buf_p1.numpy()[None]
                + rng.standard_normal((n, rows, 128), dtype=np.float32) * .01)
        costs = rng.random(n, dtype=np.float32) + 0.5
        for run in runs:
            d = run[0]
            before = _launch_counts()
            states[run], _, _ = wires[run[1]].round_step(
                states[run], torch.from_numpy(bufs).to(d),
                torch.from_numpy(costs).to(d), torch.from_numpy(sizes).to(d))
            after = _launch_counts()
            for k in after:
                launched[run, k] = (launched.get((run, k), 0)
                                    + after[k] - before[k])
    for k in _launch_counts():
        assert launched[(cuda, "default"), k] == launched[(cuda, "pinned"), k]
    for run in runs[1:]:
        for a, b in zip(states[runs[0]][:4], states[run][:4]):   # bitwise
            assert torch.equal(a.view(torch.int32),
                               b.cpu().view(torch.int32)), run
