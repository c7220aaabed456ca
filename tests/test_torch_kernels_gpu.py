"""The CUDA wire kernels against their plain PyTorch versions, on the card:
the plain round's uplink and master, and the masked round's.

Needs a CUDA card and ``nvcc``; every test here is marked ``gpu`` and skips
where ``torch.cuda.is_available()`` is false. It imports nothing of JAX, so
it runs on a machine with the port alone::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.fed import rounds as rd
from repro_torch.kernels import fused_wire as tfw
from repro_torch.kernels import masked_wire as tmw
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


def _masked_operands(rng, n, r, t, bits, participation, dev):
    """Every operand of the masked uplink, on ``dev``."""
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
    signs = pvm.pair_signs(n, participation=part, device=dev)
    rrk = pdp.rr_stream_keys(1, dt, n)
    return dq, dp1, dp2, dt, beta, wq, keys, signs, rrk


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("n,r,participation", [(1, 8, False), (2, 8, False),
                                               (3, 8, True), (10, 64, False),
                                               (33, 8, True)])
@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("thr", [0, 3277])
def test_masked_kernels_match_plain_on_card(cuda, bits, n, r, participation,
                                            t, thr):
    rng = np.random.default_rng(1000 * n + 10 * t + bits + thr)
    ops = _masked_operands(rng, n, r, t, bits, participation, cuda)
    dq, dp1, dp2, dt, _, wq, _, _, _ = ops
    for use_masks in (True, False):
        kw = dict(rr_threshold=thr, word_bits=bits, use_masks=use_masks)
        before = tmw.LAUNCHES["uplink_masked"]
        words = tmw.ternary_pack_masked(*ops[:5], ALPHA1, *ops[5:], **kw)
        assert tmw.LAUNCHES["uplink_masked"] == before + 1
        plain = tmw.ternary_pack_masked_plain(*ops[:5], ALPHA1, *ops[5:],
                                              **kw)
        assert words.dtype == plain.dtype
        assert torch.equal(pvm.as_u64(words), pvm.as_u64(plain))

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
