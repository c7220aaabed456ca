"""The port's fault injection and dropout-tolerant secure aggregation
against ``repro.fed.faults``, ``repro.privacy.recovery``,
``repro.privacy.audit``, the repair kernel of ``repro.kernels.masked_wire``
and the fault branches of ``repro.fed.rounds`` / ``repro.fed.simulator``.

Held bitwise: ``FaultPlan.codes`` over many (seed, round, n), the
GF(2^16) Shamir dealing and reconstruction, the recovered keys (equal to
the ``pair_stream_keys`` row), the viability split, the repair pairs and
coefficients, the plain twin of the repair kernel and of the masked master
over C word rows beside an N-row pilot stack (against the Pallas kernels
in interpret mode), and ``round_from_stacked`` / ``round_step`` with
faults on the flat and the tree wire at both moduli. A repaired round
equals the survivors-only round bitwise. The simulator books the same
pilots, bytes, recovery bytes and ledger events as the JAX one; costs and
params agree within the ``rtol=1e-3`` that ``test_torch_sim`` explains.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fedpc import FedPCConfig as JCfg
from repro.core.tree import TreeSpec as JTree
from repro.data.pipeline import federated_loaders as j_loaders
from repro.data.synthetic import SyntheticClassification as JData
from repro.data.synthetic import random_share_split as j_split
from repro.fed import rounds as jrd
from repro.fed.faults import FaultPlan as JPlan
from repro.fed.simulator import FedSimulator as JSim
from repro.fed.worker import Worker as JWorker
from repro.fed.worker import make_worker_configs as j_cfgs
from repro.kernels import masked_wire as jmw
from repro.models.mlp import init_mlp_classifier as j_init
from repro.models.mlp import mlp_loss_and_grad as j_lag
from repro.privacy import recovery as jpvr
from repro.privacy.spec import PrivacySpec as JSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedpc import FedPCConfig as TCfg
from repro_torch.core.privacy import LeakageError
from repro_torch.core.tree import TreeSpec as TTree
from repro_torch.data.pipeline import federated_loaders as t_loaders
from repro_torch.data.synthetic import SyntheticClassification as TData
from repro_torch.data.synthetic import random_share_split as t_split
from repro_torch.fed import faults as tft
from repro_torch.fed import rounds as trd
from repro_torch.fed.simulator import FedSimulator as TSim
from repro_torch.fed.worker import Worker as TWorker
from repro_torch.fed.worker import make_worker_configs as t_cfgs
from repro_torch.kernels import masked_wire as tmw
from repro_torch.kernels import ops as tops
from repro_torch.models.mlp import mlp_loss_and_grad as t_lag
from repro_torch.privacy import audit as taudit
from repro_torch.privacy import masking as tpvm
from repro_torch.privacy import recovery as tpvr
from repro_torch.privacy.spec import PrivacySpec as TSpec
from repro_torch.utils import tree_leaves

ROWS = 32                    # (rows, 128) buffers: R = 8 kernel rows


def _u(x):
    """Words of either package as int64 values."""
    if isinstance(x, torch.Tensor):
        return tpvm.as_u64(x).numpy()
    return np.asarray(x).astype(np.int64)


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _words(rng, shape, bits):
    """Random wire words: numpy of the unsigned type, and the tensor."""
    dt = np.uint16 if bits == 16 else np.uint32
    a = rng.integers(0, 1 << bits, shape, dtype=np.uint64).astype(dt)
    t = torch.from_numpy(a.view(np.int16 if bits == 16 else np.int32)).view(
        torch.uint16 if bits == 16 else torch.uint32)
    return a, t


def _u32(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32)).view(
        torch.uint32)


# -- the fault schedule ------------------------------------------------------

PLANS = [dict(seed=0, drop_before_uplink=0.05, drop_after_uplink=0.15,
              straggler=0.05),
         dict(seed=3, drop_after_uplink=0.3),
         dict(seed=0xFFFFFFFF, drop_before_uplink=0.1, straggler=0.7),
         dict(seed=17, drop_before_uplink=1 / 3, drop_after_uplink=1 / 3,
              straggler=1 / 3)]


@pytest.mark.parametrize("plan", PLANS)
def test_fault_codes_match(plan):
    jp, tp = JPlan(**plan), tft.FaultPlan(**plan)
    assert tp.active == jp.active and tp.total == jp.total
    seen = set()
    for n in (1, 7, 33):
        for t in (1, 2, 3, 5, 8, 13, 21, 34, 55, 1 << 20):
            got = tp.codes(torch.tensor(t, dtype=torch.int32), n)
            want = np.asarray(jp.codes(jnp.asarray(t, jnp.int32), n))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(tp.alive(t, n).numpy(),
                                          np.asarray(jp.alive(t, n)))
            seen |= set(want.tolist())
    assert len(seen) >= 2
    with pytest.raises(ValueError):
        tft.FaultPlan(drop_after_uplink=0.7, straggler=0.5)
    with pytest.raises(ValueError):
        tft.FaultPlan(drop_before_uplink=-0.1)


# -- the Shamir control plane ------------------------------------------------

def test_gf_and_shamir_match():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 16, 500).astype(np.uint32)
    b = rng.integers(0, 1 << 16, 500).astype(np.uint32)
    a[:3] = 0
    np.testing.assert_array_equal(tpvr.gf_mul(a, b), jpvr.gf_mul(a, b))
    np.testing.assert_array_equal(tpvr.gf_inv(b | 1), jpvr.gf_inv(b | 1))
    with pytest.raises(ZeroDivisionError):
        tpvr.gf_inv(a)
    secret = rng.integers(0, 1 << 16, (5, 2)).astype(np.uint16)
    for n_shares, thr in ((6, 3), (4, 4), (2, 1)):
        shares = tpvr.deal_shares(secret, n_shares, thr)
        np.testing.assert_array_equal(shares,
                                      jpvr.deal_shares(secret, n_shares, thr))
        xs = np.arange(1, n_shares + 1, dtype=np.uint16)
        sel = rng.permutation(n_shares)[:thr]
        np.testing.assert_array_equal(
            tpvr.reconstruct(shares[sel], xs[sel]), secret)
    with pytest.raises(ValueError):
        tpvr.deal_shares(secret, 2, 3)


@pytest.mark.parametrize("gsz", [None, 4])
def test_recovered_keys_match(gsz):
    n, t = 10, 4
    alive = np.ones(n)
    alive[[2, 5]] = 0.0
    for worker in (2, 5):
        members, keys = tpvr.recover_worker_keys(5, worker, n, t, 2,
                                                 alive=alive, group_size=gsz)
        jm, jkeys = jpvr.recover_worker_keys(5, worker, n,
                                             jnp.asarray(t, jnp.int32), 2,
                                             alive=alive, group_size=gsz)
        np.testing.assert_array_equal(members, jm)
        np.testing.assert_array_equal(keys, jkeys)
        row = _u(tpvm.pair_stream_keys(5, n, torch.tensor(t)))[worker]
        np.testing.assert_array_equal(keys, row[members].astype(np.uint32))
        tm, _xs, tsh = tpvr.deal_worker_shares(5, worker, n, t, 2,
                                               group_size=gsz)
        np.testing.assert_array_equal(tsh, jpvr.deal_worker_shares(
            5, worker, n, jnp.asarray(t, jnp.int32), 2, group_size=gsz)[2])
    with pytest.raises(LeakageError, match="still live"):
        tpvr.recover_worker_keys(5, 0, n, t, 2, alive=alive, group_size=gsz)
    with pytest.raises(LeakageError):
        taudit.check_recovery_target(1, torch.ones(n))
    taudit.check_recovery_target(2, alive)
    few = np.zeros(n)
    few[1] = 1.0
    with pytest.raises(ValueError, match="below threshold"):
        tpvr.recover_worker_keys(5, 2, n, t, 2, alive=few, group_size=gsz)


def test_viability_split_and_repair_operands_match():
    rng = np.random.default_rng(1)
    for n, gsz, thr in ((8, 4, 2), (10, 4, 3), (7, 2, 2), (6, None, 3),
                        (10, None, 2)):
        ji, jj = jpvr.repair_pair_index(n, gsz)
        ti, tj = tpvr.repair_pair_index(n, gsz)
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(tj.numpy(), jj)
        keys = tpvm.pair_stream_keys(5, n, torch.tensor(3))
        for _ in range(3):
            alive = (rng.random(n) < 0.7).astype(np.float32)
            pm = (rng.random(n) < 0.8).astype(np.float32)
            for p in (None, pm):
                ae, de = tpvr.effective_masks(
                    None if p is None else torch.from_numpy(p),
                    torch.from_numpy(alive), thr, gsz, n)
                jae, jde = jpvr.effective_masks(
                    None if p is None else jnp.asarray(p),
                    jnp.asarray(alive), thr, gsz, n)
                np.testing.assert_array_equal(ae.numpy(), np.asarray(jae))
                np.testing.assert_array_equal(de.numpy(), np.asarray(jde))
                signs = (tpvm.pair_signs(n, participation=p) if gsz is None
                         else tpvm.tree_pair_signs(n, gsz, participation=p))
                k, c = tpvr.repair_coefficients(keys, signs, ae, de, ti, tj)
                jk, jc = jpvr.repair_coefficients(
                    jnp.asarray(_u(keys).astype(np.uint32)),
                    jnp.asarray(signs.numpy()), jae, jde, ji, jj)
                assert k.dtype == torch.uint32 and c.dtype == torch.int32
                np.testing.assert_array_equal(_u(k), _u(jk))
                np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


# -- kernel #8 and the C-row master: plain twins against the Pallas kernels --

@pytest.mark.parametrize("bits", [16, 32])
def test_mask_repair_twin_matches_pallas(bits):
    rng = np.random.default_rng(bits)
    r = 8
    ya, yt = _words(rng, (r, 512), bits)
    for p in (1, 3, 9):
        keys = rng.integers(0, 1 << 32, p, dtype=np.uint64).astype(np.uint32)
        for coeff in (rng.integers(-1, 2, p).astype(np.int32),
                      rng.integers(-5, 6, p).astype(np.int32),
                      np.zeros(p, np.int32)):
            want = jmw.mask_repair_2d(jnp.asarray(ya), jnp.asarray(keys),
                                      jnp.asarray(coeff), interpret=True,
                                      block_rows=4)
            ref = jpvr.mask_repair_ref(jnp.asarray(ya), jnp.asarray(keys),
                                       jnp.asarray(coeff), word_bits=bits)
            got = tmw.mask_repair(yt, _u32(keys), torch.from_numpy(coeff))
            assert got.dtype == yt.dtype and got is not yt
            np.testing.assert_array_equal(_u(got), _u(want))
            np.testing.assert_array_equal(_u(got), _u(ref))
            np.testing.assert_array_equal(
                _u(tpvr.mask_repair_ref(yt, _u32(keys),
                                        torch.from_numpy(coeff),
                                        word_bits=bits)), _u(ref))
            if not coeff.any():
                np.testing.assert_array_equal(_u(got), _u(yt))
    none = torch.zeros(0, dtype=torch.uint32)
    assert tmw.mask_repair(yt, none, torch.zeros(0, dtype=torch.int32)) is yt
    for bad in (lambda: tmw.mask_repair(yt, none[:0], torch.zeros(1).int()),
                lambda: tmw.mask_repair(yt.view(torch.int16 if bits == 16
                                                else torch.int32),
                                        none, none.view(torch.int32)),
                lambda: tmw.mask_repair(yt[:, :256].contiguous(), none,
                                        none.view(torch.int32))):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("r", [3, 8, 64])
@pytest.mark.parametrize("p", [1, 3, 9, 45])
def test_mask_repair_out_forms_match_pallas(bits, r, p):
    # In place (out=y), into a given buffer, and write-only (y None: the
    # repair term alone, held to the Pallas kernel on a zero row), with no
    # live pair, one and all, through the wrapper and through ops.
    rng = np.random.default_rng(bits * r + p)
    ya, yt = _words(rng, (r, 512), bits)
    keys = rng.integers(0, 1 << 32, p, dtype=np.uint64).astype(np.uint32)
    one = np.zeros(p, np.int32)
    one[rng.integers(p)] = rng.choice([-1, 1])
    zero = jnp.zeros_like(jnp.asarray(ya))
    for coeff in (np.zeros(p, np.int32), one,
                  rng.choice([-2, -1, 1, 2], p).astype(np.int32)):
        jk, jc = jnp.asarray(keys), jnp.asarray(coeff)
        want = _u(jmw.mask_repair_2d(jnp.asarray(ya), jk, jc,
                                     interpret=True))
        term = _u(jmw.mask_repair_2d(zero, jk, jc, interpret=True))
        tk, tc = _u32(keys), torch.from_numpy(coeff)
        for repair in (tmw.mask_repair, tops.flat_mask_repair):
            inplace = yt.clone()
            assert repair(inplace, tk, tc, out=inplace) is inplace
            np.testing.assert_array_equal(_u(inplace), want)
            out = torch.full_like(yt, 7)
            assert repair(yt, tk, tc, out=out) is out
            np.testing.assert_array_equal(_u(out), want)
            np.testing.assert_array_equal(_u(yt), _u(ya))
            alone = torch.full_like(yt, 7)
            assert repair(None, tk, tc, out=alone) is alone
            np.testing.assert_array_equal(_u(alone), term)
        np.testing.assert_array_equal(
            _u(tmw.mask_repair_plain(None, tk, tc, out=torch.full_like(
                yt, 7))), term)
    with pytest.raises(ValueError):
        tmw.mask_repair(None, _u32(keys), torch.from_numpy(one))
    with pytest.raises(ValueError):
        tmw.mask_repair(yt, _u32(keys), torch.from_numpy(one),
                        out=torch.empty((r, 256), dtype=yt.dtype))


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("t", [1, 2])
def test_masked_master_over_c_rows_matches_pallas(bits, t):
    # The tree's root: C = 3 word rows beside a 10-row pilot stack.
    rng = np.random.default_rng(bits + t)
    n, c, r = 10, 3, 8
    q = rng.standard_normal((n, r, 512), dtype=np.float32) * 0.05
    p1 = rng.standard_normal((r, 512), dtype=np.float32) * 0.05
    p2 = p1 + rng.standard_normal((r, 512), dtype=np.float32) * 0.01
    ya, yt = _words(rng, (c, r, 512), bits)
    sum_wq = np.uint32(rng.integers(0, 1 << 14))
    spec = TSpec(modulus_bits=bits, dp_epsilon=2.0)
    for k in (0, 7, 9):
        want = jmw.masked_master_update_2d(
            jnp.asarray(q[k]), jnp.asarray(ya), jnp.asarray(sum_wq),
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(t, jnp.int32),
            0.01, spec.scale_mult, interpret=True, block_rows=r,
            block_workers=1)
        got = tmw.masked_master_update(
            torch.from_numpy(q), torch.tensor(k), yt,
            tpvm.to_words(torch.tensor(int(sum_wq)), 32),
            torch.from_numpy(p1), torch.from_numpy(p2),
            torch.tensor(t, dtype=torch.int32), 0.01, spec.scale_mult)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# -- round level: the fault branches of WirePath -----------------------------

def _history(rng, n):
    p1 = rng.standard_normal((ROWS, 128), dtype=np.float32) * 0.05
    p2 = p1 + rng.standard_normal((ROWS, 128), dtype=np.float32) * 0.01
    bufs = p1[None] + rng.standard_normal((n, ROWS, 128),
                                          dtype=np.float32) * 0.02
    return bufs, p1, p2


def _wires(bits, fanout, plan, *, seed=5, threshold=2, dp=None):
    kw = dict(mask_seed=seed, modulus_bits=bits, recovery_threshold=threshold,
              dp_epsilon=dp, enforce=False)
    jw = jrd.WirePath(jrd.WireConfig(), interpret=True, block_workers=1,
                      privacy=None if bits is None else JSpec(**kw),
                      tree=None if fanout is None else JTree(fanout),
                      faults=None if plan is None else JPlan(**plan))
    tw = trd.WirePath(trd.WireConfig(), block_workers=1,
                      privacy=None if bits is None else TSpec(**kw),
                      tree=None if fanout is None else TTree(fanout),
                      faults=None if plan is None else tft.FaultPlan(**plan))
    return jw, tw


@pytest.mark.parametrize("bits,fanout,n", [(16, 4, 10), (32, 4, 10),
                                           (16, None, 8), (32, None, 8),
                                           (32, 2, 7), (16, 3, 9)])
def test_round_from_stacked_with_deaths_bitwise(bits, fanout, n):
    rng = np.random.default_rng(n + bits)
    bufs, p1, p2 = _history(rng, n)
    jw, tw = _wires(bits, fanout, None)
    sizes = np.arange(1, n + 1, dtype=np.float32)
    alive = np.ones(n, np.float32)
    alive[[1, n - 2]] = 0.0                 # deaths in two groups
    drop = np.ones(n, np.float32)
    drop[-(fanout or 2):] = 0.0             # the last subtree sits out
    for t in (1, 3):
        for pmask in (None, drop):
            jt = jnp.asarray(t, jnp.int32)
            jpm = None if pmask is None else jnp.asarray(pmask)
            tpm = None if pmask is None else torch.from_numpy(pmask)
            w = jw.weights(jnp.asarray(sizes / sizes.sum()), 0, jt, mask=jpm)
            jnew, jy = jw.round_from_stacked(
                jnp.asarray(bufs), 0, w, jnp.asarray(p1), jnp.asarray(p2),
                t=jt, pmask=jpm, alive=jnp.asarray(alive))
            y_in = torch.from_numpy(bufs)
            tnew, ty = tw.round_from_stacked(
                y_in, torch.tensor(0), torch.from_numpy(np.array(w)),
                torch.from_numpy(p1), torch.from_numpy(p2),
                t=torch.tensor(t, dtype=torch.int32), pmask=tpm,
                alive=torch.from_numpy(alive))
            np.testing.assert_array_equal(_bits(tnew.numpy()), _bits(jnew))
            np.testing.assert_array_equal(_u(ty), _u(jy))


@pytest.mark.parametrize("bits,fanout", [(16, 4), (32, None), (None, 4),
                                         (None, None)])
def test_round_step_chain_with_faults_bitwise(bits, fanout):
    n = 10
    plan = dict(seed=3, drop_before_uplink=0.1, drop_after_uplink=0.25,
                straggler=0.1)
    rng = np.random.default_rng(21)
    _, p1, _ = _history(rng, n)
    jw, tw = _wires(bits, fanout, plan, dp=2.0 if bits == 16 else None)
    js = jrd.init_round_state({"w": jnp.asarray(p1)}, n, privacy=jw.privacy,
                              telemetry=False)
    ts = trd.init_round_state(params_from_numpy({"w": p1}, device="cpu"), n,
                              privacy=tw.privacy, device="cpu")
    sizes = rng.integers(100, 900, n).astype(np.float32)
    dead = 0
    for mask in (None, np.array([1, 1, 0, 1, 1, 1, 1, 0, 1, 1], np.float32),
                 None, None):
        bufs = (np.asarray(js.buf_p1)[None]
                + rng.standard_normal((n, ROWS, 128), dtype=np.float32) * .02)
        costs = rng.random(n, dtype=np.float32) + 0.5
        kw = {} if mask is None else {"mask": jnp.asarray(mask)}
        js, jnew, jinfo = jw.round_step(js, jnp.asarray(bufs),
                                        jnp.asarray(costs),
                                        jnp.asarray(sizes), **kw)
        ts, tnew, tinfo = tw.round_step(
            ts, torch.from_numpy(bufs), torch.from_numpy(costs),
            torch.from_numpy(sizes),
            mask=None if mask is None else torch.from_numpy(mask))
        assert int(tinfo["k_star"]) == int(jinfo["k_star"])
        np.testing.assert_array_equal(tinfo["alive"].numpy(),
                                      np.asarray(jinfo["alive"]))
        dead += int((tinfo["alive"] == 0).sum())
        np.testing.assert_array_equal(_bits(tnew.numpy()), _bits(jnew))
        for name in ("buf_p1", "buf_p2", "prev_costs"):
            np.testing.assert_array_equal(_bits(getattr(ts, name).numpy()),
                                          _bits(getattr(js, name)))
    assert dead > 0


@pytest.mark.parametrize("bits,fanout", [(16, 4), (32, 4), (16, None)])
def test_repaired_round_equals_survivors_only_round(bits, fanout):
    # The contract of tests/test_fault_recovery.py: the repaired masked
    # round is the no-fault round whose participation mask is the
    # effective survivor set.
    n = 8
    rng = np.random.default_rng(5)
    bufs, p1, p2 = _history(rng, n)
    plan = tft.FaultPlan(seed=3, drop_after_uplink=0.3)
    _, tw = _wires(bits, fanout, dict(seed=3, drop_after_uplink=0.3))
    _, clean = _wires(bits, fanout, None)
    st = trd.RoundState(torch.from_numpy(p1), torch.from_numpy(p2),
                        torch.linspace(1.0, 2.0, n),
                        torch.tensor(2, dtype=torch.int32))
    costs = torch.from_numpy(rng.random(n, dtype=np.float32))
    sizes = torch.arange(1.0, n + 1.0)
    _, out_f, info = tw.round_step(st, torch.from_numpy(bufs), costs, sizes)
    alive = plan.alive(2, n)
    assert torch.equal(info["alive"], alive) and 0 < alive.sum() < n
    eff, _ = tpvr.effective_masks(None, alive, 2, fanout, n)
    _, out_ref, _ = clean.round_step(st, torch.from_numpy(bufs), costs,
                                     sizes, mask=eff)
    assert torch.equal(out_f.view(torch.int32), out_ref.view(torch.int32))


def test_masked_faults_require_recovery_threshold():
    _, tw = _wires(16, None, dict(seed=3, drop_after_uplink=0.3),
                   threshold=None)
    n = 4
    st = trd.init_round_state({"w": torch.zeros(ROWS * 128)}, n,
                              device="cpu")
    with pytest.raises(ValueError, match="recovery_threshold"):
        tw.round_step(st, torch.zeros((n, ROWS, 128)), torch.ones(n),
                      torch.ones(n))


# -- the simulator -----------------------------------------------------------

def _federation(data, split, loaders, cfgs, worker, lag, n):
    x, y = data(n_samples=1600, n_features=24, n_classes=6, seed=0).generate()
    splits = split(y, n_workers=n, seed=1)
    lds = loaders((x, y), splits, seed=2)
    wcfg = cfgs(n, [len(s) for s in splits], seed=3)
    return [worker(cfg=wcfg[k], loader=lds[k], loss_and_grad=lag)
            for k in range(n)]


@pytest.mark.parametrize("spec_kw,fanout", [
    ({"dp_epsilon": 2.0, "recovery_threshold": 2}, 4),
    (None, None)])
def test_quickstart_federation_with_faults_matches(spec_kw, fanout):
    n = 8
    plan = dict(seed=3, drop_before_uplink=0.1, drop_after_uplink=0.25,
                straggler=0.1)
    jparams = j_init(jax.random.PRNGKey(0), 24, 6)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    jw = _federation(JData, j_split, j_loaders, j_cfgs, JWorker, j_lag, n)
    tw = _federation(TData, t_split, t_loaders, t_cfgs, TWorker, t_lag, n)
    jcfg = JCfg(n_workers=n, faults=JPlan(**plan),
                privacy=None if spec_kw is None
                else JSpec(enforce=False, **spec_kw),
                tree=None if fanout is None else JTree(fanout))
    tcfg = TCfg(n_workers=n, faults=tft.FaultPlan(**plan),
                privacy=None if spec_kw is None
                else TSpec(enforce=False, **spec_kw),
                tree=None if fanout is None else TTree(fanout))
    jsim = JSim(jw, jparams, jcfg)
    jres = jsim.run_fedpc(rounds=4, wire_block_workers=1)
    tsim = TSim(tw, params_from_numpy(params_np, device="cpu"), tcfg,
                device="cpu")
    tres = tsim.run_fedpc(rounds=4, wire_block_workers=1)
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    assert tres.recovery_bytes_per_round == list(
        jres.recovery_bytes_per_round)
    assert tsim.ledger.events == jsim.ledger.events
    kinds = {k for (_, _, k, _) in tsim.ledger.events}
    if spec_kw is not None:
        assert {"seed_shares", "mask_recovery"} <= kinds
        assert int(tres.round_state.accountant.spent_rounds) == 4
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-3)
    for a, b in zip(tree_leaves(tres.params),
                    jax.tree_util.tree_leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)


def test_partial_participation_and_enforce_still_refused():
    # Partial participation on the faulty plain tree runs: the JAX
    # simulator's pilots, bytes and ledger from the same schedule. So does
    # the enforced masked tree under the same faults (enforce=True, the
    # default): the round program is audited once before round 1, and the
    # ledger records the JAX simulator's audit.
    n = 4
    jparams = j_init(jax.random.PRNGKey(0), 24, 6)
    tw = _federation(TData, t_split, t_loaders, t_cfgs, TWorker, t_lag, n)
    jw = _federation(JData, j_split, j_loaders, j_cfgs, JWorker, j_lag, n)
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jparams), device="cpu")
    plan = dict(seed=1, drop_before_uplink=0.2, drop_after_uplink=0.2)
    cfg = TCfg(n_workers=n, tree=TTree(2), faults=tft.FaultPlan(**plan))
    jsim = JSim(jw, jparams, JCfg(n_workers=n, tree=JTree(2),
                                  faults=JPlan(**plan)))
    jres = jsim.run_fedpc(rounds=3, participation=0.5, participation_seed=2)
    tsim = TSim(tw, params, cfg, device="cpu")
    tres = tsim.run_fedpc(rounds=3, participation=0.5, participation_seed=2)
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    assert tsim.ledger.events == jsim.ledger.events
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-3)
    tw = _federation(TData, t_split, t_loaders, t_cfgs, TWorker, t_lag, n)
    jw = _federation(JData, j_split, j_loaders, j_cfgs, JWorker, j_lag, n)
    jsim = JSim(jw, jparams, JCfg(n_workers=n, tree=JTree(2),
                                  faults=JPlan(**plan),
                                  privacy=JSpec(recovery_threshold=2)))
    jres = jsim.run_fedpc(rounds=3, participation=0.5, participation_seed=2,
                          wire_block_workers=1)
    tsim = TSim(tw, params, TCfg(
        n_workers=n, tree=TTree(2), faults=tft.FaultPlan(**plan),
        privacy=TSpec(recovery_threshold=2)), device="cpu")
    tres = tsim.run_fedpc(rounds=3, participation=0.5, participation_seed=2,
                          wire_block_workers=1)
    assert tsim.ledger.audits == jsim.ledger.audits == [
        {"runtime": "run_fedpc", "boundary": "round-step",
         "n_launches": TTree(2).launches(n) + 1, "masked": True}]
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    assert tsim.ledger.events == jsim.ledger.events
