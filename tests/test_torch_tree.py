"""The port's tree aggregation against ``repro.core.tree``,
``repro.privacy.masking``, ``repro.kernels.partial_sum`` and the tree
branches of ``repro.fed.rounds`` / ``repro.fed.simulator``.

Everything integer is held bitwise: the ``TreeSpec`` algebra, the tree
byte model, the level seeds, scoped signs and activity folds, the plain
twins of the two partial-sum kernels against the Pallas kernels in
interpret mode (``block_groups=1``, so each compile takes seconds), and
``WirePath.round_from_stacked`` / ``round_step`` on the plain and the
masked tree at both moduli. The simulator on the quickstart federation
picks the same pilots and books the same bytes; costs and params agree
within the ``rtol=1e-3`` that ``test_torch_sim`` explains.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol as jproto
from repro.core.fedpc import FedPCConfig as JCfg
from repro.core.tree import TreeSpec as JTree
from repro.data.pipeline import federated_loaders as j_loaders
from repro.data.synthetic import SyntheticClassification as JData
from repro.data.synthetic import random_share_split as j_split
from repro.fed import rounds as jrd
from repro.fed.simulator import FedSimulator as JSim
from repro.fed.worker import Worker as JWorker
from repro.fed.worker import make_worker_configs as j_cfgs
from repro.kernels import ops as jops
from repro.models.mlp import init_mlp_classifier as j_init
from repro.models.mlp import mlp_loss_and_grad as j_lag
from repro.privacy import masking as jpvm
from repro.privacy.spec import PrivacySpec as JSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core import protocol as tproto
from repro_torch.core.fedpc import FedPCConfig as TCfg
from repro_torch.core.tree import TreeSpec as TTree
from repro_torch.data.pipeline import federated_loaders as t_loaders
from repro_torch.data.synthetic import SyntheticClassification as TData
from repro_torch.data.synthetic import random_share_split as t_split
from repro_torch.fed import rounds as trd
from repro_torch.fed.simulator import FedSimulator as TSim
from repro_torch.fed.worker import Worker as TWorker
from repro_torch.fed.worker import make_worker_configs as t_cfgs
from repro_torch.kernels import partial_sum as tps
from repro_torch.models.mlp import mlp_loss_and_grad as t_lag
from repro_torch.privacy import masking as tpvm
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


# -- TreeSpec, the byte model, the tree mask functions -----------------------

@pytest.mark.parametrize("fanout,levels", [(2, None), (3, None), (4, None),
                                           (8, None), (2, 3), (4, 1)])
def test_treespec_algebra_matches(fanout, levels):
    jt, tt = JTree(fanout, levels), TTree(fanout, levels)
    for n in (1, 2, 5, 7, 10, 16, 17, 64, 65):
        assert tt.n_levels(n) == jt.n_levels(n)
        assert tt.level_widths(n) == jt.level_widths(n)
        assert tt.launches(n) == jt.launches(n)
        for lvl in range(len(jt.level_widths(n))):
            assert tt.sibling_size(lvl, n) == jt.sibling_size(lvl, n)
        for bits in (None, 16, 32):
            assert (tproto.fedpc_tree_bytes_per_round(
                84e6, n, fanout, levels=levels, word_bits=bits)
                == jproto.fedpc_tree_bytes_per_round(
                    84e6, n, fanout, levels=levels, word_bits=bits))
    with pytest.raises(ValueError):
        TTree(1)
    with pytest.raises(ValueError):
        TTree(2, levels=0)


def test_recovery_byte_models_match():
    for n, g, deaths, thr in ((10, None, 2, 2), (10, 4, 1, 3), (7, 2, 3, 2)):
        assert (tproto.recovery_dealing_bytes_per_round(n, g)
                == jproto.recovery_dealing_bytes_per_round(n, g))
        assert (tproto.recovery_reconstruction_bytes(deaths, thr, g,
                                                     n_workers=n)
                == jproto.recovery_reconstruction_bytes(deaths, thr, g,
                                                        n_workers=n))
    with pytest.raises(ValueError):
        tproto.recovery_reconstruction_bytes(1, 2)


def test_tree_mask_functions_match():
    for seed in (0, 5, 0xFFFFFFFF):
        for level in range(4):
            assert tpvm.tree_level_seed(seed, level) == int(
                np.asarray(jpvm.tree_level_seed(seed, level)))
    rng = np.random.default_rng(0)
    for n, sib in ((1, 2), (5, 2), (8, 4), (10, 4), (7, 3), (6, 6)):
        part = (rng.random(n) < 0.6).astype(np.float32)
        for p in (None, part):
            got = tpvm.tree_pair_signs(
                n, sib, participation=None if p is None
                else torch.from_numpy(p))
            want = jpvm.tree_pair_signs(
                n, sib, participation=None if p is None else jnp.asarray(p))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for fanout in (2, 3, 4):
            np.testing.assert_array_equal(
                tpvm.tree_activity(torch.from_numpy(part), fanout).numpy(),
                np.asarray(jpvm.tree_activity(jnp.asarray(part), fanout)))


# -- kernels #9 and #10: plain twins against the Pallas kernels -------------

@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("c,fanout", [(5, 2), (7, 4), (10, 4), (8, 8),
                                      (7, 3)])
def test_partial_sum_twin_matches_pallas(bits, c, fanout):
    rng = np.random.default_rng(c * fanout + bits)
    r = 8
    packed = rng.integers(0, 256, (c, r, 128), dtype=np.uint8)
    wq = rng.integers(0, 1 << (14 if bits == 16 else 24), c).astype(
        np.uint32)
    want = jops.flat_partial_sum(jnp.asarray(packed), jnp.asarray(wq),
                                 fanout=fanout, word_bits=bits,
                                 interpret=True, block_groups=1)
    got = tps.partial_sum(torch.from_numpy(packed),
                          torch.from_numpy(wq.view(np.int32)).view(
                              torch.uint32), fanout=fanout, word_bits=bits)
    assert got.dtype == (torch.uint16 if bits == 16 else torch.uint32)
    assert got.shape == (-(-c // fanout), r, 512)
    np.testing.assert_array_equal(_u(got), _u(want))


def _level_keys(g, sib, seed, t, act):
    keys = jpvm.pair_stream_keys(jpvm.tree_level_seed(seed, 1), g, t)
    signs = jpvm.tree_pair_signs(g, sib, participation=act)
    return keys, signs


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("c,fanout,sib", [(4, 4, 1), (4, 2, 2), (9, 3, 3),
                                          (10, 2, 2), (10, 2, 5), (7, 4, 2)])
def test_masked_partial_sum_twin_matches_pallas(bits, c, fanout, sib):
    # G = ceil(C / fanout) in {1, 2, 3, 5}, sibling below and equal to G,
    # masks on and off, with and without a participation fold.
    rng = np.random.default_rng(c + 10 * fanout + bits)
    r = 8
    g = -(-c // fanout)
    dt = np.uint16 if bits == 16 else np.uint32
    words = rng.integers(0, 1 << bits, (c, r, 512), dtype=np.uint64).astype(
        dt)
    t = jnp.asarray(3, jnp.int32)
    act = (rng.random(g) < 0.7).astype(np.float32)
    for a in (None, act):
        keys, signs = _level_keys(g, sib, 7, t,
                                  None if a is None else jnp.asarray(a))
        for use_masks in (True, False):
            want = jops.flat_masked_partial_sum(
                jnp.asarray(words), keys, signs, fanout=fanout, sibling=sib,
                use_masks=use_masks, interpret=True, block_groups=1)
            tw = torch.from_numpy(words.view(np.int16 if bits == 16
                                             else np.int32)).view(
                torch.uint16 if bits == 16 else torch.uint32)
            got = tps.masked_partial_sum(
                tw, tpvm.to_words(torch.from_numpy(_u(keys)), 32),
                torch.from_numpy(np.array(signs)), fanout=fanout,
                sibling=sib, use_masks=use_masks)
            assert got.dtype == tw.dtype
            np.testing.assert_array_equal(_u(got), _u(want))


def test_partial_sum_wrappers_refuse_what_the_kernels_do_not_take():
    packed = torch.zeros((5, 8, 128), dtype=torch.uint8)
    wq = torch.zeros(5, dtype=torch.uint32)
    for bad in (lambda: tps.partial_sum(packed, wq[:4], fanout=2),
                lambda: tps.partial_sum(packed.view(torch.int8), wq,
                                        fanout=2),
                lambda: tps.partial_sum(packed, wq, fanout=0),
                lambda: tps.partial_sum(packed, wq, fanout=2, word_bits=8),
                lambda: tps.partial_sum(packed[:, :, :64], wq, fanout=2)):
        with pytest.raises(ValueError):
            bad()
    words = torch.zeros((5, 8, 512), dtype=torch.uint16)
    keys = torch.zeros((3, 3), dtype=torch.uint32)
    signs = torch.zeros((3, 3), dtype=torch.int32)
    for bad in (lambda: tps.masked_partial_sum(words, keys[:2, :2],
                                               signs[:2, :2], fanout=2,
                                               sibling=3),
                lambda: tps.masked_partial_sum(words.view(torch.int16), keys,
                                               signs, fanout=2, sibling=3),
                lambda: tps.masked_partial_sum(words, keys, signs.float(),
                                               fanout=2, sibling=3),
                lambda: tps.masked_partial_sum(words, keys, signs, fanout=2,
                                               sibling=0),
                lambda: tps.masked_partial_sum(words[:0], keys, signs,
                                               fanout=2, sibling=3)):
        with pytest.raises(ValueError):
            bad()


# -- round level: the tree branches of WirePath ------------------------------

def _history(rng, n):
    p1 = rng.standard_normal((ROWS, 128), dtype=np.float32) * 0.05
    p2 = p1 + rng.standard_normal((ROWS, 128), dtype=np.float32) * 0.01
    bufs = p1[None] + rng.standard_normal((n, ROWS, 128),
                                          dtype=np.float32) * 0.02
    return bufs, p1, p2


def _wires(fanout, bits, *, renorm=False):
    jspec = tspec = None
    if bits is not None:
        jspec = JSpec(modulus_bits=bits, dp_epsilon=2.0, enforce=False)
        tspec = TSpec(modulus_bits=bits, dp_epsilon=2.0, enforce=False)
    jw = jrd.WirePath(jrd.WireConfig(), interpret=True, block_workers=1,
                      privacy=jspec, renorm_shares=renorm,
                      tree=JTree(fanout))
    tw = trd.WirePath(trd.WireConfig(), block_workers=1, privacy=tspec,
                      renorm_shares=renorm, tree=TTree(fanout))
    return jw, tw


@pytest.mark.parametrize("bits,fanout,n", [(None, 2, 7), (None, 4, 10),
                                           (None, 3, 5), (16, 2, 7),
                                           (16, 4, 10), (32, 3, 5)])
def test_tree_round_from_stacked_bitwise(bits, fanout, n):
    rng = np.random.default_rng(n + fanout)
    bufs, p1, p2 = _history(rng, n)
    jw, tw = _wires(fanout, bits)
    sizes = np.arange(1, n + 1, dtype=np.float32)
    drop = np.ones(n, np.float32)
    drop[:fanout] = 0.0                   # the first subtree sits out
    for t in (1, 3):
        for pmask in (None, drop):
            k = 1 if pmask is None else fanout
            jt = jnp.asarray(t, jnp.int32)
            w = jw.weights(jnp.asarray(sizes / sizes.sum()), k, jt,
                           mask=None if pmask is None
                           else jnp.asarray(pmask))
            kw = {} if pmask is None else {"pmask": jnp.asarray(pmask)}
            jnew, jwire = jw.round_from_stacked(
                jnp.asarray(bufs), k, w, jnp.asarray(p1), jnp.asarray(p2),
                t=jt, **kw)
            tkw = {} if pmask is None else {"pmask": torch.from_numpy(pmask)}
            tnew, twire = tw.round_from_stacked(
                torch.from_numpy(bufs), torch.tensor(k),
                torch.from_numpy(np.array(w)), torch.from_numpy(p1),
                torch.from_numpy(p2), t=torch.tensor(t, dtype=torch.int32),
                **tkw)
            np.testing.assert_array_equal(_bits(tnew.numpy()), _bits(jnew))
            np.testing.assert_array_equal(_u(twire), _u(jwire))


def test_dropped_subtree_partial_is_exactly_zero():
    rng = np.random.default_rng(2)
    n = 8
    bufs, p1, p2 = _history(rng, n)
    mask = torch.tensor([1, 1, 1, 1, 0, 0, 0, 0], dtype=torch.float32)
    sizes = torch.arange(1.0, n + 1.0)
    for bits in (16, 32):
        tw = trd.WirePath(privacy=TSpec(modulus_bits=bits, enforce=False),
                          tree=TTree(fanout=2))
        t = torch.tensor(3, dtype=torch.int32)
        w = tw.weights(sizes / sizes.sum(), 0, t, mask=mask)
        y, _ = tw.uplink_masked(torch.from_numpy(bufs), torch.from_numpy(p1),
                                torch.from_numpy(p2), t=t, w=w, pmask=mask)
        top = tw._tree_fold_masked(y, t=t, pmask=mask)
        assert top.shape[0] == 2
        assert not _u(top[1]).any()
        assert _u(top[0]).any()


@pytest.mark.parametrize("bits", [None, 16])
def test_tree_round_step_chain_bitwise(bits):
    n, fanout = 7, 2
    rng = np.random.default_rng(11)
    bufs, p1, _ = _history(rng, n)
    jw, tw = _wires(fanout, bits, renorm=True)
    jspec = jw.privacy
    params = {"w": p1}
    js = jrd.init_round_state({"w": jnp.asarray(p1)}, n, privacy=jspec,
                              telemetry=False)
    ts = trd.init_round_state(params_from_numpy(params, device="cpu"), n,
                              privacy=tw.privacy, device="cpu")
    sizes = rng.integers(100, 900, n).astype(np.float32)
    masks = [None, np.array([1, 0, 1, 1, 1, 1, 0], np.float32), None]
    for mask in masks:
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
        np.testing.assert_array_equal(_bits(tnew.numpy()), _bits(jnew))
        for name in ("buf_p1", "buf_p2", "prev_costs"):
            np.testing.assert_array_equal(_bits(getattr(ts, name).numpy()),
                                          _bits(getattr(js, name)))


@pytest.mark.parametrize("bits", [None, 16, 32])
def test_tree_equals_one_group_tree(bits):
    # The plain tree rides the integer wire and the masked tree cancels
    # its masks exactly: every fanout gives the bits of a tree of one
    # group (fanout >= N), the flat integer comparator.
    rng = np.random.default_rng(4)
    n = 10
    bufs, p1, p2 = _history(rng, n)
    spec = None if bits is None else TSpec(modulus_bits=bits,
                                           enforce=False)
    t = torch.tensor(3, dtype=torch.int32)
    k = torch.tensor(2)
    outs = []
    for fanout in (2, 3, 4, 16):
        tw = trd.WirePath(privacy=spec, tree=TTree(fanout))
        sizes = torch.arange(1.0, n + 1.0)
        w = tw.weights(sizes / sizes.sum(), k, t)
        outs.append(tw.round_from_stacked(
            torch.from_numpy(bufs), k, w, torch.from_numpy(p1),
            torch.from_numpy(p2), t=t)[0])
    for o in outs[1:]:
        assert torch.equal(o.view(torch.int32), outs[0].view(torch.int32))


# -- the simulator -----------------------------------------------------------

def _federation(data, split, loaders, cfgs, worker, lag, n=5):
    x, y = data(n_samples=1500, n_features=24, n_classes=6, seed=0).generate()
    splits = split(y, n_workers=n, seed=1)
    lds = loaders((x, y), splits, seed=2)
    wcfg = cfgs(n, [len(s) for s in splits], seed=3)
    return [worker(cfg=wcfg[k], loader=lds[k], loss_and_grad=lag)
            for k in range(n)]


@pytest.mark.parametrize("spec_kw", [None, {"dp_epsilon": 2.0}])
def test_quickstart_federation_with_tree_matches(spec_kw):
    n, fanout = 5, 2
    jparams = j_init(jax.random.PRNGKey(0), 24, 6)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    jw = _federation(JData, j_split, j_loaders, j_cfgs, JWorker, j_lag, n)
    tw = _federation(TData, t_split, t_loaders, t_cfgs, TWorker, t_lag, n)
    jspec = None if spec_kw is None else JSpec(enforce=False, **spec_kw)
    tspec = None if spec_kw is None else TSpec(enforce=False, **spec_kw)
    jres = JSim(jw, jparams, JCfg(n_workers=n, privacy=jspec,
                                  tree=JTree(fanout))).run_fedpc(
        rounds=4, wire_block_workers=1)
    tsim = TSim(tw, params_from_numpy(params_np, device="cpu"),
                TCfg(n_workers=n, privacy=tspec, tree=TTree(fanout)),
                device="cpu")
    tres = tsim.run_fedpc(rounds=4, wire_block_workers=1)
    assert tres.pilot_history == jres.pilot_history
    assert tres.bytes_per_round == list(jres.bytes_per_round)
    assert tres.recovery_bytes_per_round == [0.0] * 4
    np.testing.assert_allclose(tres.costs, jres.costs, rtol=1e-3)
    for a, b in zip(tree_leaves(tres.params),
                    jax.tree_util.tree_leaves(jres.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)
