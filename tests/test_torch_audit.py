"""The port's §4.2 round-program audit against ``repro.privacy.audit``.

The same round programs go through both audits: the JAX package's traces
a jaxpr against ``ShapeDtypeStruct`` specs (Pallas in interpret mode, one
worker a block, as its own tests run it); the port's runs the program once
on ``meta`` tensors under the launch seam's recorder (``kernels.seam``).
Held: the plain, masked (16/32-bit, DP on), plain tree, masked tree and
masked-with-faults round programs pass both with equal reports (launch
counts included: every wire launches the same kernels in both packages);
each of the JAX tests' leaky programs, rebuilt through the seam, is
refused by both with the same ``match=``; the pilot slot the port's
masters declare is the only stacked float operand a master may take, and
the plain versions of #2 and #7 read nothing of the stack but the pilot's
row (the other rows NaN and garbage, bitwise the same output); the op
counts show 2 launches and no host sync a round, and a host sync where a
program has one. The example ``privacy_probes_torch.py --cpu`` runs.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as jfl
from repro.core.privacy import LeakageError as JLeakageError
from repro.core.tree import TreeSpec as JTree
from repro.fed import rounds as jrd
from repro.fed.faults import FaultPlan as JPlan
from repro.privacy import check_round_program as j_check
from repro.privacy.spec import PrivacySpec as JSpec
from repro.utils import HOST_SYNC_PRIMITIVES, jaxpr_primitive_counts
from repro_torch.convert import params_from_numpy
from repro_torch.core.privacy import LeakageError
from repro_torch.core.tree import TreeSpec as TTree
from repro_torch.fed import rounds as trd
from repro_torch.fed.faults import FaultPlan as TPlan
from repro_torch.kernels import fused_wire as fw
from repro_torch.kernels import masked_wire as mw
from repro_torch.kernels import seam
from repro_torch.privacy.audit import check_round_program as t_check
from repro_torch.privacy.spec import PrivacySpec as TSpec
from repro_torch.utils import HOST_SYNC_OPS, program_op_counts

ROOT = Path(__file__).resolve().parents[1]
# n != rows // 4: the stacked-float rule keys on shape[0] == n_workers, so
# an (8, 512) history slab at n = 8 would collide by coincidence.
N = 6
_PLAN = dict(seed=1, drop_after_uplink=0.3)


def _tree_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((41, 23), dtype=np.float32),
            "b": rng.standard_normal(23, dtype=np.float32)}


def _configs():
    """id → (WirePath keywords of each package, masked policy)."""
    return {
        "plain": ({}, {}, False),
        "masked16-dp": ({"privacy": JSpec(dp_epsilon=2.0)},
                        {"privacy": TSpec(dp_epsilon=2.0)}, True),
        "masked32": ({"privacy": JSpec(modulus_bits=32)},
                     {"privacy": TSpec(modulus_bits=32)}, True),
        "plain-tree": ({"tree": JTree(fanout=2)},
                       {"tree": TTree(fanout=2)}, False),
        "masked-tree": ({"privacy": JSpec(), "tree": JTree(fanout=2)},
                        {"privacy": TSpec(), "tree": TTree(fanout=2)}, True),
        "masked-tree-faults": (
            {"privacy": JSpec(recovery_threshold=2), "tree": JTree(2),
             "faults": JPlan(**_PLAN)},
            {"privacy": TSpec(recovery_threshold=2), "tree": TTree(2),
             "faults": TPlan(**_PLAN)}, True),
        "masked-faults": (
            {"privacy": JSpec(recovery_threshold=2, dp_epsilon=2.0),
             "faults": JPlan(**_PLAN)},
            {"privacy": TSpec(recovery_threshold=2, dp_epsilon=2.0),
             "faults": TPlan(**_PLAN)}, True),
    }


def _jax_round(jkw, n=N):
    tree = jax.tree_util.tree_map(jnp.asarray, _tree_np())
    state = jrd.init_round_state(tree, n, jfl.layout_of(tree),
                                 privacy=jkw.get("privacy"))
    wire = jrd.WirePath(jrd.WireConfig(), interpret=True, block_workers=1,
                        **jkw)
    sizes = jnp.linspace(20.0, 80.0, n)
    bufs = jax.ShapeDtypeStruct((n,) + state.buf_p1.shape, jnp.float32)
    costs = jax.ShapeDtypeStruct((n,), jnp.float32)
    return wire, state, bufs, costs, sizes


def _torch_round(tkw, n=N):
    state = trd.init_round_state(params_from_numpy(_tree_np(), device="cpu"),
                                 n, privacy=tkw.get("privacy"), device="cpu")
    wire = trd.WirePath(trd.WireConfig(), block_workers=1, **tkw)
    sizes = torch.linspace(20.0, 80.0, n)
    bufs = torch.empty((n,) + tuple(state.buf_p1.shape), device="meta")
    costs = torch.empty((n,), device="meta")
    return wire, state, bufs, costs, sizes


# -- the predicates ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "uint8",
                                   "int16", "uint16", "int32", "uint32",
                                   "int64", "bool"])
def test_predicates_equal_the_jax_predicates(dtype):
    from repro.privacy import audit as ja
    from repro_torch.privacy import audit as ta
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    assert ta._is_code_dtype(td) == ja._is_code_dtype(jd)
    assert ta.MASKED_WORD_DTYPES == ja.MASKED_WORD_DTYPES
    assert ta._SCALAR_PAYLOAD_MAX == ja._SCALAR_PAYLOAD_MAX == 8
    for shape in ((), (6,), (6, 8), (6, 9), (6, 2, 5), (5, 512), (6, 512),
                  (6, 6), (6, 7), (17, 17), (3, 3), (9,)):
        for n in (3, 6, 17):
            assert (ta._stacked_float_buffer(shape, td, n)
                    == ja._stacked_float_buffer(shape, jd, n)), (shape, n)
            assert (ta._stacked_mask_buffer(shape, td, n)
                    == ja._stacked_mask_buffer(shape, jd, n)), (shape, n)
        assert (ta._is_signed_int_buffer(shape, td)
                == ja._is_signed_int_buffer(shape, jd)), shape


# -- passing programs --------------------------------------------------------

@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("cfg", list(_configs()))
def test_round_programs_pass_with_the_jax_report(cfg, with_mask):
    jkw, tkw, masked = _configs()[cfg]
    jwire, jstate, jbufs, jcosts, jsizes = _jax_round(jkw)
    jmask = ({"mask": jax.ShapeDtypeStruct((N,), jnp.float32)}
             if with_mask else {})
    jrep = j_check(lambda s, b, c, **k: jwire.round_step(s, b, c, jsizes,
                                                         **k),
                   jstate, jbufs, jcosts, n_workers=N, masked=masked, **jmask)
    twire, tstate, tbufs, tcosts, tsizes = _torch_round(tkw)
    tmask = {"mask": torch.ones(N)} if with_mask else {}
    trep = t_check(twire.round_step, tstate, tbufs, tcosts, tsizes,
                   n_workers=N, masked=masked, **tmask)
    # The launch counts agree on every wire: plain and masked 2, a tree
    # levels + 2 (the plain tree's leaf level is partial_sum, its other
    # levels masked_partial_sum with masks off), and one more for the
    # repair under faults on the masked wire. The JAX trace counts both
    # branches of a lax.cond where the eager run counts one, but no
    # round program here launches under a cond.
    assert trep == jrep
    want = {"plain": 2, "masked16-dp": 2, "masked32": 2, "plain-tree": 4,
            "masked-tree": 4, "masked-tree-faults": 5, "masked-faults": 3}
    assert trep["n_launches"] == want[cfg]
    if "tree" in tkw:
        assert trep["n_launches"] == tkw["tree"].launches(N) + (
            "faults" in tkw)


def test_masked_tree_round_passes():
    # tests/test_tree_agg.py's audit: the masked tree at n = 6, fanout 2.
    n = 6
    wire, state, bufs, costs, sizes = _torch_round(
        {"privacy": TSpec(secure_agg=True), "tree": TTree(fanout=2)}, n)
    report = t_check(wire.round_step, state, bufs, costs, sizes,
                     n_workers=n, masked=True)
    assert report == {"boundary": "round-step",
                      "n_launches": TTree(fanout=2).launches(n),
                      "masked": True}


# -- leaky programs: both audits refuse them, with the same words ------------

def test_plaintext_wire_refused_under_masked_policy():
    jwire, jstate, jbufs, jcosts, jsizes = _jax_round({})
    twire, tstate, tbufs, tcosts, tsizes = _torch_round({})
    with pytest.raises(JLeakageError, match="plaintext"):
        j_check(lambda s, b, c: jwire.round_step(s, b, c, jsizes),
                jstate, jbufs, jcosts, n_workers=N, masked=True)
    with pytest.raises(LeakageError, match="plaintext"):
        t_check(twire.round_step, tstate, tbufs, tcosts, tsizes,
                n_workers=N, masked=True)
    # without the masked policy the plaintext wire is §4.2-legal
    report = t_check(twire.round_step, tstate, tbufs, tcosts, tsizes,
                     n_workers=N, masked=False)
    assert report["n_launches"] == 2


def _j_leaky_mask_round(bufs_q, masks, p1):
    from jax.experimental import pallas as pl

    def uplink(q_ref, m_ref, o_ref):
        o_ref[...] = q_ref[...].astype(jnp.uint32) + m_ref[...]

    y = pl.pallas_call(
        uplink, out_shape=jax.ShapeDtypeStruct(masks.shape, jnp.uint32),
        interpret=True)(bufs_q, masks)

    def master(y_ref, p_ref, o_ref):
        o_ref[...] = p_ref[...] - jnp.sum(y_ref[...], axis=0).astype(
            jnp.float32)

    return pl.pallas_call(
        master, out_shape=jax.ShapeDtypeStruct(p1.shape, jnp.float32),
        interpret=True)(y, p1)


def _t_leaky_mask_round(bufs_q, masks, p1):
    y = seam.run_plain("leaky_uplink", lambda q, m: q.to(torch.uint32) + m,
                       bufs_q, masks)
    return seam.run_plain("leaky_master",
                          lambda y, p: p - y.sum(0).to(torch.float32), y, p1)


def test_materialized_mask_into_uplink_refused():
    shape = (32, 128)
    jbuf = jax.ShapeDtypeStruct(shape, jnp.float32)
    jbufs = jax.ShapeDtypeStruct((N,) + shape, jnp.float32)
    jmasks = jax.ShapeDtypeStruct((N,) + shape, jnp.uint32)
    tbuf = torch.empty(shape)
    tbufs = torch.empty((N,) + shape)
    tmasks = torch.empty((N,) + shape, dtype=torch.uint32)
    with pytest.raises(JLeakageError, match="materialized mask"):
        j_check(_j_leaky_mask_round, jbufs, jmasks, jbuf, n_workers=N,
                masked=True)
    with pytest.raises(LeakageError, match="materialized mask"):
        t_check(_t_leaky_mask_round, tbufs, tmasks, tbuf, n_workers=N,
                masked=True)
    # the unmasked policy has no opinion about integer operands
    jrep = j_check(_j_leaky_mask_round, jbufs, jmasks, jbuf, n_workers=N,
                   masked=False)
    trep = t_check(_t_leaky_mask_round, tbufs, tmasks, tbuf, n_workers=N,
                   masked=False)
    assert trep == jrep == {"boundary": "round-step", "n_launches": 2,
                            "masked": False}


def test_stacked_float_into_master_refused():
    from jax.experimental import pallas as pl

    def j_leaky(bufs_q, p1, p2):
        def k(q_ref, o_ref):
            o_ref[...] = jnp.sum(q_ref[...], axis=0)

        return pl.pallas_call(
            k, out_shape=jax.ShapeDtypeStruct(p1.shape, jnp.float32),
            interpret=True)(bufs_q)

    def t_leaky(bufs_q, p1, p2):
        return seam.run_plain("leaky_master", lambda q: q.sum(0), bufs_q)

    shape = (32, 128)
    jbuf = jax.ShapeDtypeStruct(shape, jnp.float32)
    with pytest.raises(JLeakageError, match="worker axis"):
        j_check(j_leaky, jax.ShapeDtypeStruct((N,) + shape, jnp.float32),
                jbuf, jbuf, n_workers=N, masked=False)
    with pytest.raises(LeakageError, match="worker axis"):
        t_check(t_leaky, torch.empty((N,) + shape), torch.empty(shape),
                torch.empty(shape), n_workers=N, masked=False)


def test_smuggled_telemetry_float_refused():
    # examples/privacy_probes.py's probe 7 in both packages: the real
    # record passes, a per-worker float payload in the info dict does not.
    jwire, jstate, jbufs, jcosts, jsizes = _jax_round({"privacy": JSpec()})
    twire, tstate, tbufs, tcosts, tsizes = _torch_round(
        {"privacy": TSpec()})

    def j_step(s, b, c):
        new_s, new_buf, info = jwire.round_step(s, b, c, jsizes)
        return new_s, new_buf, {**info, "trace_payload": b.reshape(N, -1)}

    def t_step(s, b, c, sizes):
        new_s, new_buf, info = twire.round_step(s, b, c, sizes)
        return new_s, new_buf, {**info, "trace_payload": b.reshape(N, -1)}

    with pytest.raises(JLeakageError, match="per-worker float payload"):
        j_check(j_step, jstate, jbufs, jcosts, n_workers=N, masked=True)
    with pytest.raises(LeakageError,
                       match=r"per-worker float payload at \[2\]"
                             r"\['trace_payload'\]"):
        t_check(t_step, tstate, tbufs, tcosts, tsizes, n_workers=N,
                masked=True)
    # The state's (rows, 128) slabs ride a NamedTuple, not a dict: never
    # audited for (c), even where rows equals N.
    _, out = seam.record(twire.round_step, tstate, tbufs, tcosts, tsizes)
    assert sorted(out[2]) == ["costs", "goodness", "k_star", "telemetry"]


# -- the pilot slot -----------------------------------------------------------

def _pilot_read(q, k, p):
    return q.index_select(0, k.reshape(1))[0] + p


def _slot_program(extra_stack: bool, index_shape: tuple):
    def prog(bufs_q, p1):
        k = torch.zeros(index_shape, dtype=torch.int64, device=bufs_q.device)
        ops = (bufs_q, k, p1) + ((bufs_q * 2.0,) if extra_stack else ())
        return seam.run_plain(
            "master", lambda q, k, p, *_: _pilot_read(q, k.reshape(-1)[:1],
                                                      p),
            *ops, pilot=(0, 1))
    return prog


def test_pilot_slot_accepted_only_beside_a_0d_index():
    bufs, p1 = torch.empty((N, 32, 128)), torch.empty((32, 128))
    rep = t_check(_slot_program(False, ()), bufs, p1, n_workers=N)
    assert rep["n_launches"] == 1
    # A second stacked float operand is not the pilot's.
    with pytest.raises(LeakageError, match="worker axis"):
        t_check(_slot_program(True, ()), bufs, p1, n_workers=N)
    # A declared slot whose index is not 0-d is refused.
    with pytest.raises(LeakageError, match="worker axis.*no 0-d integer"):
        t_check(_slot_program(False, (N,)), bufs, p1, n_workers=N)


def test_round_masters_declare_their_pilot_slot():
    for _, tkw, _ in _configs().values():
        wire, state, bufs, costs, sizes = _torch_round(tkw)
        rec, _ = seam.record(wire.round_step, state, bufs, costs, sizes)
        master = rec.launches[-1]
        assert master.pilot == (0, 1)
        assert master.operands[0] == seam.Spec(
            (N, state.buf_p1.shape[0] // 4, 512), torch.float32)
        assert master.operands[1] == seam.Spec((), torch.int64)


def _poisoned(q, k_star, rng):
    """``q`` with every row but the pilot's NaN, inf or garbage."""
    bad = q.clone()
    n = q.shape[0]
    for i in range(n):
        if i != k_star:
            junk = torch.from_numpy(rng.standard_normal(
                q.shape[1:], dtype=np.float32) * 1e30)
            junk.view(-1)[::3] = float("nan")
            junk.view(-1)[1::7] = float("-inf")
            bad[i] = junk
    return bad


@pytest.mark.parametrize("t", [1, 2])
def test_masters_ignore_the_poisoned_rows_of_the_stack(t):
    rng = np.random.default_rng(5)
    n, r = 5, 8
    q = torch.from_numpy(rng.standard_normal((n, r, 512), dtype=np.float32))
    p1 = torch.from_numpy(rng.standard_normal((r, 512), dtype=np.float32))
    p2 = p1 + 0.01
    tt = torch.tensor(t, dtype=torch.int32)
    packed = torch.from_numpy(rng.integers(0, 256, (n, r, 128),
                                           dtype=np.uint8))
    w = torch.from_numpy(rng.random(n, dtype=np.float32))
    words = torch.from_numpy(rng.integers(0, 1 << 16, (3, r, 512)).astype(
        np.uint16))
    for k in (0, 3):
        ks = torch.tensor(k)
        bad = _poisoned(q, k, rng)
        outs = []
        for stack in (q, bad):
            outs.append((
                fw.packed_master_update(stack, ks, packed, w, p1, p2, tt,
                                        0.01),
                mw.masked_master_update(stack, ks, words,
                                        torch.tensor(7, dtype=torch.uint32),
                                        p1, p2, tt, 0.01, 2.0 ** -14)))
        for clean, poisoned in zip(*outs):
            assert bool(torch.isfinite(clean).all())
            assert torch.equal(clean.view(torch.int32),
                               poisoned.view(torch.int32))


# -- op counts ---------------------------------------------------------------

@pytest.mark.parametrize("cfg", ["plain", "masked16-dp", "masked32"])
def test_round_op_counts_two_launches_no_host_sync(cfg):
    jkw, tkw, _ = _configs()[cfg]
    wire, state, bufs, costs, sizes = _torch_round(tkw)
    counts = program_op_counts(wire.round_step, state, bufs, costs, sizes)
    launches = {k: v for k, v in counts.items() if k.startswith("launch:")}
    assert sum(launches.values()) == 2, counts
    assert not HOST_SYNC_OPS & set(counts), counts
    jwire, jstate, _, _, jsizes = _jax_round(jkw)
    jcounts = jaxpr_primitive_counts(
        lambda s, b, c: jwire.round_step(s, b, c, jsizes), jstate,
        jnp.zeros((N,) + jstate.buf_p1.shape), jnp.ones((N,)))
    assert jcounts.get("pallas_call") == sum(launches.values())
    assert not HOST_SYNC_PRIMITIVES & set(jcounts)


def test_op_counts_show_host_syncs():
    def prog(x):
        _ = x.sum().item()
        _ = x.cpu()
        _ = torch.nonzero(x > 0)
        return fw.ternary_pack_stacked(
            x, x[0], x[0], torch.ones((), dtype=torch.int32, device=x.device),
            torch.full((x.shape[0],), 0.2, device=x.device), 0.01)

    counts = program_op_counts(prog, torch.ones((3, 8, 512)))
    assert counts["aten::_local_scalar_dense"] == 1
    assert counts["to_host"] == 1
    assert counts["aten::nonzero"] == 1
    assert counts["launch:uplink_stacked"] == 1
    with pytest.raises(RuntimeError, match="syncs with the host"):
        t_check(prog, torch.ones((3, 8, 512)), n_workers=3)


def test_meta_refused_outside_a_recording():
    q = torch.empty((2, 8, 512), device="meta")
    p = torch.empty((8, 512), device="meta")
    with pytest.raises(ValueError, match="no wire kernel for device meta"):
        fw.ternary_pack_stacked(q, p, p, torch.ones((), dtype=torch.int32,
                                                    device="meta"),
                                torch.ones(2, device="meta"), 0.01)


# -- the example -------------------------------------------------------------

def test_privacy_probes_example_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "privacy_probes_torch.py"),
         "--cpu"], capture_output=True, text=True, env=env, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    for i in range(1, 8):
        assert f"probe {i} —" in text, text
    assert "modulus 16: full-cohort sum == unmasked sum: True" in text
    assert "modulus 32: full-cohort sum == unmasked sum: True" in text
    assert "audit passed: runtime=run_fedpc boundary=round-step" in text
    assert "recovered mask stream exact: True" in text
    assert "is refused (LeakageError): True" in text
    assert "passes the masked audit" in text
