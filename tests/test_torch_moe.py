"""The port's MoE feed-forward (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe`` on the same weights (carried across
with ``repro_torch.convert``) and the same tokens, at reduced
``deepseek-moe-16b`` (4 experts top-2, a shared expert) and ``grok-1-314b``
(4 experts top-2), float32.

Routing is discontinuous, so it is compared exactly: each assignment's
expert (``e_idx``), its position in that expert and whether it fits the
capacity (``keep``) equal the reference's routing, computed with its own
``lax.top_k`` and cumsum. Each case first checks that the gap between the
K-th and (K+1)-th router probability exceeds 1e-5 for every token, so a
mismatch is a fault and not a tie. The output within ``rtol=1e-4,
atol=1e-5`` and the auxiliaries within ``rtol=1e-5, atol=1e-6``, as the
model zoo's serving and loss checks. The gradients of a weighted sum of
the output (plus both auxiliaries) are compared raw, entries of order 1
summed over T tokens (the model zoo compares params after a step, a
hundredth of a mean's gradient), so within the serving tolerance: the
input's drift by up to 1.2e-6 on entries near 1e-3. Cases: a
prompt (T = 64 tokens), the decode size (T = B = 4, capacity at its floor
of top_k), and a capacity factor of 0.5 that drops assignments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import moe as jmoe
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.utils import tree_leaves

SERVE = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=1e-6)
CASES = [  # arch, (B, S), capacity factor
    ("deepseek-moe-16b", (2, 32), None),
    ("grok-1-314b", (2, 32), None),
    ("deepseek-moe-16b", (4, 1), None),
    ("grok-1-314b", (4, 1), None),
    ("deepseek-moe-16b", (2, 32), 0.5),
    ("grok-1-314b", (2, 32), 0.5),
]


def _cfgs(arch, cf):
    j, t = jget(arch).reduced(), tget(arch).reduced()
    if cf is not None:
        j, t = j.replace(capacity_factor=cf), t.replace(capacity_factor=cf)
    return j, t


def _jax_routing(p, cfg, x):
    """The reference's routing lines (moe.py, s_blk == 1): e_idx (T, K),
    pos and keep (T*K,)."""
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    _, e_idx = jax.lax.top_k(probs, cfg.top_k)
    flat_e = e_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot,
                              flat_e[:, None], axis=1)[:, 0]
    return probs, e_idx, pos, pos < jmoe.capacity(cfg, xf.shape[0])


@pytest.mark.parametrize("arch,shape,cf", CASES)
def test_moe_matches_the_reference(arch, shape, cf):
    jcfg, tcfg = _cfgs(arch, cf)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    x = np.random.default_rng(4).standard_normal(
        (*shape, jcfg.d_model)).astype(np.float32)
    probs, je, jpos, jkeep = _jax_routing(jp, jcfg, jnp.asarray(x))
    top = np.sort(np.asarray(probs), -1)[:, ::-1]
    gap = top[:, jcfg.top_k - 1] - top[:, jcfg.top_k]
    assert gap.min() > 1e-5, "a near-tie in the seed's routing"

    xt = torch.from_numpy(x)
    _, _, _, te, tpos, tkeep = tmoe.route(tp, tcfg, xt.reshape(-1, 256))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert tmoe.capacity(tcfg, xt.shape[0] * xt.shape[1]) == \
        jmoe.capacity(jcfg, x.shape[0] * x.shape[1])
    if cf is not None:
        assert not bool(tkeep.all())          # this case drops some
    if shape[1] == 1:
        assert tmoe.capacity(tcfg, shape[0]) == tcfg.top_k

    jy, jaux = jax.jit(lambda p, x: jmoe.moe(p, jcfg, x))(jp, jnp.asarray(x))
    ty, taux = tmoe.moe(tp, tcfg, xt)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **SERVE)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **LOSS)
    np.testing.assert_allclose(float(taux["drop_frac"]),
                               1.0 - float(np.mean(np.asarray(jkeep))),
                               **LOSS)

    w = np.random.default_rng(5).standard_normal(
        np.asarray(jy).shape).astype(np.float32)

    def jobj(p, x):
        y, aux = jmoe.moe(p, jcfg, x)
        return jnp.sum(y * w) + aux["load_balance"] + aux["z_loss"]

    jgp, jgx = jax.jit(jax.grad(jobj, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [a.clone().requires_grad_(True) for a in tree_leaves(tp)]
    keys = sorted(tp)
    tpl = dict(tp)
    it = iter(leaves)
    for k in keys:
        tpl[k] = ({kk: next(it) for kk in sorted(tp[k])}
                  if isinstance(tp[k], dict) else next(it))
    xg = xt.clone().requires_grad_(True)
    y, aux = tmoe.moe(tpl, tcfg, xg)
    ((y * torch.from_numpy(w)).sum() + aux["load_balance"]
     + aux["z_loss"]).backward()
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(jgx), **SERVE)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(jgp)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **SERVE)


def test_dropped_assignments_never_overwrite_a_kept_slot():
    # At capacity C every assignment past the C-th of its expert is sent
    # to (expert 0, slot C - 1) with a zero row: expert 0's last kept slot
    # still holds its own token's row.
    cfg = tget("grok-1-314b").reduced().replace(capacity_factor=0.5)
    jp = jmoe.init_moe(jget("grok-1-314b").reduced(), jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (64, cfg.d_model)).astype(np.float32))
    _, _, _, e_idx, pos, keep = tmoe.route(tp, cfg, x)
    C = tmoe.capacity(cfg, 64)
    flat_e = e_idx.reshape(-1)
    assert int((flat_e == 0).sum()) > C and not bool(keep.all())
    y, _ = tmoe.moe(tp, cfg, x[None])
    # the same tokens, with every dropped assignment's gate zeroed by hand
    # and the kept ones dispatched one at a time
    want = torch.zeros_like(x)
    gates = torch.softmax(x @ tp["router"], -1).gather(1, e_idx)
    gates = gates / gates.sum(-1, keepdim=True)
    for a in range(flat_e.numel()):
        if not keep[a]:
            continue
        t, e = a // cfg.top_k, int(flat_e[a])
        h = torch.nn.functional.silu(x[t] @ tp["experts_gate"][e]) * (
            x[t] @ tp["experts_up"][e])
        want[t] += gates[t, a % cfg.top_k] * (h @ tp["experts_down"][e])
    np.testing.assert_allclose(y[0].detach().numpy(), want.numpy(), **SERVE)
