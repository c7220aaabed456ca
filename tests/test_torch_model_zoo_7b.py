"""The port's MoE and recurrent configs against the JAX package's, reduced
(``deepseek-moe-16b``, ``grok-1-314b``: MoE; ``jamba-1.5-large-398b``:
Mamba + attention + MoE; ``xlstm-350m``: mLSTM + sLSTM): the parameter
tree, ``loss``/``train_step``, ``prefill``/``decode_step``/
``prefill_sequential``, with the tolerances of ``tests/_zoo_parity.py``
(the model zoo's; the reduced Jamba's looser ones stated there), and the
MoE loss's router terms. A file apart from ``test_torch_model_zoo.py``
so that the two run side by side.
"""
import jax
import pytest
import torch

from _zoo_parity import (LOSS, STEP, _close, _pair,
                         loss_and_train_step_match,
                         param_tree_carries_across,
                         prefill_decode_and_sequential_match)
from repro_torch.utils import tree_leaves

ZOO_7B = ("deepseek-moe-16b", "grok-1-314b", "jamba-1.5-large-398b",
          "xlstm-350m")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ZOO_7B)
def test_param_tree_carries_across(arch, dtype):
    param_tree_carries_across(arch, dtype)


@pytest.mark.parametrize("arch", ZOO_7B)
def test_loss_and_train_step_match(arch):
    loss_and_train_step_match(arch)


def test_moe_loss_carries_the_router_terms():
    # The loss is the cross-entropy plus router_aux_weight x load balance
    # and 1e-3 x z-loss, each averaged over the MoE blocks (not the
    # first_k_dense prefix); its gradient includes theirs (the gradients
    # equal the reference's).
    cfg, jm, tm, jp, tp, jb, tb, fns = _pair("deepseek-moe-16b")
    assert cfg.first_k_dense == 1 and cfg.n_units == 2
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    (tl, taux), tg = tm.loss_and_grad(tp, tb)
    _close(tl, jl, LOSS)
    for k in ("load_balance", "z_loss", "drop_frac"):
        _close(taux[k], jaux[k], LOSS)
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        _close(a, b, STEP)
    with torch.no_grad():
        logits, _ = tm.forward(tp, tb)
    lf = logits[:, :-1].float()
    xent = (torch.logsumexp(lf, -1) - lf.gather(
        -1, tb["tokens"][:, 1:].long()[..., None])[..., 0]).mean()
    router = (cfg.router_aux_weight * float(taux["load_balance"])
              + 1e-3 * float(taux["z_loss"])) / 2
    assert router > 1e-3
    assert abs(float(tl) - float(xent) - router) <= 1e-5 * float(tl)


@pytest.mark.parametrize("arch", ZOO_7B)
def test_prefill_decode_and_sequential_match(arch):
    prefill_decode_and_sequential_match(arch)

