"""The port's bfloat16 xLSTM against the JAX package's bfloat16 model, and
the witness for ``chip_smoke.py``'s fixed limit on a bfloat16 LSTM stack's
two serving paths (``SERVE_TOL_LSTM_BF16``). The float32 checks of the
recurrent configs are in ``tests/test_torch_model_zoo_7b.py``; this file
stands apart so that the two run side by side.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _zoo_parity import _np
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model as tbuild

B, S = 2, 64


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("first", ["mlstm", "slstm"])
def test_bfloat16_lstm_stack_holds_to_the_reference(first):
    # The reduced xlstm-350m in bfloat16 in both packages, on the JAX
    # package's weights, 64 tokens, with either mixer first. The first
    # block's recurrent state after the prefill comes straight off the
    # shared bfloat16 projections of the embedding: the two packages'
    # states agree to a relative L2 of 2.3e-5 (mLSTM first) and bitwise
    # (sLSTM first), where one cast to bfloat16 in a state, a gate
    # product, h or k's scale moves some leaf by 1.5e-3 to 1e-2 (measured
    # on the CPU, one such fault at a time), so 2e-4 it is. The logits are
    # held within 0.02 (measured 0.005 and 0.009: bfloat16 rounds each
    # product and norm to 8 bits, and two blocks compound them) and the
    # loss within 2e-3, as in the attention configs' bfloat16 test.
    second = "slstm" if first == "mlstm" else "mlstm"
    pattern = ((first, "none"), (second, "none"))
    jcfg = jget("xlstm-350m").reduced().replace(param_dtype="bfloat16",
                                                pattern=pattern)
    jm = jbuild(jcfg)
    tm = tbuild(tget("xlstm-350m").reduced().replace(
        param_dtype="bfloat16", pattern=pattern))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    tok = _tokens(jcfg.vocab)
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    jlog, js = jax.jit(lambda p, b: jm.prefill(
        p, b, jm.init_decode_state(B, S)))(jp, jb)
    jl, _ = jax.jit(jm.loss)(jp, jb)
    with torch.no_grad():
        tlog, ts = tm.prefill(tp, tb, tm.init_decode_state(B, S,
                                                           device="cpu"))
        tl, _ = tm.loss(tp, tb)
    assert tlog.dtype == torch.bfloat16
    for k in ts["units"]["b0"]:
        d = _rel_l2(ts["units"]["b0"][k], js["units"]["b0"][k])
        assert d <= 2e-4, (first, k, d)
    assert _rel_l2(tlog, jlog) <= 0.02
    assert abs(float(tl) - float(jl)) <= 2e-3 * abs(float(jl))


def test_bfloat16_lstm_limit_of_the_chip_smoke():
    # chip_smoke.py holds a bfloat16 LSTM stack's two serving paths to a
    # fixed SERVE_TOL_LSTM_BF16. Each step's rounding feeds the next
    # through the exponential gates, so at xLSTM-350M's 24 layers the JAX
    # package's own bfloat16 prefill and prefill_sequential differ by more
    # than the attention configs' 0.08: 0.1669 at reduced width and 64
    # tokens. The limit leaves a margin over it. (The port's two paths
    # agree bitwise on the CPU, so the reference is the witness.)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    jcfg = jget("xlstm-350m").reduced().replace(param_dtype="bfloat16",
                                                n_layers=24)
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    jb = {"tokens": jnp.asarray(_tokens(jcfg.vocab))}
    fwd = [jax.jit(lambda p, b, f=f: f(p, b, jm.init_decode_state(B, S))[0])(
        jp, jb) for f in (jm.prefill, jm.prefill_sequential)]
    d = _rel_l2(*fwd)
    print(f"the JAX package's bfloat16 xlstm-350m, 24 layers: prefill vs "
          f"prefill_sequential {d:.4g}")
    assert smoke.SERVE_TOL["bfloat16"] < d <= smoke.SERVE_TOL_LSTM_BF16
