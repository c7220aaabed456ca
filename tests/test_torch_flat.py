"""The port's flat buffer against ``repro.core.flat``: layout fields equal,
flatten / flatten_stacked / unflatten bitwise, in ``jax.tree_util`` leaf
order (sorted keys, so ``layer10`` sorts before ``layer2``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as jfl
from repro_torch.core import flat as tfl
from repro_torch.convert import params_from_numpy
from repro_torch.utils import tree_leaves


def _mlp_np(rng):
    dims = [24, 64, 64, 6]
    return {f"layer{i}": {"w": rng.standard_normal((dims[i], dims[i + 1]),
                                                   dtype=np.float32),
                          "b": rng.standard_normal(dims[i + 1],
                                                   dtype=np.float32)}
            for i in range(3)}


def _deep_np(rng):
    # Keys layer2 / layer10 sort as strings; ragged sizes leave a zero tail.
    return {"layer2": {"w": rng.standard_normal((5, 7), dtype=np.float32)},
            "layer10": {"w": rng.standard_normal((3, 3), dtype=np.float32),
                        "b": rng.standard_normal(3, dtype=np.float32)},
            "emb": rng.standard_normal(11, dtype=np.float32)}


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("make", [_mlp_np, _deep_np], ids=["mlp", "layer10"])
def test_layout_and_flatten_bitwise(make):
    tree = make(np.random.default_rng(0))
    jl = jfl.layout_of(_to_jax(tree))
    tt = params_from_numpy(tree, device="cpu")
    tl = tfl.layout_of(tt)
    assert (tl.shapes, tl.sizes, tl.offsets, tl.n, tl.rows) == \
        (jl.shapes, jl.sizes, jl.offsets, jl.n, jl.rows)
    assert tl.padded == jl.padded
    jb = np.asarray(jfl.flatten_tree(_to_jax(tree), jl))
    tb = tfl.flatten_tree(tt, tl).numpy()
    np.testing.assert_array_equal(tb.view(np.uint32), jb.view(np.uint32))
    assert not tb.reshape(-1)[tl.n:].any()        # zero tail

    back = tfl.unflatten_tree(torch.from_numpy(tb), tl)
    jback = jfl.unflatten_tree(jnp.asarray(jb), jl)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(jback)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("make", [_mlp_np, _deep_np], ids=["mlp", "layer10"])
def test_flatten_stacked_bitwise(make):
    rng = np.random.default_rng(1)
    trees = [make(rng) for _ in range(3)]
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)
    jl = jfl.layout_of(_to_jax(trees[0]))
    tl = tfl.layout_of(params_from_numpy(trees[0], device="cpu"))
    jb = np.asarray(jfl.flatten_stacked(_to_jax(stacked), jl))
    tb = tfl.flatten_stacked(params_from_numpy(stacked, device="cpu"),
                             tl).numpy()
    assert tb.shape == (3, tl.rows, tfl.LANES)
    np.testing.assert_array_equal(tb.view(np.uint32), jb.view(np.uint32))

