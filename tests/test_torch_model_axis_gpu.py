"""The model axis of the mesh runtime on the card: two gloo ranks on card 0
form one fed worker's model group, and every collective DTensor issues on
it goes through ``fed.collectives.model_transport``, staged through
pinned host memory (gloo moves host memory).

Held against the same ranks on the CPU, where gloo runs DTensor's own
collectives: a DTensor matmul (``rtol=1e-6``: cuBLAS and ATen's CPU
kernel sum in other orders) and each redistribution the training step
issues, bitwise: all-gather, reduce-scatter, all-reduce, all-to-all. Each
runs under sync-debug "error" (a staged call lifts it for its own
duration) and stages at least one copy. One ``build_fed_step`` round of
reduced ``qwen3-14b`` at (F, M) = (1, 2), tensor-parallel on the card,
is held within ``rtol=1e-4, atol=1e-6`` of the same round on the CPU.

Needs a CUDA card; every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is false. It imports nothing of JAX::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_model_axis_gpu.py
"""
import numpy as np
import pytest
import torch

import _torch_dist as H

KEYS = ["matmul", "all_gather", "reduce_scatter", "all_reduce",
        "all_to_all"]
KINDS = {"matmul": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_reduce": "all-reduce",
         "all_to_all": "all-to-all"}


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return H.run_ranks({"task": "axis", "F": 1, "M": 2, "device": "cuda"},
                       str(tmp_path_factory.mktemp("axis_gpu")))


@pytest.mark.gpu
@pytest.mark.parametrize("key", KEYS)
def test_staged_model_axis_equals_the_cpu(card, key):
    got, want = card[f"axis_{key}_transport"], card[f"cpu_axis_{key}_dtensor"]
    if key == "matmul":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    assert KINDS[key] in card[f"axis_{key}_kinds"]
    assert card[f"axis_{key}_staged"] > 0


@pytest.mark.gpu
def test_tensor_parallel_round_on_the_card(card):
    np.testing.assert_allclose(card["step_cuda_cost"], card["step_cpu_cost"],
                               rtol=1e-4)
    np.testing.assert_allclose(card["step_cuda"], card["step_cpu"],
                               rtol=1e-4, atol=1e-6)
