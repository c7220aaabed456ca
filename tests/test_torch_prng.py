"""``repro_torch.prng`` against ``jax.random`` (threefry, partitionable):
keys, ``fold_in``, ``split``, 32-bit bits, ``permutation`` (two shuffle
rounds above 1,625 elements) and the participation masks of
``repro.fed.rounds``, all held bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import rounds as jrd
from repro_torch import prng
from repro_torch.fed import rounds as trd

SEEDS = (0, 1, 3, 12345, 2**31 - 1)


def _key(k) -> np.ndarray:
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_and_bits_match(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _key(jk))
    for d in (0, 1, 7, 1000, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      _key(jax.random.fold_in(jk, d)))
    # A device-held round index keys the same draw as a host int.
    np.testing.assert_array_equal(
        prng.fold_in(tk, torch.tensor(7, dtype=torch.int32)).numpy(),
        _key(jax.random.fold_in(jk, 7)))
    for num in (1, 2, 5):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      _key(jax.random.split(jk, num)))
    for n in (1, 2, 37, 1000):
        np.testing.assert_array_equal(
            prng.random_bits32(tk, n).numpy(),
            np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(
                np.int64))


@pytest.mark.parametrize("n", [1, 2, 3, 10, 17, 64, 2000])
def test_permutation_matches(n):
    assert prng.shuffle_rounds(n) == (2 if n > 1625 else 1 if n > 1 else 0)
    for seed in SEEDS:
        for d in (0, 4):
            jk = jax.random.fold_in(jax.random.PRNGKey(seed), d)
            tk = prng.fold_in(prng.PRNGKey(seed), d)
            np.testing.assert_array_equal(
                prng.permutation(tk, n).numpy(),
                np.asarray(jax.random.permutation(jk, n)))


def test_shuffle_round_count_switches_at_1626():
    assert prng.shuffle_rounds(1625) == 1
    assert prng.shuffle_rounds(1626) == 2


@pytest.mark.parametrize("n", [1, 3, 4, 10, 17])
@pytest.mark.parametrize("start_round", [1, 4])
def test_participation_masks_match(n, start_round):
    for frac in (0.1, 0.5, 0.75, 1.0):
        for seed in (0, 1, 12345):
            jm = np.asarray(jrd.participation_masks(
                jax.random.PRNGKey(seed), 6, n, frac,
                start_round=start_round))
            tm = trd.participation_masks(prng.PRNGKey(seed), 6, n, frac,
                                         start_round=start_round)
            assert tm.dtype == torch.float32
            np.testing.assert_array_equal(tm.numpy(), jm)
            assert (tm.sum(1) == max(1, round(frac * n))).all()
    key = prng.PRNGKey(2)
    np.testing.assert_array_equal(
        trd.participation_mask(prng.fold_in(key, start_round), n,
                               0.5).numpy(),
        np.asarray(jrd.participation_mask(
            jax.random.fold_in(jax.random.PRNGKey(2), start_round), n,
            0.5)))


def test_participation_masks_at_two_shuffle_rounds():
    jm = np.asarray(jrd.participation_masks(jax.random.PRNGKey(3), 2, 2000,
                                            0.3))
    tm = trd.participation_masks(prng.PRNGKey(3), 2, 2000, 0.3).numpy()
    np.testing.assert_array_equal(tm, jm)


def test_negative_seed_raises():
    with pytest.raises(ValueError, match="non-negative"):
        prng.PRNGKey(-1)
