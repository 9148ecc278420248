"""otamg_torch.random against jax.random: keys, splits and uniform draws
must be equal bit for bit (threefry2x32, partitionable layout)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otamg_torch import random as tr

SEEDS = [0, 42, 2 ** 40 + 5]


def test_threefry_is_partitionable():
    """The port reproduces the partitionable split/bits layout, JAX's
    default; a changed default would change every draw."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_exact(seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed), np.int64),
                          tr.PRNGKey(seed).numpy()), "PRNGKey: exact"


@pytest.mark.parametrize("num", [2, 3, 4])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_exact(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num),
                      np.int64)
    got = tr.split(tr.PRNGKey(seed), num).numpy()
    assert np.array_equal(want, got), "split: exact"


def test_split_chain_exact():
    """Keys threaded through many splits, as the solve threads them."""
    kj, kt = jax.random.PRNGKey(7), tr.PRNGKey(7)
    for _ in range(20):
        kj, _ = jax.random.split(kj)
        kt = tr.split(kt)[0]
    assert np.array_equal(np.asarray(kj, np.int64), kt.numpy())


@pytest.mark.parametrize("shape", [(), (7,), (24, 20), (1000,), (1,)])
@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.float64, torch.float64)],
                         ids=["f32", "f64"])
def test_uniform_exact(shape, dtypes):
    jd, td = dtypes
    for seed in SEEDS:
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                             jd))
        got = tr.uniform(tr.PRNGKey(seed), shape, td).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(want, got), f"uniform {shape} {jd}: exact"


def test_uniform_rejects_other_dtypes():
    with pytest.raises(TypeError):
        tr.uniform(tr.PRNGKey(0), (3,), torch.float16)
