"""The torch threefry2x32 (tch_geometric_tpu_torch/sampling/rng.py) against
jax.random: keys, split, fold_in and raw bits bit-equal; uniform and
randint bit-equal; gumbel within an ulp of log."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tch_geometric_tpu.sampling import rng as jrng
from tch_geometric_tpu_torch.sampling import rng

SHAPES = [(1,), (7,), (3, 5), (1000,), (4, 33, 3), (2, 1, 129)]


def kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, 2**32 + 5])
def test_key_split_fold_in(seed):
    k = jax.random.key(seed)
    tk = rng.key(seed)
    np.testing.assert_array_equal(kd(k), tk.numpy())
    for num in (2, 3, 8):
        np.testing.assert_array_equal(kd(jax.random.split(k, num)),
                                      rng.split(tk, num).numpy())
    for data in (0, 1, 7, 2**31 + 3, rng.DROPOUT_STREAM):
        np.testing.assert_array_equal(
            kd(jax.random.fold_in(k, jnp.asarray(data, jnp.uint32))),
            rng.fold_in(tk, data).numpy())


def test_fold_discipline():
    k, tk = jax.random.key(5), rng.key(5)
    assert rng.DROPOUT_STREAM == jrng.DROPOUT_STREAM
    np.testing.assert_array_equal(kd(jrng.fold(k, 3, 1, 2)),
                                  rng.fold(tk, 3, 1, 2).numpy())
    np.testing.assert_array_equal(
        kd(jrng.fold(k, jrng.DROPOUT_STREAM)),
        rng.fold(tk, rng.DROPOUT_STREAM).numpy())


def test_seed_next_key_matches():
    jrng.seed(9)
    rng.seed(9)
    for _ in range(3):
        np.testing.assert_array_equal(kd(jrng.next_key()),
                                      rng.next_key().numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bit_equal(shape):
    k, tk = jax.random.key(11), rng.key(11)
    jb = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(jb, rng.random_bits(tk, shape, "cpu").numpy())
    ju = np.asarray(jax.random.uniform(k, shape, jnp.float32))
    tu = rng.uniform(tk, shape, device="cpu").numpy()
    np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))
    ju = np.asarray(jax.random.uniform(k, shape, jnp.float32, -2.5, 3.0))
    tu = rng.uniform(tk, shape, -2.5, 3.0, device="cpu").numpy()
    np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_randint_bit_equal(shape):
    k, tk = jax.random.key(3), rng.key(3)
    r = np.random.default_rng(0)
    n = int(np.prod(shape))
    # spans from 1 to > 2**16 (the multiplier wraps in uint32 there), and
    # maxval <= minval (span forced to 1)
    hi = np.concatenate([[0, 1, 2, 65537, 2**31 - 1],
                         r.integers(-3, 100_000, max(n - 5, 0))])[:n]
    hi = hi.reshape(shape)
    ji = np.asarray(jax.random.randint(k, shape, 0, jnp.asarray(hi, jnp.int32),
                                       dtype=jnp.int32))
    ti = rng.randint(tk, shape, 0, torch.as_tensor(hi), device="cpu").numpy()
    np.testing.assert_array_equal(ji, ti)
    ji = np.asarray(jax.random.randint(k, shape, -5, 17, dtype=jnp.int32))
    np.testing.assert_array_equal(
        ji, rng.randint(tk, shape, -5, 17, device="cpu").numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_within_log_ulp(shape):
    k, tk = jax.random.key(8), rng.key(8)
    jg = np.asarray(jax.random.gumbel(k, shape, jnp.float32))
    tg = rng.gumbel(tk, shape, device="cpu").numpy()
    # -log(-log(u)) from identical u: the two libms' log may differ in the
    # last ulp, amplified at most by |d gumbel / d log| ~ 1/|log u|
    np.testing.assert_allclose(jg, tg, rtol=4e-7, atol=1e-6)
