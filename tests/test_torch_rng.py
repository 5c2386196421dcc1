"""The torch threefry2x32 (tch_geometric_tpu_torch/sampling/rng.py) against
jax.random: keys, split, fold_in and raw bits bit-equal; uniform and
randint bit-equal; gumbel within an ulp of log.  The host keys' hash on
python ints against the torch hash and jax; block draws whose counters
cross 2**32 against jax's construction of ``jax.random.bits``; draws on
CPU tensors launch no kernel."""
import jax
import jax.numpy as jnp
from jax.extend.random import threefry2x32_p
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


@pytest.mark.parametrize("data", [0, 1, 2**31, 2**32 - 1])
def test_host_int_keys_match_torch_threefry_and_jax(data):
    """``split`` and ``fold_in`` hash python ints: bit-equal to the torch
    ``threefry2x32`` of the same counters and to ``jax.random``, over many
    keys with both words drawn (and the extreme words)."""
    g = np.random.default_rng(data % 997)
    words = g.integers(0, 2**32, (40, 2))
    words[:3] = [[0, 0], [0, 2**32 - 1], [2**32 - 1, 2**32 - 1]]
    for w in words:
        tk = torch.tensor(w, dtype=torch.int64)
        jk = jax.random.wrap_key_data(jnp.asarray(w, jnp.uint32))
        folded = rng.fold_in(tk, data)
        o0, o1 = rng.threefry2x32(tk[:1], tk[1:], torch.zeros(1, dtype=torch.int64),
                                  torch.tensor([data]))
        assert folded.tolist() == [int(o0), int(o1)]
        np.testing.assert_array_equal(
            kd(jax.random.fold_in(jk, jnp.asarray(data, jnp.uint32))),
            folded.numpy())
        keys = rng.split(tk, 3)
        assert torch.equal(keys, rng.threefry_plain(tk, 3, "cpu", words=True))
        np.testing.assert_array_equal(kd(jax.random.split(jk, 3)),
                                      keys.numpy())


def _jax_bits_rows(k, shape, row0):
    """Rows ``[row0, row0 + shape[0])`` of ``jax.random.bits(k, (R,) +
    shape[1:])`` as jax builds the draw: its threefry over the uint64 iota
    of the whole shape split into (hi, lo) words (``iota_2x32_shape``),
    the output words xor-ed.  Held to ``jax.random.bits`` itself on a
    small shape first."""
    def bits(idx):
        kw = jax.random.key_data(k)
        hi = jnp.asarray((idx >> 32).astype(np.uint32))
        lo = jnp.asarray((idx & 0xFFFFFFFF).astype(np.uint32))
        b1, b2 = threefry2x32_p.bind(kw[0], kw[1], hi, lo)
        return np.asarray(b1 ^ b2).astype(np.int64)

    small = (3,) + tuple(shape[1:])
    np.testing.assert_array_equal(
        bits(np.arange(int(np.prod(small)), dtype=np.uint64)).reshape(small),
        np.asarray(jax.random.bits(k, small, jnp.uint32)).astype(np.int64))
    n = int(np.prod(shape[1:]))
    idx = np.arange(row0 * n, (row0 + shape[0]) * n, dtype=np.uint64)
    return bits(idx).reshape(shape)


@pytest.mark.parametrize("shape,row0", [((5, 1000), 2**32 // 1000),
                                        ((3, 4096, 2), 2**32 // 8192 - 1),
                                        ((4, 3), 1431655765)])
def test_block_draw_across_2_32_matches_jax_rows(shape, row0):
    n = int(np.prod(shape[1:]))
    assert row0 * n < 2**32 < (row0 + shape[0]) * n
    k, tk = jax.random.key(17), rng.key(17)
    np.testing.assert_array_equal(
        _jax_bits_rows(k, shape, row0),
        rng.random_bits(tk, shape, "cpu", row0=row0).numpy())


_TABLE = torch.tensor([[1, 2], [3, 2**32 - 1], [2**31, 7]])
_DATA = torch.tensor([0, 5, 2**32 - 1])


@pytest.mark.parametrize("draw", [
    lambda: rng.random_bits(rng.key(1), (4, 5), "cpu", row0=3),
    lambda: rng.uniform(rng.key(1), (7,), device="cpu"),
    lambda: rng.randint(rng.key(1), (7,), 0, 9, device="cpu"),
    lambda: rng.gumbel(rng.key(1), (7,), device="cpu"),
    lambda: rng.random_bits_each(_TABLE, (2, 3)),
    lambda: rng.split_each(_TABLE, 3),
    lambda: rng.fold_in_each(_TABLE, 2**31),
    lambda: rng.fold_in_each(_TABLE, _DATA),
    lambda: rng.fold_in_many(rng.key(1), _DATA),
], ids=["random_bits", "uniform", "randint", "gumbel", "random_bits_each",
        "split_each", "fold_in_each", "fold_in_each_rows", "fold_in_many"])
def test_draws_on_cpu_tensors_launch_no_kernel(draw):
    before = rng.threefry_cuda.launches
    out = draw()
    assert out.device.type == "cpu" and out.numel() > 0
    assert rng.threefry_cuda.launches == before


@pytest.mark.parametrize("fn", [rng.threefry_plain, rng.threefry_cuda],
                         ids=["plain", "cuda"])
def test_counters_from_data_give_only_keys(fn):
    with pytest.raises(ValueError, match="words=True"):
        fn(rng.key(1), _DATA.numel(), data=_DATA)
