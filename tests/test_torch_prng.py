"""The port's counter-based sampler (``repro_torch.prng``) against
``jax.random`` under this installation's defaults (threefry2x32,
partitionable counters, 32-bit seeds, gumbel mode "low").

Keys, fold-ins, random bits, uniforms and randint are bit-exact.  gumbel
is ``-log(-log(u))`` of a bit-exact ``u``, and XLA's ``log`` rounds one
ulp away from the correctly rounded value on about a seventh of its
inputs where torch's does not, so gumbel is held within 2 f32 ulp of
``max(|g|, 1)``: near ``g = 0`` the outer log passes its input's absolute
error through, and an ulp count of the output alone has no bound there.
categorical must return JAX's index at every tested key."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import prng

EPS = float(np.finfo(np.float32).eps)


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _row_keys(seed, rids, t):
    """One JAX key per row, folded as the engines fold them."""
    base = jax.random.PRNGKey(seed)
    return [jax.random.fold_in(jax.random.fold_in(base, int(r)), t)
            for r in rids]


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 17])
def test_keys_and_fold_in_bit_exact(seed):
    tk = prng.PRNGKey(seed)
    assert np.array_equal(tk.numpy(), _kd(jax.random.PRNGKey(seed)))
    rids = np.array([0, 3, 77, 1023], np.int32)
    for t in (0, 1, 31, 500):
        want = np.stack([_kd(k) for k in _row_keys(seed, rids, t)])
        got = prng.fold_in(prng.fold_in(tk.expand(len(rids), 2),
                                        torch.as_tensor(rids)), t)
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(prng.split(tk, 3).numpy(),
                          _kd(jax.random.split(jax.random.PRNGKey(seed), 3)))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (1001,), (2, 3, 4)])
def test_random_bits_and_uniform_bit_exact(shape):
    for seed in (0, 9):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        assert np.array_equal(prng.random_bits(tk, shape).numpy(),
                              want.astype(np.int64))
        ju = np.asarray(jax.random.uniform(jk, shape))
        tu = prng.uniform(tk, shape).numpy()
        assert np.array_equal(tu.view(np.int32), ju.view(np.int32))
        ju = np.asarray(jax.random.uniform(jk, shape, minval=prng.TINY,
                                           maxval=1.0))
        tu = prng.uniform(tk, shape, prng.TINY, 1.0).numpy()
        assert np.array_equal(tu.view(np.int32), ju.view(np.int32))


def test_per_row_bits_bit_exact():
    """A [B, V] draw with one key per row (the sampler's layout) equals
    each row's own JAX draw; V odd."""
    rids = np.array([5, 0, 12, 3], np.int32)
    keys = _row_keys(2, rids, 7)
    tk = torch.as_tensor(np.stack([_kd(k) for k in keys]))
    v = 257
    got = prng.random_bits(tk, (v,)).numpy()
    for i, k in enumerate(keys):
        want = np.asarray(jax.random.bits(k, (v,), jnp.uint32))
        assert np.array_equal(got[i], want.astype(np.int64))
    gu = prng.uniform(tk, (v,)).numpy()
    for i, k in enumerate(keys):
        assert np.array_equal(gu[i].view(np.int32), np.asarray(
            jax.random.uniform(k, (v,))).view(np.int32))


@pytest.mark.parametrize("shape", [(4099,), (8, 257)])
def test_gumbel_within_two_ulp(shape):
    for seed in (0, 3, 11):
        jg = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
        tg = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
        assert np.all(np.abs(tg - jg) <= 2 * EPS * np.maximum(np.abs(jg),
                                                              1.0))


@pytest.mark.parametrize("v,temperature", [(256, 0.8), (1001, 1.0),
                                           (152, 0.3)])
def test_categorical_matches_jax(v, temperature):
    rng = np.random.default_rng(v)
    rids = np.arange(32, dtype=np.int32) * 7 + 1
    for t in (0, 1, 9):
        logits = (rng.standard_normal((len(rids), v)) * 3).astype(
            np.float32)
        keys = _row_keys(4, rids, t)
        temp = np.float32(temperature)
        want = [int(jax.random.categorical(
            k, jnp.asarray(logits[i]) / jnp.asarray(temp)))
            for i, k in enumerate(keys)]
        tk = prng.fold_in(prng.fold_in(
            prng.PRNGKey(4).expand(len(rids), 2), torch.as_tensor(rids)), t)
        got = prng.categorical(
            tk, torch.as_tensor(logits) / torch.tensor(temp))
        assert got.tolist() == want


def test_randint_bit_exact():
    """The static launcher's prompts: JAX's randint from PRNGKey(1)."""
    for shape, hi in (((8, 32), 151936), ((3, 17), 256), ((5,), 7)):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(1), shape,
                                             0, hi))
        got = prng.randint(prng.PRNGKey(1), shape, 0, hi)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_key_crosses_from_jax():
    k = jax.random.fold_in(jax.random.PRNGKey(123), 9)
    tk = convert.key_from_jax(np.asarray(jax.random.key_data(k)))
    assert tk.dtype == torch.int64 and tuple(tk.shape) == (2,)
    assert np.array_equal(prng.uniform(tk, (33,)).numpy().view(np.int32),
                          np.asarray(jax.random.uniform(k, (33,))).view(
                              np.int32))
