"""The port's ``quant.quantile_scale`` and ``ActObserver`` and
``attention.init_kv_cache`` against the JAX package's on the same inputs.

``quantile_scale`` is ``jnp.quantile`` (linear) of |x| then a clamp and a
divide.  XLA's order for the interpolation is not recoverable (it may
fuse it), so the quantile is held to 1 f32 ulp of JAX's and the scale to
2; the rest is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.models import attention as jattn
from repro_torch.core import quant as tq
from repro_torch.models import attention as tattn


def _ulps(a, b, view=np.int32) -> int:
    """Distance in units in the last place of two non-negative floats."""
    return abs(int(np.asarray(a).view(view)) - int(np.asarray(b).view(view)))


def _draws(seed=0, count=24):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        n = int(rng.integers(7, 2**17))
        q = float(rng.choice([0.5, 0.9, 0.99, 0.999, 0.9995]))
        x = rng.standard_normal(n) * rng.uniform(0.01, 30)
        if rng.random() < 0.3:                   # a few outliers
            x[rng.integers(0, n, 3)] *= 1000
        yield x.astype(np.float32), q


def test_quantile_scale_within_stated_ulp():
    for x, q in _draws():
        want_q = np.asarray(jnp.quantile(jnp.abs(jnp.asarray(x)), q))
        got_q = tq._quantile(torch.from_numpy(x).abs(), q).numpy()
        assert _ulps(got_q, want_q) <= 1, (x.size, q)
        want = np.asarray(jq.quantile_scale(jnp.asarray(x), q))
        got = tq.quantile_scale(torch.from_numpy(x), q).numpy()
        assert got.dtype == want.dtype == np.float32
        assert _ulps(got, want) <= 2, (x.size, q)
    # The default q, and an all-zero input clamped to 1e-8 / 127.
    x = next(_draws(seed=1))[0]
    assert _ulps(tq.quantile_scale(torch.from_numpy(x)).numpy(),
                 np.asarray(jq.quantile_scale(jnp.asarray(x)))) <= 2
    z = np.zeros(33, np.float32)
    assert (tq.quantile_scale(torch.from_numpy(z)).item()
            == float(jq.quantile_scale(jnp.asarray(z))))


def test_quantile_scale_other_dtypes():
    """int8 input (|-128| wraps in both) is taken to f32; bf16 stays
    bf16, within one bf16 ulp of JAX's."""
    rng = np.random.default_rng(2)
    x8 = rng.integers(-128, 128, 5001).astype(np.int8)
    got = tq.quantile_scale(torch.from_numpy(x8), 0.99).numpy()
    want = np.asarray(jq.quantile_scale(jnp.asarray(x8), 0.99))
    assert got.dtype == want.dtype == np.float32 and _ulps(got, want) <= 2
    xb = rng.standard_normal(3001).astype(np.float32)
    got = tq.quantile_scale(torch.from_numpy(xb).to(torch.bfloat16), 0.999)
    want = jq.quantile_scale(jnp.asarray(xb, jnp.bfloat16), 0.999)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _ulps(got.view(torch.int16).numpy(),
                 np.asarray(want).view(np.int16), np.int16) <= 1


def test_quantile_scale_above_torch_quantile_limit():
    """2**24 + 1 elements: past ``torch.quantile``'s limit, the order
    statistics still agree with JAX's (n - 1 rounds in f32 there)."""
    x = np.random.default_rng(3).standard_normal(2**24 + 1).astype(
        np.float32)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(torch.from_numpy(x), 0.5)
    got = tq.quantile_scale(torch.from_numpy(x)).numpy()
    want = np.asarray(jq.quantile_scale(jnp.asarray(x)))
    assert _ulps(got, want) <= 2


def test_act_observer_bit_exact():
    rng = np.random.default_rng(4)
    jo, to = jq.ActObserver(), tq.ActObserver()
    assert (jo.scale(), jo.count) == (to.scale(), to.count)
    for i in range(7):
        x = (rng.standard_normal((3, 17)) * (i + 1) ** 2).astype(np.float32)
        jo.update(jnp.asarray(x))
        to.update(torch.from_numpy(x))
        assert (to.amax, to.count) == (jo.amax, jo.count)
        assert type(to.amax) is float
        for qmax in (127, 7):
            assert to.scale(qmax) == jo.scale(qmax)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_init_kv_cache_matches_jax(dtype):
    want = jattn.init_kv_cache(3, 10, 2, 16, getattr(jnp, dtype))
    got = tattn.init_kv_cache(3, 10, 2, 16, getattr(torch, dtype),
                              device="cpu")
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, name
        assert not g.any(), name
