"""The paper's Fig. 7a, 7b, 8, Table I and Fig. 9 on the port against the
JAX package, and the key paths that let them be compared chip for chip.

``prng.normal`` equals ``jax.random.normal`` bit for bit (0 ulp) on every
key and shape below; ``torch.special.erfinv`` over the same uniform is up
to 91 ulp away.  At a key, ``sample_caat`` draws JAX's CAAT bit for bit;
``sample_adc``'s table is within 4 f32 ulp of 1.0 of JAX's (its bow goes
through ``sin``, which XLA rounds its own way); effective bits are within
1e-3 (the port's CAAT combine runs in float64, JAX's in f32).  The
figure rows are compared as printed."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import adc as tadc
from repro_torch.core import caat as tcaat
from repro_torch.core import macro as tmacro

ULP1 = float(np.finfo(np.float32).eps)    # f32 ulp at 1.0
ADC_ATOL = 4 * ULP1



def _key(seed) -> torch.Tensor:
    return prng.as_key(np.asarray(jax.random.key_data(
        jax.random.PRNGKey(seed))))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", [0, 3, 42, 2**31 + 5])
@pytest.mark.parametrize("shape", [(), (1,), (9,), (3, 5), (4096,)])
def test_normal_bit_exact(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(_key(seed), shape)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_normal_batched_keys_and_split():
    """A [n, 2] batch of keys draws what each key draws alone (JAX's vmap),
    and ``split`` of a batch splits each key."""
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    tk = prng.as_key(np.asarray(jax.random.key_data(keys)))
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (9,)))(keys))
    np.testing.assert_array_equal(prng.normal(tk, (9,)).numpy(), want)
    want = np.asarray(jax.random.key_data(
        jax.vmap(lambda k: jax.random.split(k, 3))(keys)))
    np.testing.assert_array_equal(prng.split(tk, 3).numpy(), want)


@pytest.mark.parametrize("lo,hi", [(-0.3, 0.3), (0.0, 1.0), (-1.0, 3.0),
                                   (2.5, 7.1)])
def test_uniform_any_span_bit_exact(lo, hi):
    """XLA:CPU fuses ``floats * span + lo``; the port's uniform did not,
    and differed on half the draws where the span is not a power of two
    (Fig. 7b's ADC phase draws at (-0.3, 0.3))."""
    for seed in (0, 11):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                             (2048,), minval=lo, maxval=hi))
        got = prng.uniform(_key(seed), (2048,), lo, hi).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        want = jax.random.uniform(jax.random.PRNGKey(seed), (), minval=lo,
                                  maxval=hi)
        assert prng.uniform(_key(seed), (), lo, hi).item() == float(want)


def _jax_core():
    from repro.core import adc as jadc
    from repro.core import caat as jcaat
    from repro.core import macro as jmacro
    return jcaat, jadc, jmacro


@pytest.mark.parametrize("seed", [0, 1, 7, 1003])
def test_sample_chip_at_jax_keys(seed):
    jcaat, jadc, jmacro = _jax_core()
    jcfg = jmacro.nominal_config()
    tcfg = tmacro.nominal_config()
    want = jmacro.sample_chip(jax.random.PRNGKey(seed), jcfg)
    got = tmacro.sample_chip(_key(seed), tcfg)
    for k, v in want["caat"].items():
        np.testing.assert_array_equal(_bits(got["caat"][k].numpy()),
                                      _bits(v), err_msg=k)
    np.testing.assert_allclose(got["adc"]["inl_lut"].numpy(),
                               np.asarray(want["adc"]["inl_lut"]),
                               rtol=0, atol=ADC_ATOL)
    # The parts alone, at the same key.
    caat = tcaat.sample_caat(_key(seed), tcfg.caat)
    jc = jcaat.sample_caat(jax.random.PRNGKey(seed), jcfg.caat)
    for k, v in jc.items():
        np.testing.assert_array_equal(_bits(caat[k].numpy()), _bits(v))
    assert abs(tcaat.caat_effective_bits(caat, tcfg.caat)
               - jcaat.caat_effective_bits(jc, jcfg.caat)) <= 1e-3
    lut = tadc.sample_adc(_key(seed), tcfg.adc)["inl_lut"].numpy()
    jl = np.asarray(jadc.sample_adc(jax.random.PRNGKey(seed),
                                    jcfg.adc)["inl_lut"])
    np.testing.assert_allclose(lut, jl, rtol=0, atol=ADC_ATOL)


def test_batched_chips_equal_one_at_a_time():
    """Fig. 9 draws its chips as one batch of keys: each equals its key's
    chip drawn alone, bit for bit."""
    cfg = tmacro.nominal_config()
    keys = torch.stack([prng.PRNGKey(s) for s in (0, 5, 1000)])
    caat = tcaat.sample_caat(keys, cfg.caat)
    luts = tadc.sample_adc(keys, cfg.adc)["inl_lut"]
    for i, s in enumerate((0, 5, 1000)):
        one = tcaat.sample_caat(prng.PRNGKey(s), cfg.caat)
        for k, v in one.items():
            assert torch.equal(caat[k][i], v), k
        assert torch.equal(luts[i], tadc.sample_adc(
            prng.PRNGKey(s), cfg.adc)["inl_lut"])


def _rows(fn) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return [line for line in out.getvalue().splitlines() if line]


FIGS = ["fig7_capacitor_area", "fig7_energy", "fig8_breakdown",
        "table1_metrics"]


@pytest.mark.parametrize("name", FIGS)
def test_figure_rows_equal_jax(name):
    """Every printed row equals the JAX package's; Fig. 7b's measured
    negative fraction within 1e-3 (the macro simulation's float64 combine
    against JAX's f32; here it is equal too)."""
    import importlib
    jmod = importlib.import_module(f"benchmarks.{name}")
    tmod = importlib.import_module(f"repro_torch.launch.{name}")
    want = _rows(jmod.main)
    res = tmod.main("cpu")
    assert res["rows"] == _rows(lambda: tmod.main("cpu"))
    got = res["rows"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.startswith("fig7b_measured_neg_fraction"):
            gv = dict(kv.split("=") for kv in g.split(",", 2)[2].split())
            wv = dict(kv.split("=") for kv in w.split(",", 2)[2].split())
            assert abs(float(gv["neg"]) - float(wv["neg"])) <= 1e-3
            assert g.split(",")[0] == w.split(",")[0]
        else:
            assert g == w
    if name == "fig7_energy":
        assert abs(res["neg_fraction"] - 0.450) <= 1e-3


def test_fig9_chips_equal_jax():
    """Fig. 9 at 8 CAAT chips and 5 ADCs: per-chip effective bits within
    1e-3 and max |INL| within 1e-6 of the JAX package's."""
    jcaat, jadc, jmacro = _jax_core()
    from repro_torch.launch import fig9_nonlinearity as fig9
    cfg = jmacro.nominal_config()
    bits, inls = fig9.measure("cpu", 8, 5)
    want_bits = [jcaat.caat_effective_bits(
        jcaat.sample_caat(jax.random.PRNGKey(i), cfg.caat), cfg.caat)
        for i in range(8)]
    want_inls = [float(jnp.max(jnp.abs(jadc.sample_adc(
        jax.random.PRNGKey(1000 + i), cfg.adc)["inl_lut"])))
        for i in range(5)]
    np.testing.assert_allclose(bits, want_bits, rtol=0, atol=1e-3)
    np.testing.assert_allclose(inls, want_inls, rtol=0, atol=1e-6)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    from repro_torch.launch import fig7_capacitor_area, fig9_nonlinearity
    for mod in (fig7_capacitor_area, fig9_nonlinearity):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main()
