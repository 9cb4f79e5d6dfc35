"""Port parity: the CAAT macro op (kernel K5's plain version under
``cim_macro_matmul``) against the JAX package's op over its interpret-mode
kernel and its 81-plane oracle, and against the port's own behavioural
simulation with an ideal ADC.  Chips are sampled by JAX and carried
across."""
import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import caat as jcaat
from repro.core import macro as jmacro
from repro.kernels.caat_mac import caat_mac_ref as j_ref
from repro.kernels.caat_mac import cim_macro_matmul as j_cmm
from repro_torch import convert
from repro_torch.core import adc as tadc
from repro_torch.core import caat as tcaat
from repro_torch.core import macro as tmacro
from repro_torch.core import numerics as tnum
from repro_torch.kernels.caat_mac import ops as tops
from repro_torch.kernels.caat_mac import ref as tref

NOMINAL = dict(sigma_unit=0.0014, c2c_stage_gamma=0.0007, gain_sigma=0.001,
               offset_sigma=0.0005)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, b, k, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (b, k)).astype(np.int8),
            rng.integers(-128, 128, (k, n)).astype(np.int8))


def _configs(rows):
    return (jmacro.MacroConfig(rows=rows, caat=jcaat.CaatConfig(**NOMINAL)),
            tmacro.MacroConfig(rows=rows, caat=tcaat.CaatConfig(**NOMINAL)))


def _carried_chip(seed, jcfg):
    sample = jax.tree.map(np.asarray,
                          jmacro.sample_chip(jax.random.PRNGKey(seed), jcfg))
    return sample, convert.chip_from_jax(sample)


def _sim_chip(chip, tcfg):
    return {"caat": chip["caat"], "adc": tadc.ideal_adc(tcfg.adc)}


def codes_within(got, want):
    """|diff| <= 1 on at most 1e-3 of the outputs (see kernels/caat_mac):
    f32 sums round a code the other way where v * 128 lands within an ulp
    of a .5 boundary."""
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    return d.max(initial=0) <= 1 and (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("chip_seed", [0, 1])
def test_matches_jax_op_and_81_plane_oracle(relu, chip_seed):
    jcfg, tcfg = _configs(96)
    js, ts = _carried_chip(chip_seed, jcfg)
    a, w = _inputs(chip_seed, 16, 96, 40)
    v_fs = np.float32(96 * 128 * 128 * 0.25)
    want = np.asarray(j_ref(jnp.asarray(a), jnp.asarray(w), js["caat"],
                            jnp.float32(v_fs), relu=relu))
    jax_op = np.asarray(j_cmm(jnp.asarray(a), jnp.asarray(w), js,
                              jnp.float32(v_fs), jcfg, relu=relu, bm=8, bn=8))
    got = tops.cim_macro_matmul(_t(a), _t(w), ts, torch.tensor(v_fs), tcfg,
                                relu=relu)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), jax_op)
    np.testing.assert_array_equal(
        tref.caat_mac_ref(_t(a), _t(w), ts["caat"], torch.tensor(v_fs),
                          relu=relu).numpy(), want)


@hypothesis.given(seed=st.integers(0, 2**10), b=st.integers(1, 12),
                  k=st.integers(1, 160), n=st.integers(1, 24))
@hypothesis.settings(max_examples=10, deadline=None, derandomize=True)
def test_property_op_equals_sim_no_inl(seed, b, k, n):
    """The multi-tile op == the port's behavioural simulation with an
    ideal ADC (the property JAX's caat kernel test holds), and == JAX's op
    over its interpret kernel within the code tolerance, at any shape.
    Both port sides round once from float64, so a code differs only where
    a voltage lies within ~1e-7 of a .5 boundary; derandomized, so every
    run draws the same examples."""
    jcfg, tcfg = _configs(64)
    js, ts = _carried_chip(seed, jcfg)
    a, w = _inputs(seed + 1, b, k, n)
    v_fs = np.float32(64 * 128 * 128 * 0.3)
    got = tops.cim_macro_matmul(_t(a), _t(w), ts, torch.tensor(v_fs), tcfg,
                                relu=True).numpy()
    sim, _ = tmacro.cim_matmul_sim(_t(a), _t(w), _sim_chip(ts, tcfg),
                                   torch.tensor(v_fs), tcfg, relu=True)
    np.testing.assert_array_equal(got, sim.numpy().astype(np.int32))
    jax_op = np.asarray(j_cmm(jnp.asarray(a), jnp.asarray(w), js,
                              jnp.float32(v_fs), jcfg, relu=True, bm=8,
                              bn=8))
    assert codes_within(got, jax_op)


@pytest.mark.parametrize("k", [27, 1152, 2304 + 100])
def test_vgg_row_tiles_match_sim(k):
    """At the macro's 1152 rows, with mostly padded tiles (conv1's K = 27,
    a 100-row last tile), the op agrees with the port's simulation and
    with JAX's op within the code tolerance."""
    jcfg, tcfg = _configs(1152)
    js, ts = _carried_chip(k, jcfg)
    a, w = _inputs(k, 16, k, 24)
    v_fs = np.float32(0.02 * 1152 * 127 * 127)
    for relu in (False, True):
        got = tops.cim_macro_matmul(_t(a), _t(w), ts, torch.tensor(v_fs),
                                    tcfg, relu=relu).numpy()
        sim, _ = tmacro.cim_matmul_sim(_t(a), _t(w), _sim_chip(ts, tcfg),
                                       torch.tensor(v_fs), tcfg, relu=relu)
        assert codes_within(got, sim.numpy())
        jax_op = np.asarray(j_cmm(jnp.asarray(a), jnp.asarray(w), js,
                                  jnp.float32(v_fs), jcfg, relu=relu, bm=8,
                                  bn=8))
        assert codes_within(got, jax_op)


def test_ideal_chip_is_quantized_exact_mac():
    tcfg = tmacro.MacroConfig(rows=128)
    a, w = _inputs(5, 8, 128, 16)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    v_fs = np.float32(np.abs(exact).max() * 1.05)
    got = tops.cim_macro_matmul(_t(a), _t(w), tmacro.ideal_chip(tcfg),
                                torch.tensor(v_fs), tcfg, relu=False)
    lsb = float(v_fs) / 128.0
    err = np.abs(got.numpy() * lsb - exact) / lsb
    assert err.max() <= 0.5 + 1e-6


def test_plain_tile_structure():
    """caat_mac_plain on one tile: the folded planes are the correctly
    rounded fold, the strided tile view equals a contiguous copy, and the
    ReLU flag is read from the scalars."""
    jcfg, tcfg = _configs(64)
    _, ts = _carried_chip(7, jcfg)
    a, w = _inputs(7, 6, 128, 10)
    w_eff, off = tcaat.effective_linear_weights(ts["caat"])
    bits = tnum.encode_pm1(_t(a))
    a_fold = tops.fold_planes(bits, w_eff)
    ref = np.einsum("bmk,ki->ibm", bits.numpy().astype(np.float64),
                    w_eff.numpy()).astype(np.float32)
    np.testing.assert_array_equal(a_fold.numpy(), ref)
    w_bits = tnum.encode_pm1(_t(w)).permute(2, 0, 1).contiguous()
    for relu in (0.0, 1.0):
        scalars = torch.tensor([1 / 64, float(off), 3.0, relu])
        view = tops.caat_mac_plain(a_fold[:, :, 64:], w_bits[:, 64:],
                                   scalars)
        copy = tops.caat_mac_plain(a_fold[:, :, 64:].contiguous(),
                                   w_bits[:, 64:].contiguous(), scalars)
        assert torch.equal(view, copy)
        assert bool((view < 0).any()) == (relu == 0.0)
