"""Port parity: the paper-side datapath (numerics, CAAT, ADC, macro
simulation, output fine-tune, energy model) against the JAX package on
identical inputs.  Sampled chips are drawn once by JAX and carried across
(``convert.chip_from_jax``), since jax.random and torch.Generator draw
different numbers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import caat as jcaat
from repro.core import calibration as jcal
from repro.core import energy as jenergy
from repro.core import macro as jmacro
from repro.core import numerics as jnum
from repro_torch import convert
from repro_torch.core import adc as tadc
from repro_torch.core import caat as tcaat
from repro_torch.core import calibration as tcal
from repro_torch.core import energy as tenergy
from repro_torch.core import macro as tmacro
from repro_torch.core import numerics as tnum

F32_EPS = float(np.finfo(np.float32).eps)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _chip(rows=128, seed=3):
    cfg = jmacro.nominal_config(rows=rows)
    sample = _np(jmacro.sample_chip(jax.random.PRNGKey(seed), cfg))
    return cfg, tmacro.nominal_config(rows=rows), sample, \
        convert.chip_from_jax(sample)


def code_share_ok(got, want):
    """The macro-code tolerance: |diff| <= 1 on at most 1e-3 of the
    outputs (f32 rounding at .5 boundaries; see kernels/caat_mac)."""
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    return d.max(initial=0) <= 1 and (d > 0).mean() <= 1e-3


def test_numerics_bit_exact():
    x = np.arange(-128, 128, dtype=np.int32)
    bits_j = np.asarray(jnum.encode_pm1(jnp.asarray(x)))
    bits_t = tnum.encode_pm1(_t(x))
    np.testing.assert_array_equal(bits_t.numpy(), bits_j)
    np.testing.assert_array_equal(tnum.decode_pm1(bits_t).numpy(), x)
    np.testing.assert_array_equal(
        tnum.decode_pm1(bits_t).numpy(),
        np.asarray(jnum.decode_pm1(jnp.asarray(bits_j))))
    planes_j = np.asarray(jnum.encode_twos_complement_planes(jnp.asarray(x)))
    planes_t = tnum.encode_twos_complement_planes(_t(x))
    np.testing.assert_array_equal(planes_t.numpy(), planes_j)
    np.testing.assert_array_equal(
        tnum.decode_twos_complement_planes(planes_t).numpy(), x)
    for nbits in (4, 8):
        np.testing.assert_array_equal(tnum.bit_weights(nbits),
                                      jnum.bit_weights(nbits))
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, (9, 300)).astype(np.int8)
    w = rng.integers(-128, 128, (300, 7)).astype(np.int8)
    np.testing.assert_array_equal(
        tnum.exact_int_matmul(_t(a), _t(w)).numpy(),
        np.asarray(jnum.exact_int_matmul(jnp.asarray(a), jnp.asarray(w))))


@pytest.mark.parametrize("seed", [0, 3])
def test_caat_on_carried_chip(seed):
    """caat_combine, effective_linear_weights and the INL sweep agree with
    JAX to f32 resolution: the port combines in float64 and rounds once,
    JAX in f32, so they differ by a few f32 ulps of the O(1) column
    averages."""
    jcfg, tcfg, js, ts = _chip(seed=seed)
    rng = np.random.default_rng(seed)
    v_col = rng.uniform(-1, 1, (500, 9, 9)).astype(np.float32)
    rj = np.asarray(jcaat.caat_combine(jnp.asarray(v_col), js["caat"]))
    rt = tcaat.caat_combine(_t(v_col), ts["caat"]).numpy()
    assert np.abs(rt - rj).max() <= 4 * F32_EPS * np.abs(v_col).max()
    we_j, off_j = jcaat.effective_linear_weights(js["caat"])
    we_t, off_t = tcaat.effective_linear_weights(ts["caat"])
    np.testing.assert_allclose(we_t.numpy(), np.asarray(we_j), rtol=1e-6)
    np.testing.assert_allclose(off_t.numpy(), np.asarray(off_j), rtol=1e-6,
                               atol=1e-9)
    # The collapse is the combine: v_root = <W_eff, v_col> + offset.
    folded = np.einsum("bki,ki->b", v_col.astype(np.float64),
                       we_t.numpy()) + off_t.item()
    np.testing.assert_allclose(rt, folded, rtol=0,
                               atol=4 * F32_EPS * np.abs(folded).max())
    # INL in LSB: an f32 ulp of the transfer curve over its LSB.
    codes = np.arange(-128, 128)
    v = np.asarray(jcaat.caat_transfer(jnp.asarray(codes), js["caat"],
                                       jcfg.caat))
    lsb = (v[-1] - v[0]) / 255
    inl_j = jcaat.caat_inl(js["caat"], jcfg.caat)
    inl_t = tcaat.caat_inl(ts["caat"], tcfg.caat)
    assert np.abs(inl_t - inl_j).max() <= 4 * F32_EPS / lsb
    assert abs(tcaat.caat_effective_bits(ts["caat"], tcfg.caat)
               - jcaat.caat_effective_bits(js["caat"], jcfg.caat)) <= 1e-3
    for nb in (4, 8, 10):
        assert tcaat.capacitor_total_binary(nb) == \
            jcaat.capacitor_total_binary(nb)
        assert tcaat.capacitor_total_hybrid(nb) == \
            jcaat.capacitor_total_hybrid(nb)


def test_ideal_chips_equal():
    jcfg, tcfg = jmacro.MacroConfig(), tmacro.MacroConfig()
    jc, tc = _np(jmacro.ideal_chip(jcfg)), tmacro.ideal_chip(tcfg)
    for part in ("caat", "adc"):
        for k, v in jc[part].items():
            np.testing.assert_array_equal(tc[part][k].numpy(), v)
    assert tcfg.act_sum == jcfg.act_sum == 128.0


@pytest.mark.parametrize("relu", [False, True])
def test_adc_convert_bit_exact(relu):
    """ADC codes are bit-exact for the same voltage, exact .5 boundaries
    included (both round half to even)."""
    cfg = jadc.AdcConfig(max_inl_lsb=1.2)
    sample = _np(jadc.sample_adc(jax.random.PRNGKey(5), cfg))
    tcfg = tadc.AdcConfig(max_inl_lsb=1.2)
    ts = {"inl_lut": _t(sample["inl_lut"])}
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.uniform(-1.2, 1.2, 5000),
                        (np.arange(-130, 130) + 0.5) / 128]).astype(
                            np.float32)
    cj, nj = jadc.convert(jnp.asarray(v), sample, cfg, relu=relu)
    ct, nt = tadc.convert(_t(v), ts, tcfg, relu=relu)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert float(nt) == pytest.approx(float(nj), rel=1e-6)
    np.testing.assert_array_equal(tadc.adc_inl(ts, tcfg),
                                  jadc.adc_inl(sample, cfg))
    for neg in (0.0, 0.55):
        assert float(tadc.average_conversion_cycles(neg, tcfg)) == \
            pytest.approx(float(jadc.average_conversion_cycles(neg, cfg)))


def test_port_samplers_draw_the_nominal_distribution():
    """The port's own chips come from a torch.Generator: other numbers
    than JAX's, the same structure (shapes, the binary section
    unattenuated, the INL peak)."""
    tcfg = tmacro.nominal_config(rows=64)
    chip = tmacro.sample_chip(torch.Generator().manual_seed(0), tcfg)
    ideal = tmacro.ideal_chip(tcfg)
    for part in ("caat", "adc"):
        for k, v in ideal[part].items():
            assert chip[part][k].shape == v.shape
            assert chip[part][k].dtype == torch.float32
    rel = chip["caat"]["bank_w"] / ideal["caat"]["bank_w"] - 1
    assert rel.abs().max() < 0.02
    assert chip["adc"]["inl_lut"].abs().max().item() == pytest.approx(1.2)


@pytest.mark.parametrize("rows,k", [(128, 256), (128, 261), (96, 96)])
@pytest.mark.parametrize("relu", [False, True])
def test_cim_matmul_sim_codes(rows, k, relu):
    """Macro simulation codes on a carried chip (CAAT mismatch and ADC
    INL): equal to JAX's, or within the code tolerance where JAX's f32
    combine rounds a code the other way (261 = two full tiles + a mostly
    padded one)."""
    jcfg, tcfg, js, ts = _chip(rows=rows, seed=rows)
    rng = np.random.default_rng(k)
    a = rng.integers(-128, 128, (48, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, 40)).astype(np.int8)
    v_fs = np.float32(rows * 127 * 127 * 0.05)
    cj, sj = jmacro.cim_matmul_sim(jnp.asarray(a), jnp.asarray(w), js,
                                   jnp.float32(v_fs), jcfg, relu=relu)
    ct, st = tmacro.cim_matmul_sim(_t(a), _t(w), ts, torch.tensor(v_fs),
                                   tcfg, relu=relu)
    assert code_share_ok(ct.numpy(), np.asarray(cj))
    for key in ("n_conversions", "relu_fused", "n_tiles"):
        assert float(st[key]) == float(sj[key])
    assert float(st["neg_fraction"]) == pytest.approx(
        float(sj["neg_fraction"]), abs=2 / (48 * 40))
    assert tmacro.default_v_fs(127.0, 127.0, k, rows) == \
        jmacro.default_v_fs(127.0, 127.0, k, rows)


@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
def test_fit_finetune(granularity):
    rng = np.random.default_rng(2)
    ideal = rng.standard_normal((64, 16)).astype(np.float32) * 3 + 1
    measured = (ideal * 0.9 + 0.2 + rng.standard_normal((64, 16)) * 0.1
                ).astype(np.float32)
    fj = jcal.fit_finetune(jnp.asarray(ideal), jnp.asarray(measured),
                           granularity)
    ft = tcal.fit_finetune(_t(ideal), _t(measured), granularity)
    np.testing.assert_allclose(ft.gain.numpy(), np.asarray(fj.gain),
                               rtol=1e-6)
    np.testing.assert_allclose(ft.offset.numpy(), np.asarray(fj.offset),
                               rtol=1e-6, atol=1e-6)
    carried = convert.finetune_from_jax(fj)
    np.testing.assert_array_equal(carried.apply(_t(measured)).numpy(),
                                  np.asarray(fj.apply(jnp.asarray(measured))))
    scale, bias = np.float32(0.5), np.float32(0.25)
    for a, b in zip(carried.fold_into(torch.tensor(scale), torch.tensor(bias)),
                    fj.fold_into(jnp.asarray(scale), jnp.asarray(bias))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tcal.fit_finetune(_t(ideal), _t(measured), "per_row")
    ident = tcal.identity_finetune()
    assert float(ident.gain) == 1.0 and float(ident.offset) == 0.0


def test_energy_model_equal():
    assert tenergy._power_fit() == jenergy._power_fit()
    for v, f in ((1.0, 1e9), (0.8, 7e8), (0.76, 2.4e8)):
        assert tenergy.tops_per_watt(v, f) == jenergy.tops_per_watt(v, f)
        assert tenergy.energy_per_conversion_joules(v, f) == \
            jenergy.energy_per_conversion_joules(v, f)
    assert dataclasses.asdict(tenergy.breakdown(neg_fraction=0.4)) == \
        dataclasses.asdict(jenergy.breakdown(neg_fraction=0.4))
    assert tenergy.latency_breakdown_ns() == jenergy.latency_breakdown_ns()
    assert tenergy.area_breakdown_mm2(2.0) == jenergy.area_breakdown_mm2(2.0)
    assert tenergy.capacitor_area_curve() == jenergy.capacitor_area_curve()
    for fused in (True, False):
        assert tenergy.workload_energy_joules(1e6, 0.3, fused) == \
            jenergy.workload_energy_joules(1e6, 0.3, fused)
