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
    """caat_mac_plain on one tile of the packed operands: the weight
    planes sit where the kernel reads them, the strided row-tile view of
    the activations equals a contiguous copy, and the ReLU flag is read
    from the scalars."""
    jcfg, tcfg = _configs(64)
    _, ts = _carried_chip(7, jcfg)
    a, w = _inputs(7, 6, 128, 10)
    w_eff, off = tcaat.effective_linear_weights(ts["caat"])
    w_planes, w_sum = tops.pack_weight_planes(_t(w), 64)
    assert tuple(w_planes.shape) == (2, 1, 8, tops.COLS, 64)
    assert tuple(w_sum.shape) == (2, 8, 10)
    bits = tnum.encode_pm1(_t(w)).numpy()                    # [K, N, 9]
    want = np.zeros((2, 1, 8, tops.COLS, 64), np.int8)
    want[:, 0, :, :10] = bits[..., :8].reshape(2, 64, 10, 8).transpose(
        0, 3, 2, 1)
    np.testing.assert_array_equal(w_planes.numpy(), want)
    a_t = _t(a)
    for relu in (0.0, 1.0):
        scalars = torch.tensor([1 / 64, float(off), 3.0, relu])
        view = tops.caat_mac_plain(a_t[:, 64:], w_planes[1], w_sum[1],
                                   w_eff, scalars)
        copy = tops.caat_mac_plain(a_t[:, 64:].contiguous(),
                                   w_planes[1].clone(), w_sum[1].clone(),
                                   w_eff, scalars)
        assert torch.equal(view, copy)
        assert bool((view < 0).any()) == (relu == 0.0)


def test_offset_binary_bit_rule_is_encode_pm1():
    """On all 256 int8 values: the bit rule of pm1_planes, and the
    kernel's form of it on packed 32-bit words (``y = ((x ^ 0x80808080) >>
    s) & 0x01010101``, then ``((y ^ 0x01010101) * 0xFF) | 0x01010101``),
    give encode_pm1's planes 0-7; plane 8 is -1 everywhere."""
    x = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    ref = tnum.encode_pm1(x)                                 # [256, 9]
    assert torch.equal(tops.pm1_planes(x).T, ref[:, :8])
    assert bool((ref[:, 8] == -1).all())
    words = x.numpy().view(np.uint32).astype(np.uint64)      # 64 words
    for k in range(8):
        s = 7 - k if k < 7 else 0
        y = ((words ^ 0x80808080) >> s) & 0x01010101
        pm = (((y ^ 0x01010101) * 0xFF) | 0x01010101) & 0xFFFFFFFF
        got = pm.astype(np.uint32).view(np.int8)
        np.testing.assert_array_equal(got, ref[:, k].numpy())


def test_constant_plane_shortcut_equals_81_products():
    """The constant plane 8 (all -1): count[k, 8] is minus the row sum of
    activation plane k, count[8, i] minus the packed column sum of weight
    plane i, count[8, 8] = R; the 64 others are the products of the
    offset-binary planes with the weight planes."""
    rows = 96
    a, w = _inputs(11, 7, rows, 70)
    ab = tnum.encode_pm1(_t(a)).numpy().astype(np.float64)   # [B, R, 9]
    wb = tnum.encode_pm1(_t(w)).numpy().astype(np.float64)   # [R, N, 9]
    count = np.einsum("brk,rni->kibn", ab, wb)
    planes = tops.pm1_planes(_t(a)).numpy().astype(np.float64)
    _, w_sum = tops.pack_weight_planes(_t(w), rows)
    np.testing.assert_array_equal(
        count[:8, :8], np.einsum("kbr,rni->kibn", planes, wb[..., :8]))
    np.testing.assert_array_equal(
        count[:8, 8], np.broadcast_to(-planes.sum(-1)[..., None],
                                      (8, 7, 70)))
    np.testing.assert_array_equal(
        count[8, :8], np.broadcast_to(-w_sum[0].numpy()[:, None],
                                      (8, 7, 70)))
    assert (count[8, 8] == rows).all()


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n", [10, 70])
@pytest.mark.parametrize("rows", [64, 96])
def test_plain_equals_81_plane_float64(rows, n, relu):
    """caat_mac_plain's codes equal a float64 evaluation over all 81
    encode_pm1 plane products with core.caat's W_eff, combined in the same
    order (k outer, i inner, no FMA) and converted the same way; and the
    op agrees with core.caat's float64 tree combine (the simulation)
    within the code tolerance."""
    jcfg, tcfg = _configs(rows)
    _, ts = _carried_chip(rows + n, jcfg)
    a, w = _inputs(rows + n, 9, rows, n)
    w_eff, off = tcaat.effective_linear_weights(ts["caat"])
    w_planes, w_sum = tops.pack_weight_planes(_t(w), rows)
    scalars = torch.tensor([1 / rows, float(off), 2.5, float(relu)])
    got = tops.caat_mac_plain(_t(a), w_planes[0], w_sum[0], w_eff, scalars)
    ab = tnum.encode_pm1(_t(a)).numpy().astype(np.float64)
    wb = tnum.encode_pm1(_t(w)).numpy().astype(np.float64)
    count = np.einsum("brk,rni->kibn", ab, wb)
    we = w_eff.numpy()
    acc = np.zeros((9, n))
    for k in range(9):
        for i in range(9):
            acc = acc + we[k, i] * count[k, i]
    v = (torch.from_numpy(acc).float() * scalars[0] + scalars[1]) \
        * scalars[2]
    want = torch.clamp(torch.round(v * 128.0), -128, 127)
    if relu:
        want = torch.clamp_min(want, 0.0)
    assert torch.equal(got, want.to(torch.int32))
    v_fs = torch.tensor(rows * 128 * 128 * 0.25)
    op = tops.cim_macro_matmul(_t(a), _t(w), ts, v_fs, tcfg, relu=relu)
    sim, _ = tmacro.cim_matmul_sim(_t(a), _t(w), _sim_chip(ts, tcfg), v_fs,
                                   tcfg, relu=relu)
    assert codes_within(op.numpy(), sim.numpy())
