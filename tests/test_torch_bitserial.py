"""Port parity: the bit-serial baseline (kernel K4's plain version, the
8-pass shift-add wrapper, the plain ``bitserial`` path with per-plane ADCs
and both backends) bit-exact against the JAX package on identical numpy
inputs.  The JAX kernel runs as its own tests run it: in interpret mode at
small blocks."""
import dataclasses

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jb
from repro.core import quant as jq
from repro.kernels.bitserial_matmul import ops as jops
from repro.kernels.bitserial_matmul.kernel import bitplane_matmul_kernel
from repro.kernels.bitserial_matmul.ref import (bitplane_matmul_ref,
                                                bitserial_matmul_ref)
from repro_torch import convert
from repro_torch.core import backend as tb
from repro_torch.core import quant as tq
from repro_torch.kernels.bitserial_matmul import ops as tops
from repro_torch.kernels.bitserial_matmul import ref as tref


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    return a, w


@pytest.mark.parametrize("plane", range(8))
def test_plane_plain_matches_jax(plane):
    """K4's plain version == the JAX oracle == the JAX kernel
    (interpret), per plane."""
    a, w = _inputs(plane, 32, 128, 64)
    want = np.asarray(bitplane_matmul_ref(jnp.asarray(a), jnp.asarray(w),
                                          plane))
    got = tops.bitplane_matmul(_t(a), _t(w), plane)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(bitplane_matmul_kernel(
            jnp.asarray(a), jnp.asarray(w), plane=plane, bm=32, bn=64,
            bk=64, interpret=True)))
    np.testing.assert_array_equal(
        tref.bitplane_matmul_ref(_t(a), _t(w), plane).numpy(), want)


@hypothesis.given(seed=st.integers(0, 2**16), m=st.integers(1, 40),
                  k=st.integers(1, 200), n=st.integers(1, 70))
@hypothesis.settings(max_examples=6, deadline=None)
def test_property_bitserial_matmul_bit_exact(seed, m, k, n):
    """The 8-pass wrapper (plain planes on CPU) == JAX's wrapper over its
    interpret kernel, bit for bit, at ragged M/K/N.  With a bias it equals
    JAX's unjitted oracle bit for bit and the jitted wrapper within one
    f32 ulp: XLA contracts that wrapper's ``acc * scale + bias`` into an
    FMA, the oracle and the port do not."""
    a, w = _inputs(seed, m, k, n)
    rng = np.random.default_rng(seed + 1)
    w_s = rng.uniform(0.01, 0.1, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    a_s = np.float32(0.03)
    want = jops.bitserial_matmul(jnp.asarray(a), jnp.asarray(w),
                                 jnp.asarray(a_s), jnp.asarray(w_s),
                                 bm=16, bn=32, bk=64)
    got = tops.bitserial_matmul(_t(a), _t(w), torch.tensor(a_s), _t(w_s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    args_j = (jnp.asarray(a), jnp.asarray(w), jnp.asarray(a_s),
              jnp.asarray(w_s), jnp.asarray(bias))
    got = tops.bitserial_matmul(_t(a), _t(w), torch.tensor(a_s), _t(w_s),
                                _t(bias), relu=True).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(bitserial_matmul_ref(*args_j, relu=True)))
    fused = np.asarray(jops.bitserial_matmul(*args_j, relu=True, bm=16,
                                             bn=32, bk=64))
    np.testing.assert_allclose(got, fused, rtol=0,
                               atol=float(np.spacing(np.abs(fused).max())))


def test_bitserial_ref_and_leading_dims():
    a, w = _inputs(7, 24, 96, 24)
    rng = np.random.default_rng(8)
    w_s = rng.uniform(0.01, 0.1, 24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    args_j = (jnp.asarray(a), jnp.asarray(w), jnp.float32(0.03),
              jnp.asarray(w_s), jnp.asarray(bias))
    args_t = (_t(a), _t(w), torch.tensor(np.float32(0.03)), _t(w_s),
              _t(bias))
    want = np.asarray(bitserial_matmul_ref(*args_j, relu=True))
    np.testing.assert_array_equal(
        tref.bitserial_matmul_ref(*args_t, relu=True).numpy(), want)
    got = tops.bitserial_matmul(args_t[0].reshape(2, 12, 96), *args_t[1:],
                                relu=True)
    np.testing.assert_array_equal(got.reshape(24, 24).numpy(), want)


def test_shift_add_rounds_like_jax_past_2_24():
    """At VGG-8's conv6 depth (K = 4608) the f32 shift-add passes 2**24
    and rounds; the port adds in the reference's order and keeps every
    bit.  Here a = -1 sets every plane, and the planes 0..6 sum to 127 x
    an odd partial sum of 585215, past 2**24."""
    a = np.full((4, 4608), -1, np.int8)
    w = np.full((4608, 8), 127, np.int8)
    w[0] = 126
    ones = np.ones(8, np.float32)
    args = (jnp.asarray(a), jnp.asarray(w), jnp.float32(1.0),
            jnp.asarray(ones))
    want = np.asarray(jq.bitserial_matmul(*args))
    exact = a.astype(np.int64) @ w.astype(np.int64)
    assert not np.array_equal(want, exact)
    got = tq.bitserial_matmul(_t(a), _t(w), torch.tensor(1.0), _t(ones))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.bitserial_matmul(_t(a), _t(w), torch.tensor(1.0),
                              _t(ones)).numpy(), want)


@pytest.mark.parametrize("plane_bits,dynamic", [(None, False), (8, False),
                                                (6, False), (8, True)])
def test_plain_bitserial_with_plane_adc(plane_bits, dynamic):
    """quant.bitserial_matmul with per-plane ADCs (static calibrated full
    scales, or the runtime autorange) and calibrate_plane_full_scale."""
    a, w = _inputs(11, 16, 72, 20)
    calib, _ = _inputs(12, 32, 72, 20)
    fs_j = jq.calibrate_plane_full_scale(jnp.asarray(calib), jnp.asarray(w))
    fs_t = tq.calibrate_plane_full_scale(_t(calib), _t(w))
    np.testing.assert_array_equal(fs_t.numpy(), np.asarray(fs_j))
    rng = np.random.default_rng(13)
    w_s = rng.uniform(0.01, 0.1, 20).astype(np.float32)
    kw_j = dict(plane_adc_bits=plane_bits, dynamic_plane_fs=dynamic,
                plane_full_scale=None if dynamic or plane_bits is None
                else fs_j)
    kw_t = dict(kw_j, plane_full_scale=None if kw_j["plane_full_scale"]
                is None else fs_t)
    want = jq.bitserial_matmul(jnp.asarray(a), jnp.asarray(w),
                               jnp.float32(0.05), jnp.asarray(w_s),
                               relu=True, **kw_j)
    got = tq.bitserial_matmul(_t(a), _t(w), torch.tensor(np.float32(0.05)),
                              _t(w_s), relu=True, **kw_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if plane_bits is not None and not dynamic:
        with pytest.raises(ValueError, match="static plane_full_scale"):
            tq.bitserial_matmul(_t(a), _t(w), torch.tensor(0.05), _t(w_s),
                                plane_adc_bits=plane_bits)


@pytest.mark.parametrize("mode,plane_bits", [("bitserial", None),
                                             ("bitserial", 8),
                                             ("bitserial_kernel", None)])
def test_bitserial_backends_bit_exact(mode, plane_bits):
    """Freeze (with calibrated plane full scales) and apply through the
    backend registry, stats included, against the JAX backends; an int8
    output grid (residency) too.  Both port backends equal JAX's plain
    ``bitserial`` bit for bit; JAX's ``bitserial_kernel`` contracts its
    bias epilogue into an FMA (one f32 ulp, see the property test)."""
    rng = np.random.default_rng(21)
    master = {"w": rng.standard_normal((40, 24)).astype(np.float32) * 0.2,
              "b": rng.standard_normal(24).astype(np.float32)}
    x = rng.standard_normal((2, 6, 40)).astype(np.float32)
    calib = rng.integers(-128, 128, (16, 40)).astype(np.int8)
    spec_j = jb.LinearSpec(40, 24, use_bias=True, relu=True, mode=mode,
                           plane_adc_bits=plane_bits)
    spec_t = tb.LinearSpec(40, 24, use_bias=True, relu=True, mode=mode,
                           plane_adc_bits=plane_bits)
    fj = jb.get_backend(mode).freeze(
        jax.tree.map(jnp.asarray, master), spec_j, 0.04,
        calib_a_q=jnp.asarray(calib))
    ft = tb.get_backend(mode).freeze(
        {k: _t(v) for k, v in master.items()}, spec_t, 0.04,
        calib_a_q=_t(calib))
    assert set(ft) == set(fj)
    for key in fj:
        np.testing.assert_array_equal(ft[key].numpy(), np.asarray(fj[key]))
    ft = convert.vgg_params_from_jax([jax.tree.map(np.asarray, fj)])[0]
    yj, sj = jb.get_backend(mode).apply(fj, jnp.asarray(x), spec_j,
                                        return_stats=True)
    yt, st_ = tb.get_backend(mode).apply(ft, _t(x), spec_t,
                                         return_stats=True)
    oracle = jb.get_backend("bitserial").apply(
        fj, jnp.asarray(x), dataclasses.replace(spec_j, mode="bitserial"))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(oracle))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=float(np.spacing(np.abs(yj).max())))
    assert {k: float(v) for k, v in st_.items()} == \
        {k: float(v) for k, v in sj.items()}
    out_scale = np.float32(0.02)
    qj = jb.get_backend(mode).apply(fj, jnp.asarray(x), spec_j,
                                    out_scale=jnp.asarray(out_scale))
    qt = tb.get_backend(mode).apply(ft, _t(x), spec_t,
                                    out_scale=torch.tensor(out_scale))
    q_oracle = jb.get_backend("bitserial").apply(
        fj, jnp.asarray(x), dataclasses.replace(spec_j, mode="bitserial"),
        out_scale=jnp.asarray(out_scale))
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(q_oracle.q))
    assert np.abs(qt.q.numpy().astype(int) - np.asarray(qj.q)).max() <= 1
    stats_spec = dataclasses.replace(spec_t, in_dim=1152)
    assert tb.get_backend(mode).stats(stats_spec, 4) == \
        jb.get_backend(mode).stats(dataclasses.replace(spec_j, in_dim=1152),
                                   4)
    assert tb.get_backend(mode).flops_per_byte(spec_t, 8) == \
        jb.get_backend(mode).flops_per_byte(spec_j, 8)
