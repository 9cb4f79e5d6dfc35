"""Port parity: VGG-8 (the paper's Fig. 10 model) on the port against the
JAX package -- config, calibration passes, freeze, logits under the float
and int8 plans, the ragged K1 shapes -- at a reduced size (8x8 images, 2
of them) with the published channel widths.  Master weights and scales
cross through numpy.  The cim plan and the fig10 flow are in
test_torch_vgg_cim.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vgg8_cifar10 as jcfg_mod
from repro.core import backend as jb
from repro.core import macro as jm
from repro.kernels.cim_matmul import cim_matmul as j_cim_matmul
from repro.kernels.cim_matmul import cim_matmul_ref as j_cim_matmul_ref
from repro.models import vgg as jv
from repro_torch import convert
from repro_torch.configs import vgg8_cifar10 as tcfg_mod
from repro_torch.core import backend as tb
from repro_torch.data import synthetic
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.models import vgg as tv


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = jv.Vgg8Config(image_size=8), tv.Vgg8Config(image_size=8)
    params = jv.init_vgg8(jax.random.PRNGKey(0), cfg_j)
    imgs = jax.random.uniform(jax.random.PRNGKey(1), (2, 8, 8, 3))
    a_scales = jv.collect_activation_scales(params, imgs, cfg_j)
    t_params = convert.vgg_params_from_jax(_np(params))
    t_scales = [_t(s) for s in _np(a_scales)]
    # The port's full scales: equal to JAX's (test_calibration_passes).
    v_fs = tv.calibrate_v_fs(t_params, cfg_t, t_scales, _t(imgs))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params=params, imgs=imgs,
                a_scales=a_scales, v_fs=v_fs, t_params=t_params,
                t_imgs=_t(imgs), t_scales=t_scales)


def test_config_and_specs_match():
    assert dataclasses.asdict(tcfg_mod.config()) == \
        dataclasses.asdict(jcfg_mod.config())
    plan_t = tb.DeploymentPlan(rules=(("conv*", "cim"), ("head", "exact")),
                               default="w8a8_kernel")
    plan_j = jb.DeploymentPlan(rules=(("conv*", "cim"), ("head", "exact")),
                               default="w8a8_kernel")
    cfg_t, cfg_j = tcfg_mod.config(), jcfg_mod.config()
    for st, sj in zip(tv.resolve_specs(cfg_t, plan_t),
                      jv.resolve_specs(cfg_j, plan_j)):
        assert (st.in_dim, st.out_dim, st.use_bias, st.relu, st.mode,
                st.macro.rows) == (sj.in_dim, sj.out_dim, sj.use_bias,
                                   sj.relu, sj.mode, sj.macro.rows)
    assert [s.in_dim for s in cfg_t.layer_specs()] == \
        [27, 1152, 1152, 2304, 2304, 4608, 8192, 1024]


def test_calibration_passes_match_jax(setup):
    """Static activation scales (bf16 exact forward, absmax) and the
    per-tile MAC quantile full scales (exact integer partial sums)."""
    s = setup
    got = tv.collect_activation_scales(s["t_params"], s["t_imgs"],
                                       s["cfg_t"])
    for g, w in zip(got, s["a_scales"]):
        assert float(g) == pytest.approx(float(w), rel=1e-6)
    want = jv.calibrate_v_fs(s["params"], s["cfg_j"], s["a_scales"],
                             s["imgs"])
    assert s["v_fs"] == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("mode", ["w8a8", "bitserial", "cim"])
def test_freeze_bit_exact(setup, mode):
    """The same master weights and scales freeze to identical int8 codes
    and scales (and full scales / fine-tune leaves for cim) in every
    VGG-8 layer."""
    s = setup
    kw_j, kw_t = {}, {}
    if mode == "cim":
        mcfg = jm.nominal_config(rows=1152)
        chips = [_np(jm.sample_chip(jax.random.PRNGKey(100 + i), mcfg))
                 for i in range(8)]
        kw_j = dict(chips=chips, v_fs_list=s["v_fs"])
        kw_t = dict(chips=[convert.chip_from_jax(c) for c in chips],
                    v_fs_list=s["v_fs"])
    fj = _np(jv.freeze_vgg8(s["params"], s["cfg_j"], s["a_scales"],
                            mode=mode, **kw_j))
    ft = tv.freeze_vgg8(s["t_params"], s["cfg_t"], s["t_scales"], mode=mode,
                        **kw_t)
    for lj, lt in zip(fj, ft):
        assert set(lt) == set(lj)
        for key in ("w_q", "w_scale", "a_scale", "b", "v_fs_mac", "ft_gain",
                    "ft_offset"):
            if key in lj:
                np.testing.assert_array_equal(lt[key].numpy(), lj[key])
    carried = convert.vgg_params_from_jax(fj)
    for lc, lt in zip(carried, ft):
        for key, v in lt.items():
            if key != "chip":
                assert torch.equal(lc[key], v)


PLANS = {
    "exact": ("exact", False),
    "w8a8": ("w8a8", False),
    "w8a8_kernel": ("w8a8_kernel", False),
    "w8a8_kernel+residency": ("w8a8_kernel", True),
    "bitserial": ("bitserial", False),
    "bitserial_kernel": ("bitserial_kernel", False),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_logits_match_jax(setup, name):
    """Logits of each plan against the same plan's JAX logits.  The int8
    plans are integer math with the reference's f32 epilogue order: equal
    bit for bit to JAX's plain plans.  JAX's jitted kernel wrappers may
    contract the bias epilogue into an FMA (one f32 ulp), which can move a
    requantized code by one: against those, 1% of the logit range.  exact
    runs bf16 matmuls on both sides: one bf16 ulp (2**-8) of the range."""
    s = setup
    backend, residency = PLANS[name]
    plan_j = jb.DeploymentPlan(default=backend, residency=residency)
    plan_t = tb.DeploymentPlan(default=backend, residency=residency)
    if backend == "exact":
        fj, ft = s["params"], s["t_params"]
    else:
        fj = jv.freeze_vgg8(s["params"], s["cfg_j"], s["a_scales"],
                            mode=backend)
        ft = convert.vgg_params_from_jax(_np(fj))
    got = tv.vgg8_forward(ft, s["t_imgs"], s["cfg_t"], mode=plan_t,
                          a_scales=s["t_scales"]).numpy()
    want = np.asarray(jv.vgg8_forward(fj, s["imgs"], s["cfg_j"], mode=plan_j,
                                      a_scales=s["a_scales"]))
    scale = np.abs(want).max()
    if backend == "exact":
        np.testing.assert_allclose(got, want, rtol=0, atol=2**-8 * scale)
        return
    plain = backend.removesuffix("_kernel")
    oracle = np.asarray(jv.vgg8_forward(fj, s["imgs"], s["cfg_j"],
                                        mode=plain, a_scales=s["a_scales"]))
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.01 * scale)


@pytest.mark.parametrize("relu", [False, True])
def test_k1_ragged_vgg_shapes_through_wrapper(relu):
    """VGG-8's conv1 (K = 27) and head (N = 10) through the port's
    cim_matmul wrapper against JAX's: bit-exact bias-free (JAX's
    interpret kernel) and with a bias (JAX's oracle; its interpreter
    contracts the bias epilogue into an FMA)."""
    rng = np.random.default_rng(27)
    for m, k, n in ((64, 27, 128), (4, 1024, 10)):
        a = rng.uniform(-0.5, 1.5, (m, k)).astype(np.float32)
        w = rng.integers(-127, 128, (k, n)).astype(np.int8)
        w_s = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
        bias = rng.standard_normal(n).astype(np.float32)
        a_s = np.float32(0.02)
        got = cim_ops.cim_matmul(_t(a), _t(w), torch.tensor(a_s), _t(w_s),
                                 relu=relu)
        want = j_cim_matmul(jnp.asarray(a), jnp.asarray(w), jnp.asarray(a_s),
                            jnp.asarray(w_s), relu=relu)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        a_q = np.clip(np.round(a / a_s), -128, 127).astype(np.int8)
        got = cim_ops.cim_matmul(_t(a_q), _t(w), torch.tensor(a_s), _t(w_s),
                                 _t(bias), relu=relu)
        want = j_cim_matmul_ref(jnp.asarray(a_q), jnp.asarray(w),
                                jnp.asarray(a_s), jnp.asarray(w_s),
                                jnp.asarray(bias), jnp.float32(1.0),
                                relu=relu)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_synthetic_cifar():
    imgs, labels = synthetic.synthetic_cifar(
        torch.Generator().manual_seed(0), 16)
    assert imgs.shape == (16, 32, 32, 3) and labels.shape == (16,)
    assert float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0
    assert 0.35 < float(imgs.mean()) < 0.65
    assert int(labels.min()) >= 0 and int(labels.max()) < 10


def test_qat_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tb.get_backend("qat")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tb.LinearSpec(4, 4, mode="qat")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tb.load_plan("qat")
    with pytest.raises(KeyError):
        tb.get_backend("no_such_backend")
