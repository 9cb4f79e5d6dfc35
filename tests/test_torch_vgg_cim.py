"""Port parity: VGG-8's cim plan on the port against the JAX package --
logits on carried chips, full scales and fine-tunes (each layer held on
JAX's own input), the output fine-tune fit -- and the port's fig10 deploy
flow, at a reduced size (8x8 images, 2 of them) with the published channel
widths and macro_rows 1152 and 128."""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jb
from repro.core import macro as jm
from repro.models import vgg as jv
from repro_torch import convert
from repro_torch.core import backend as tb
from repro_torch.core import macro as tm
from repro_torch.launch import fig10
from repro_torch.models import vgg as tv

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite runs six files
    at once on the machine's cores, and with every thread the deploy
    flow ran 64x longer there than alone (358.7 s, 5.6 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = jv.Vgg8Config(image_size=8), tv.Vgg8Config(image_size=8)
    params = jv.init_vgg8(jax.random.PRNGKey(0), cfg_j)
    imgs = jax.random.uniform(jax.random.PRNGKey(1), (2, 8, 8, 3))
    a_scales = jv.collect_activation_scales(params, imgs, cfg_j)
    t_params = convert.vgg_params_from_jax(_np(params))
    t_scales = [_t(s) for s in _np(a_scales)]
    v_fs = tv.calibrate_v_fs(t_params, cfg_t, t_scales, _t(imgs))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params=params, imgs=imgs,
                a_scales=a_scales, v_fs=v_fs, t_params=t_params,
                t_imgs=_t(imgs), t_scales=t_scales)


@pytest.mark.parametrize("rows", [1152, 128])
def test_cim_logits_match_jax(setup, rows, monkeypatch):
    """The cim plan on carried chips, calibrated full scales and carried
    per-channel fine-tunes.  The port's macro simulation rounds the CAAT
    voltage once from float64, JAX's in f32, so a code can differ by one
    where a voltage lands within an ulp of a .5 boundary, and a flipped
    code moves everything downstream.  So every layer is held on JAX's
    own input to the code tolerance (|diff| <= 1 on at most 1e-3 of the
    outputs), and the logits to f32 resolution when no code flipped."""
    s = setup
    cfg_j = jv.Vgg8Config(image_size=8, macro_rows=rows)
    cfg_t = tv.Vgg8Config(image_size=8, macro_rows=rows)
    mcfg_t = tm.nominal_config(rows=rows)
    chips = [jm.sample_chip(jax.random.PRNGKey(100 + i), jm.nominal_config(
        rows=rows)) for i in range(8)]
    t_chips = [convert.chip_from_jax(_np(c)) for c in chips]
    rng = np.random.default_rng(rows)
    fts_j = [type("FT", (), dict(
        gain=jnp.asarray(rng.uniform(0.9, 1.1, sp.out_dim), jnp.float32),
        offset=jnp.asarray(rng.normal(0, 1e-3, sp.out_dim), jnp.float32)))
        for sp in cfg_j.layer_specs()]
    fj = jv.freeze_vgg8(s["params"], cfg_j, s["a_scales"], chips=chips,
                        finetunes=fts_j, mode="cim", v_fs_list=s["v_fs"])
    ft = tv.freeze_vgg8(s["t_params"], cfg_t, s["t_scales"], chips=t_chips,
                        finetunes=[convert.finetune_from_jax(f)
                                   for f in fts_j],
                        mode="cim", v_fs_list=s["v_fs"])
    for lj, lt in zip(_np(fj), ft):
        for key in ("ft_gain", "ft_offset", "v_fs_mac"):
            np.testing.assert_array_equal(lt[key].numpy(), lj[key])
    calls = []
    sim = jb.macro_lib.cim_matmul_sim

    def recording(a, w, chip, v_fs, cfg, relu=True):
        out = sim(a, w, chip, v_fs, cfg, relu=relu)
        calls.append((np.asarray(a), np.asarray(w), np.asarray(v_fs), relu,
                      np.asarray(out[0])))
        return out

    monkeypatch.setattr(jb.macro_lib, "cim_matmul_sim", recording)
    want = np.asarray(jv.vgg8_forward(fj, s["imgs"], cfg_j, mode="cim",
                                      a_scales=s["a_scales"], chips=chips))
    assert len(calls) == 8
    flips = 0
    for (a, w, v_fs, relu, codes_j), chip in zip(calls, t_chips):
        codes_t, _ = tm.cim_matmul_sim(_t(a), _t(w), chip, _t(v_fs), mcfg_t,
                                       relu=relu)
        d = np.abs(codes_t.numpy() - codes_j)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        flips += int((d > 0).sum())
    stats: list = []
    got = tv.vgg8_forward(ft, s["t_imgs"], cfg_t, mode="cim",
                          a_scales=s["t_scales"], chips=t_chips,
                          stats=stats).numpy()
    if flips == 0:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    assert np.isfinite(got).all()
    assert [st["relu_fused"] for st in stats] == \
        [1.0 if sp.relu and sp.in_dim <= rows else 0.0
         for sp in cfg_t.layer_specs()]


def test_fit_layer_finetunes_match_jax(setup):
    """The port's fig10.fit_layer_finetunes against the JAX benchmark's,
    on carried chips (per-channel mean/std matching, f32 statistics)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import fig10_accuracy
    s = setup
    cfg_j = jv.Vgg8Config(image_size=8, macro_rows=128)
    cfg_t = tv.Vgg8Config(image_size=8, macro_rows=128)
    mcfg = jm.nominal_config(rows=128)
    chips = [jm.sample_chip(jax.random.PRNGKey(200 + i), mcfg)
             for i in range(8)]
    t_chips = [convert.chip_from_jax(_np(c)) for c in chips]
    fj = jv.freeze_vgg8(s["params"], cfg_j, s["a_scales"], chips=chips,
                        mode="cim", v_fs_list=s["v_fs"])
    ft = tv.freeze_vgg8(s["t_params"], cfg_t, s["t_scales"], chips=t_chips,
                        mode="cim", v_fs_list=s["v_fs"])
    want = fig10_accuracy.fit_layer_finetunes(s["params"], fj, cfg_j,
                                              s["a_scales"], chips, s["imgs"])
    got = fig10.fit_layer_finetunes(s["t_params"], ft, cfg_t, s["t_scales"],
                                    t_chips, s["t_imgs"], "cim")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.gain.numpy(), np.asarray(w.gain),
                                   rtol=1e-5)
        np.testing.assert_allclose(g.offset.numpy(), np.asarray(w.offset),
                                   rtol=1e-5, atol=1e-6)


def test_fig10_deploy_flow_on_cpu():
    """The launcher's deploy flow at a reduced size: every plan family
    runs, the cim plan fine-tunes, the energy model prices the run."""
    cfg = tv.Vgg8Config(image_size=8)
    res = fig10.run("cim", device="cpu", n_eval=3, cfg=cfg, n_calib=3)
    assert res["batch"] == 32 and set(res["agree_with_exact"]) == \
        {"raw", "finetuned"}
    assert [layer["layer"] for layer in res["finetuned_layers"]] == \
        list(tv.VGG8_LAYER_PATHS)
    assert res["finetuned_layers"][0]["n_conversions"] == 3 * 64 * 128
    assert res["macro_energy_j"] > 0
    plan = tb.load_plan('{"default": "bitserial_kernel", "rules": '
                        '[["head", {"backend": "w8a8_kernel"}]]}')
    res = fig10.run(plan, device="cpu", n_eval=2, cfg=cfg, n_calib=2)
    assert res["batch"] == 64 and "finetuned" not in res["agree_with_exact"]
    assert [layer["n_passes"] for layer in res["raw_layers"]] == \
        [8.0] * 7 + [1.0]
