"""Port parity of the training slice's parts against the JAX package:
the fake-quant linear and the ``qat`` backend, VGG-8 under ``qat``, the
cosine schedule and AdamW; and remat, which must leave the gradients bit
for bit as they are.  The train step itself: test_torch_train_steps.py.

Tolerances: the fake-quant forward and its straight-through gradients
bit-exact (at the shapes the reduced models give the linear, where both
libraries sum the f32 product in one order); VGG-8's bf16 layers within
1e-4; AdamW within 1e-6 relative (XLA contracts its multiply-adds into
FMAs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import backend as jb
from repro.core import quant as jq
from repro.data import synthetic as js
from repro.models import vgg as jv
from repro.train import optimizer as jo
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.core import backend as tb
from repro_torch.core import quant as tq
from repro_torch.models import model as TM
from repro_torch.models import vgg as tv
from repro_torch.train import optimizer as to


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its many small CPU ops
    gain nothing from more, and the suite runs several files at once on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _linear_case(seed, x_shape, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal((x_shape[-1], n)) * 0.1).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal((*x_shape[:-1], n)).astype(np.float32)
    return x, w, b, g


# (x shape, N): the reduced models' q/o, up, down and head products.
LINEAR_SHAPES = (((4, 32, 64), 64), ((4, 32, 64), 256), ((4, 32, 256), 64),
                 ((2, 16, 64), 250))


@pytest.mark.parametrize("x_shape,n", LINEAR_SHAPES)
def test_fake_quant_and_qat_linear_bit_exact(x_shape, n):
    x, w, b, g = _linear_case(0, x_shape, n)
    a_s = jq.absmax_scale(jnp.asarray(x))
    w_s = jq.absmax_scale(jnp.asarray(w), axis=0)
    np.testing.assert_array_equal(
        tq.fake_quant(_t(x), _t(a_s)).numpy(),
        np.asarray(jq.fake_quant(jnp.asarray(x), a_s)))
    want, vjp = jax.vjp(lambda x_, w_: jq.qat_linear(
        x_, w_, a_s, w_s, bias=jnp.asarray(b), relu=True),
        jnp.asarray(x), jnp.asarray(w))
    want_gx, want_gw = vjp(jnp.asarray(g))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = tq.qat_linear(tx, tw, _t(a_s), _t(w_s), bias=_t(b), relu=True)
    got_gx, got_gw = torch.autograd.grad(got, (tx, tw), _t(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_gx.numpy(), np.asarray(want_gx))
    np.testing.assert_array_equal(got_gw.numpy(), np.asarray(want_gw))
    # Straight through: the input gradient is the product's, the
    # quantizers pass it unchanged.
    wq = jq.dequantize(jq.quantize(jnp.asarray(w), w_s), w_s)
    y_pre = jq.qat_linear(jnp.asarray(x), jnp.asarray(w), a_s, w_s,
                          bias=jnp.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(want_gx),
        np.asarray((jnp.asarray(g) * (y_pre > 0)) @ wq.T))


@pytest.mark.parametrize("x_shape,n", LINEAR_SHAPES[:2])
def test_qat_backend_matches_jax_and_freezes_to_w8a8(x_shape, n):
    x, w, b, _ = _linear_case(1, x_shape, n)
    k = x_shape[-1]
    want = jb.get_backend("qat").apply(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
        jb.LinearSpec(k, n, True, relu=True, mode="qat", dtype=jnp.float32))
    got = tb.get_backend("qat").apply(
        {"w": _t(w), "b": _t(b)}, _t(x),
        tb.LinearSpec(k, n, True, relu=True, mode="qat",
                      dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    frozen = tb.get_backend("qat").freeze({"w": _t(w), "b": _t(b)},
                                          a_scale=0.05)
    ref = tb.get_backend("w8a8").freeze({"w": _t(w), "b": _t(b)},
                                        a_scale=0.05)
    assert set(frozen) == {"w_q", "w_scale", "a_scale", "b"}
    for key in ref:
        assert torch.equal(frozen[key], ref[key])
    jfrozen = jb.get_backend("qat").freeze(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, a_scale=0.05)
    np.testing.assert_array_equal(frozen["w_q"].numpy(),
                                  np.asarray(jfrozen["w_q"]))


def test_vgg8_qat_forward_and_input_grad():
    """VGG-8's bf16 layers under ``qat``: logits and the input gradient
    against the JAX package's op-by-op forward (each bf16 op rounded, as
    the port rounds it), within 1e-4."""
    cfg_j, cfg_t = jv.Vgg8Config(image_size=8), tv.Vgg8Config(image_size=8)
    params = jv.init_vgg8(jax.random.PRNGKey(0), cfg_j)
    imgs = np.random.default_rng(2).uniform(size=(2, 8, 8, 3)).astype(
        np.float32)
    want, vjp = jax.vjp(lambda im: jv.vgg8_forward(params, im, cfg_j,
                                                   mode="qat"),
                        jnp.asarray(imgs))
    ct = np.random.default_rng(3).standard_normal(want.shape).astype(
        np.float32)
    (want_g,) = vjp(jnp.asarray(ct))
    t_imgs = _t(imgs).requires_grad_()
    got = tv.vgg8_forward(convert.vgg_params_from_jax(_np(params)), t_imgs,
                          cfg_t, mode="qat")
    (got_g,) = torch.autograd.grad(got, t_imgs, _t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-4)


def test_cosine_schedule():
    for step in (0, 1, 5, 30, 100):
        got = to.cosine_schedule(step, 1e-3, 5, 100)
        want = jo.cosine_schedule(step, 1e-3, 5, 100)
        assert float(got) == float(want), step


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update(clip):
    rng = np.random.default_rng(4)
    shapes = {"a": (8, 16), "b": {"c": (16,), "d": (4, 4, 8)}}
    tree = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                        shapes, is_leaf=lambda s: isinstance(s, tuple))
    grads = jax.tree.map(lambda a: (a * 3).astype(np.float32), tree)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=clip)
    jp, jstate = jax.tree.map(jnp.asarray, tree), jo.init_opt_state(
        jax.tree.map(jnp.asarray, tree))
    tp = jax.tree.map(_t, tree)
    tstate = to.init_opt_state(tp)
    for _ in range(3):
        jp, jstate, jm = jo.adamw_update(jax.tree.map(jnp.asarray, grads),
                                         jstate, jp, JTrainConfig(**cfg_kw))
        tp, tstate, tm = to.adamw_update(jax.tree.map(_t, grads), tstate, tp,
                                         TrainConfig(**cfg_kw))
    for key in ("lr", "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
    for name, want, got in (("params", jp, tp), ("m", jstate["m"],
                                                 tstate["m"]),
                            ("v", jstate["v"], tstate["v"])):
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
    assert int(tstate["step"]) == 3 and tstate["step"].dtype == torch.int32


def test_remat_is_bit_identical():
    """Rematerialized blocks give the same gradients, bit for bit, under
    both policies."""
    for arch in ("granite-moe-1b-a400m", "zamba2-2.7b"):
        cfg = tcfg.reduced_config(arch)
        params = TM.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        batch = js.lm_batch(js.TokenStreamConfig(cfg.vocab, 16, 2, 0), 0)
        batch = {k: _t(v) for k, v in batch.items()}
        leaves = to.tree_leaves(params)
        grads = {}
        for remat, policy in ((False, "nothing"), (True, "nothing"),
                              (True, "dots")):
            xs = [p.detach().requires_grad_(True) for p in leaves]
            tree = to.tree_unflatten_like(params, xs)
            h, aux = TM.forward(tree, batch, cfg, remat=remat,
                                remat_policy=policy)
            loss = h.square().mean() + aux
            grads[remat, policy] = torch.autograd.grad(loss, xs,
                                                       allow_unused=True)
        for key in ((True, "nothing"), (True, "dots")):
            for a, b in zip(grads[False, "nothing"], grads[key]):
                assert (a is None and b is None) or torch.equal(a, b), \
                    (arch, key)
    with pytest.raises(ValueError, match="remat_policy"):
        TM.forward(params, batch, cfg, remat=True, remat_policy="all")
