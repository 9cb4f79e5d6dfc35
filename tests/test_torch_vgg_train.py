"""VGG-8 training (Fig. 10's ``train_vgg``) and the accuracy run on the
port against the JAX package's ``benchmarks/fig10_accuracy.py``.

At a key the port draws JAX's data and initial weights: labels exactly,
the images within 2 f32 ulp of 1.0 (their patterns go through ``sin``,
which XLA rounds its own way), the bf16 weights bit for bit.  Adam's
update equals JAX's bit for bit for the same gradient: op by op on bf16
leaves, and with the moments' first product fused into the sum on f32
leaves, as XLA:CPU computes each.

The gradients and the trained weights cannot agree to 1e-5.  VGG-8's
master weights are bf16 and so are its activations: one reordered f32
sum rounds a bf16 value the other way, and a ReLU near zero passes or
stops it.  So the step-1 gradients are held leaf by leaf within a
relative norm of ``GRAD_REL`` of JAX's.  The limit comes from readings:
correct runs at ``PRNGKey(0..3)`` read at most 0.016 / 0.061 / 0.045 /
0.073, while three deliberate faults read at least 0.45 on every leaf
they touch (im2col's 3x3 offsets transposed, average for max pooling, a
leaf's gradient zeroed: 1.0).  Adam's first step then moves every weight
by about ``lr`` in the sign of its gradient, so a gradient near zero
whose sign differs moves the weight ``2 * lr`` the other way; the
trained weights are held within ``2 * lr`` a step plus one bf16 ulp of
JAX's, and in each leaf at most ``BEYOND_SHARE`` of the elements may
differ by more than 1e-5.  Correct training reads at most 0.185 (conv2's
kernel); im2col transposed reads 0.27-0.78 on every leaf but the head's
bias (above the limit on all but the head's), and a zeroed conv1 bias
gradient 0.98 on that leaf."""
import jax
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import fig10
from repro_torch.models import vgg as tvgg

IMG_ATOL = 2 * float(np.finfo(np.float32).eps)
LR = 2e-3
GRAD_REL = 0.1
BEYOND_SHARE = 0.25
STEPS, BATCH = 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite runs several
    files at once on the machine's cores, and these small CPU ops ran
    10-80x slower than alone when each file took them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed) -> torch.Tensor:
    return prng.as_key(np.asarray(jax.random.key_data(
        jax.random.PRNGKey(seed))))


# (0, 2, 32) is the training batch's shape, whose JAX draw the jax_run
# fixture then finds compiled.
@pytest.mark.parametrize("seed,n,size", [(0, 2, 32), (7, 5, 8)])
def test_synthetic_cifar_at_jax_keys(seed, n, size):
    from repro.data import synthetic as jsyn
    ji, jl = jsyn.synthetic_cifar(jax.random.PRNGKey(seed), n, size=size)
    ti, tl = tsyn.synthetic_cifar(_key(seed), n, size=size)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0,
                               atol=IMG_ATOL)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's side, computed once for this file: ``init_vgg8`` and
    ``train_vgg`` (``benchmarks/fig10_accuracy.py``) at ``PRNGKey(0)``,
    and the loss and gradients of its ``loss_fn`` (copied from that
    function, jitted as its step is) at step 1's key and batch."""
    import pathlib
    import sys

    import jax.numpy as jnp
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from benchmarks import fig10_accuracy as jfig10
    from repro.data import synthetic as jsyn
    from repro.models import vgg as jvgg
    key = jax.random.PRNGKey(0)
    cfg = jvgg.Vgg8Config(macro_rows=1152)

    def loss_fn(params, images, labels):
        logits = jvgg.vgg8_forward(params, images, cfg, mode="exact")
        onehot = jax.nn.one_hot(labels, cfg.n_classes)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))

    init = jvgg.init_vgg8(key, cfg)
    images, labels = jsyn.synthetic_cifar(jax.random.fold_in(key, 1), BATCH)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(init, images, labels)
    trained = jfig10.train_vgg(key, cfg, steps=STEPS, batch=BATCH)
    return {"init": init, "loss1": float(loss), "grads1": grads,
            "trained": trained}


@pytest.fixture(scope="module")
def port_init():
    """The port's ``init_vgg8`` at ``PRNGKey(0)``, drawn once."""
    return tvgg.init_vgg8(_key(0), tvgg.Vgg8Config(macro_rows=1152))


def _leaves(tree):
    """(layer, name, leaf) of a list of leaf dicts, in order."""
    return [(i, k, p[k]) for i, p in enumerate(tree) for k in sorted(p)]


def test_init_vgg8_at_jax_key_bit_exact(jax_run, port_init):
    want, got = jax_run["init"], port_init
    assert len(want) == len(got) == len(tvgg.VGG8_LAYER_PATHS)
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            a = np.asarray(w[k]).astype(np.float32)
            assert str(g[k].dtype).endswith(str(w[k].dtype)), k
            np.testing.assert_array_equal(g[k].float().numpy(), a)


def _jax_adam(lr):
    """The update of ``benchmarks/fig10_accuracy.py``'s jitted step, as
    written there, for given gradients."""
    import jax.numpy as jnp

    @jax.jit
    def update(params, m, v, grads, t):
        new_p, new_m, new_v = [], [], []
        for p, mm, vv, g in zip(params, m, v, grads):
            mm = jax.tree.map(lambda a, b: 0.9 * a + 0.1 * b, mm, g)
            vv = jax.tree.map(lambda a, b: 0.999 * a + 0.001 * b * b, vv, g)
            new_p.append(jax.tree.map(
                lambda pp, a, b: pp - lr * (a / (1 - 0.9**t)) /
                (jnp.sqrt(b / (1 - 0.999**t)) + 1e-8), p, mm, vv))
            new_m.append(mm)
            new_v.append(vv)
        return new_p, new_m, new_v
    return update


def test_adam_update_equals_jax():
    """Three steps on random bf16 weights and f32 biases with random
    gradients (some near zero): every leaf and moment bit-exact."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    shapes = ((64, 32), (32,), (300, 10), (10,))

    def leaf_pairs(scale):
        out = []
        for i in range(0, len(shapes), 2):
            w = (rng.standard_normal(shapes[i]) * scale).astype(np.float32)
            b = (rng.standard_normal(shapes[i + 1]) * scale).astype(
                np.float32)
            w[0, :4] = [1e-9, -1e-9, 0.0, 1e-33]
            out.append({"w": w, "b": b})
        return out

    def to_jax(tree):
        return [{"w": jnp.asarray(p["w"], jnp.bfloat16),
                 "b": jnp.asarray(p["b"])} for p in tree]

    def to_torch(tree):
        return [{"w": torch.from_numpy(p["w"]).to(torch.bfloat16),
                 "b": torch.from_numpy(p["b"])} for p in tree]

    params = leaf_pairs(0.1)
    jp, tp = to_jax(params), to_torch(params)
    zeros = [{k: np.zeros_like(x) for k, x in p.items()} for p in params]
    jm, jv, tm, tv = to_jax(zeros), to_jax(zeros), to_torch(zeros), \
        to_torch(zeros)
    update = _jax_adam(LR)
    for t in (1, 2, 3):
        grads = leaf_pairs(1e-3)
        jp, jm, jv = update(jp, jm, jv, to_jax(grads), t)
        tp, tm, tv = fig10.adam_update(tp, tm, tv, to_torch(grads), t, LR)
        for jt, tt in ((jp, tp), (jm, tm), (jv, tv)):
            for a, b in zip(jt, tt):
                np.testing.assert_array_equal(
                    b["w"].float().numpy(),
                    np.asarray(a["w"]).astype(np.float32))
                np.testing.assert_array_equal(b["b"].numpy(),
                                              np.asarray(a["b"]))


def test_step1_gradients_against_jax(jax_run, port_init):
    """``loss_and_grads`` at step 1's batch (``synthetic_cifar(fold_in(
    PRNGKey(0), 1), 2)``) against ``jax.value_and_grad`` of JAX's loss:
    the loss within 1e-4 relative, each leaf's gradient in its dtype and
    within ``GRAD_REL`` relative norm (see the module's note)."""
    images, labels = tsyn.synthetic_cifar(prng.fold_in(_key(0), 1), BATCH)
    loss, grads = fig10.loss_and_grads(port_init, images, labels,
                                       tvgg.Vgg8Config(macro_rows=1152))
    assert loss == pytest.approx(jax_run["loss1"], rel=1e-4)
    rels = {}
    for (i, k, w), (_, _, g) in zip(_leaves(jax_run["grads1"]),
                                    _leaves(grads)):
        assert g.dtype == port_init[i][k].dtype, (i, k)
        a = np.asarray(w).astype(np.float64)
        b = g.double().numpy()
        rels[f"{tvgg.VGG8_LAYER_PATHS[i]}.{k}"] = float(
            np.linalg.norm(b - a) / np.linalg.norm(a))
    assert len(rels) == 2 * len(tvgg.VGG8_LAYER_PATHS)
    bad = {name: r for name, r in rels.items() if not r <= GRAD_REL}
    assert not bad, bad
    print("step-1 gradient relative norms:", rels)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (2**-7 of its binade; the smallest normal's
    below that)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return 2.0 ** (e - 7)


def test_train_vgg_against_jax(jax_run, port_init, monkeypatch):
    """``train_vgg(PRNGKey(0), Vgg8Config(macro_rows=1152), steps=2,
    batch=2)`` against JAX's: every element within ``2 * lr`` a step
    plus one bf16 ulp, and in each leaf at most ``BEYOND_SHARE`` of the
    elements beyond 1e-5 (see the module's note).  Its ``init_vgg8``
    call is answered with the draw ``port_init`` already made at the
    same key (held bit-exact to JAX's above), which saves drawing VGG-8's
    13M normals twice on one thread."""
    def init(key, cfg):
        assert torch.equal(key, _key(0))
        assert cfg == tvgg.Vgg8Config(macro_rows=1152)
        return port_init
    monkeypatch.setattr(fig10.vgg, "init_vgg8", init)
    losses = []
    got = fig10.train_vgg(_key(0), tvgg.Vgg8Config(macro_rows=1152),
                          steps=STEPS, batch=BATCH, losses=losses)
    assert len(losses) == STEPS and all(np.isfinite(losses))
    assert losses[0] == pytest.approx(jax_run["loss1"], rel=1e-4)
    shares = {}
    for (i, k, w), (_, _, g) in zip(_leaves(jax_run["trained"]),
                                    _leaves(got)):
        a = np.asarray(w).astype(np.float32)
        b = g.float().numpy()
        assert g.dtype == (torch.bfloat16 if k == "w" else torch.float32)
        diff = np.abs(a - b)
        bound = 2 * LR * STEPS + _bf16_ulp(np.maximum(np.abs(a),
                                                      np.abs(b)))
        assert np.all(diff <= bound), (i, k, float(diff.max()))
        shares[f"{tvgg.VGG8_LAYER_PATHS[i]}.{k}"] = float(
            (diff > 1e-5).mean())
    assert len(shares) == 2 * len(tvgg.VGG8_LAYER_PATHS)
    bad = {name: r for name, r in shares.items() if not r <= BEYOND_SHARE}
    assert not bad, bad
    print("train_vgg: share of elements beyond 1e-5 by leaf:", shares)


def test_accuracy_run_end_to_end():
    """The accuracy experiment at image_size 8, 2 steps and 4 images:
    finite training losses, the four accuracies reported, K1's plan equal
    to the plain w8a8 plan's (checked inside), JAX's rows printed."""
    res = fig10.accuracy_run(device="cpu", steps=2, n_eval=4, batch=2,
                             n_calib=4, cfg=tvgg.Vgg8Config(image_size=8),
                             check_claims=False)
    assert set(res["acc"]) == {"exact", "w8a8", "cim_raw", "cim_finetuned"}
    assert all(0.0 <= a <= 1.0 for a in res["acc"].values())
    assert np.isfinite(res["loss_first"]) and np.isfinite(res["loss_last"])
    assert [r.split(",")[0] for r in res["rows"]] == [
        "fig10_acc_exact", "fig10_acc_w8a8", "fig10_acc_cim_raw",
        "fig10_acc_cim_finetuned"]
    assert set(res["claims"]) == {"exact_above_0.6", "finetune_not_worse"}
