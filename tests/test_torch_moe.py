"""Port parity of the MoE layer (``models/moe.py``) against the JAX
package's, float and deployed, dropless and dropping.

Parameters are drawn by the JAX package (a one-layer reduced
moonshot-v1-16b-a3b with 4 experts, top-2, capacity factor 1.0) and
carried across by ``convert.params_from_jax``, frozen on the JAX side
under the default deploy plan (router exact, every bank W8A8).  The keep
masks, ``aux_loss`` and ``overflow_frac`` must be equal; the deployed
banks' int32 products and their epilogues bit-exact; the layer output
within 1e-5 (float: f32 einsums in another summation order) or 1e-4
(deployed: the down bank's input grid follows one absmax over SiLU
outputs, which XLA and PyTorch may round one ulp apart)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.core import backend as tb
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe

ARCH = "moonshot-v1-16b-a3b"
# (batch, tokens per group): 8 <= 4E is dropless, 32 > 4E drops at
# capacity int(32 * 2 * 1.0 / 4) = 16.
CASES = {"dropless": (2, 8), "dropping": (2, 32)}


def _cfgs():
    j = jcfg.reduced_config(ARCH, n_layers=1)
    t = tcfg.reduced_config(ARCH, n_layers=1)
    kw = dict(n_experts=4, top_k=2, d_ff_expert=16, n_shared_experts=1,
              capacity_factor=1.0)
    return (dataclasses.replace(j, moe=jcfg.MoEConfig(**kw)),
            dataclasses.replace(t, moe=tcfg.MoEConfig(**kw)))


@pytest.fixture(scope="module")
def layers():
    """{frozen?: (jax moe params, port moe params)}."""
    jc, tc = _cfgs()
    master = JM.init(jax.random.PRNGKey(3), jc)
    out = {}
    for frozen in (False, True):
        jp = JM.freeze_params(master, a_scale=0.05) if frozen else master
        jp = jax.tree.map(np.asarray, jp)
        tp = convert.params_from_jax(jp, tc)
        out[frozen] = (jax.tree.map(lambda a: jnp.asarray(a[0]),
                                    jp["stack"]["blocks"]["moe"]),
                       tp["stack"]["blocks"][0]["moe"])
    return out


def _x(b, s, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (b, s, 64)).astype(
        np.float32)


def _jax_keep(p, x, cfg_moe):
    """The JAX layer's keep mask [G, Tg*k], from its router and its
    token-major cumsum positions (moe.py does not return it)."""
    from repro.models import layers as jlayers
    e, k = cfg_moe.n_experts, cfg_moe.top_k
    g, tg = x.shape[:2]
    logits = jlayers.dense(p["router"], x, "exact", dtype=x.dtype)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32)), k)
    cap = max(1, int(tg * k * cfg_moe.capacity_factor / e))
    if tg <= 4 * e:
        cap = max(cap, tg)
    flat = top_e.reshape(g, tg * k)
    onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, 1) - onehot,
                              flat[..., None], 2)[..., 0]
    return np.asarray(pos < cap)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("plan", ["exact", "w8a8", "w8a8_kernel"])
def test_moe_matches_jax(layers, case, plan):
    jc, tc = _cfgs()
    jp, tp = layers[plan != "exact"]
    x = _x(*CASES[case])
    jy, jaux = jmoe.moe(jp, jnp.asarray(x), jc.moe,
                        "exact" if plan == "exact" else "w8a8")
    ty, taux = tmoe.moe(tp, torch.as_tensor(x), tc.moe, plan)
    keep = _jax_keep(jp, jnp.asarray(x), jc.moe)
    np.testing.assert_array_equal(taux["keep"].numpy(), keep)
    assert (not keep.all()) == (case == "dropping")
    assert float(taux["overflow_frac"]) == float(jaux["overflow_frac"])
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=1e-6)
    tol = 1e-5 if plan == "exact" else 1e-4
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=tol,
                               atol=tol)


def test_kernel_route_equals_batched(layers):
    """Under w8a8_kernel each bank product is one cim_matmul per expert;
    the layer output equals the batched exact product's bit for bit."""
    _, tc = _cfgs()
    _, tp = layers[True]
    x = torch.as_tensor(_x(*CASES["dropping"], seed=4))
    from repro_torch.kernels.cim_matmul import ops as kops
    before = kops.launches
    y_k, _ = tmoe.moe(tp, x, tc.moe, tb.load_plan("w8a8_kernel"))
    y_p, _ = tmoe.moe(tp, x, tc.moe, "w8a8")
    assert torch.equal(y_k, y_p)
    assert kops.launches == before      # the CPU runs the plain twin


@pytest.mark.parametrize("bank", ["gate", "up", "down"])
@pytest.mark.parametrize("kernel", [False, True])
def test_bank_products_bit_exact(layers, bank, kernel):
    """The deployed bank products: int32 equal to JAX's int8 batched
    dot_general, and the f32 epilogue ``acc * (a_s * w_scale[e])`` equal
    bit for bit, on one set of int8 codes (a buffer with pad rows)."""
    jp, tp = layers[True]
    e, kdim, n = tp[f"{bank}_q"].shape
    rng = np.random.default_rng(7)
    codes = rng.integers(-128, 128, (e, 24, kdim)).astype(np.int8)
    codes[:, -5:] = 0                            # pad rows give zeros
    a_s = np.float32(0.0371)
    want_i32 = jax.lax.dot_general(
        jnp.asarray(codes), jp[f"{bank}_q"], (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32)
    got_i32 = tmoe.int8_bmm(torch.as_tensor(codes), tp[f"{bank}_q"])
    np.testing.assert_array_equal(got_i32.numpy(), np.asarray(want_i32))
    want = want_i32.astype(jnp.float32) * (
        a_s * jp[f"{bank}_scale"][:, None, :])
    got = tmoe.bank_matmul(torch.as_tensor(codes), tp[f"{bank}_q"],
                           torch.tensor(a_s), tp[f"{bank}_scale"],
                           kernel=kernel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[:, -5:].any()


def test_frozen_bank_layout(layers):
    """freeze_params gives each bank int8 codes, [E, N] scales and one
    scalar a_scale, equal to the JAX package's; the router stays float."""
    jp, tp = layers[True]
    _, tc = _cfgs()
    port_frozen = TM.freeze_params(
        {"stack": {"blocks": [{"moe": layers[False][1]}]}}, a_scale=0.05)
    pf = port_frozen["stack"]["blocks"][0]["moe"]
    for bank in ("gate", "up", "down"):
        assert pf[f"{bank}_q"].dtype == torch.int8
        np.testing.assert_array_equal(pf[f"{bank}_q"].numpy(),
                                      np.asarray(jp[f"{bank}_q"]))
        np.testing.assert_array_equal(pf[f"{bank}_scale"].numpy(),
                                      np.asarray(jp[f"{bank}_scale"]))
        assert pf[f"{bank}_scale"].shape == (tc.moe.n_experts,
                                             pf[f"{bank}_q"].shape[-1])
        assert bank not in pf
    assert pf["a_scale"].shape == ()
    assert pf["a_scale"].item() == np.float32(0.05)
    assert "w" in pf["router"] and "w_q" in pf["shared"]["gate"]
    # A float plan leaves the banks as they are.
    tree = {"stack": {"blocks": [{"moe": layers[False][1]}]}}
    kept = TM.freeze_params(tree, plan="exact")["stack"]["blocks"][0]["moe"]
    assert "gate" in kept and "gate_q" not in kept
