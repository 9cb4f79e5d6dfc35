"""Port parity: W8A8 quantization, the freeze transform, the w8a8 and
w8a8_kernel linears and deployment-plan JSON, held bit-exact against the
JAX package on identical numpy inputs."""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import backend as jb
from repro.core import quant as jq
from repro.models import layers as jl
from repro.models import model as JM
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.core import backend as tb
from repro_torch.core import quant as tq
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.models import layers as tl
from repro_torch.models import model as TM


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def test_quantize_dequantize_bit_exact():
    rng = np.random.default_rng(0)
    scale = np.float32(0.037)
    # random values plus exact half-way points (round half to even)
    x = np.concatenate([rng.standard_normal(4000).astype(np.float32) * 3,
                        (np.arange(-300, 300, dtype=np.float32) + 0.5)
                        * scale])
    jq_ = np.asarray(jq.quantize(jnp.asarray(x), jnp.float32(scale)))
    tq_ = tq.quantize(_t(x), torch.tensor(scale)).numpy()
    np.testing.assert_array_equal(tq_, jq_)
    np.testing.assert_array_equal(
        tq.dequantize(_t(tq_), torch.tensor(scale)).numpy(),
        np.asarray(jq.dequantize(jnp.asarray(jq_), jnp.float32(scale))))
    w = rng.standard_normal((48, 80)).astype(np.float32)
    for axis in (None, 0, -2, 1):
        np.testing.assert_array_equal(
            tq.absmax_scale(_t(w), axis=axis).numpy(),
            np.asarray(jq.absmax_scale(jnp.asarray(w), axis=axis)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_freeze_bit_exact(dtype):
    """The same master weights freeze to identical int8 codes and scales
    in both packages."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((48, 80)).astype(np.float32) * 0.3
    w = w.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else w
    b = rng.standard_normal(80).astype(np.float32)
    jf = jb._w8a8_freeze({"w": jnp.asarray(w), "b": jnp.asarray(b)}, 0.05)
    tf = tb._w8a8_freeze({"w": _t(w), "b": _t(b)}, 0.05)
    assert set(jf) == set(tf)
    for k in jf:
        np.testing.assert_array_equal(_np(tf[k]), np.asarray(jf[k]))


def test_model_freeze_bit_exact():
    """freeze_params over a whole reduced model, plan-resolved per layer
    (attention on w8a8_kernel, lm_head left float), is bit-identical."""
    cfg = jcfg.reduced_config("qwen3-8b", n_layers=2)
    tc = tcfg.reduced_config("qwen3-8b", n_layers=2)
    import jax
    master = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(3), cfg))
    rules = (("*attn*", {"backend": "w8a8_kernel", "a_scale": 0.1}),
             ("lm_head", {"backend": "exact"}))
    jplan = jb.DeploymentPlan(
        rules=tuple((p, jb.LayerRule(**r)) for p, r in rules))
    tplan = tb.DeploymentPlan(
        rules=tuple((p, tb.LayerRule(**r)) for p, r in rules))
    want = convert.params_from_jax(
        jax.tree.map(np.asarray, JM.freeze_params(master, 0.05, jplan)), tc)
    got = TM.freeze_params(convert.params_from_jax(master, tc), 0.05, tplan)

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b)
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    walk(got, want)
    assert "w_q" in got["stack"]["blocks"][0]["attn"]["q"]
    assert "w" in got["lm_head"]


@pytest.mark.parametrize("backend", ["w8a8", "w8a8_kernel"])
@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("qin", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_linear_bit_exact(backend, requant, qin, bias):
    """The deployed linears (fused input quantization, bias, requant
    epilogue, QTensor residency input) agree with JAX bit for bit.

    The expected values come from the JAX package's oracle semantics
    (``quant.w8a8_matmul``: multiply, then add the bias).  Its Pallas
    kernel in interpret mode on XLA:CPU contracts that multiply-add into
    one FMA and lands one f32 ulp off its own oracle when a bias is
    present, so the kernel backend is also compared directly, bias-free."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((48, 80)).astype(np.float32) * 0.2
    b = rng.standard_normal(80).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    master = {"w": jnp.asarray(w)}
    if bias:
        master["b"] = jnp.asarray(b)
    jp = jb._w8a8_freeze(master, 0.03)
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    jos = jnp.float32(0.02) if requant else None
    tos = torch.tensor(np.float32(0.02)) if requant else None
    jx, tx = jnp.asarray(x), _t(x)
    if qin:
        jx = jq.quantize_to(jx, jnp.float32(0.03))
        tx = tq.quantize_to(tx, torch.tensor(np.float32(0.03)))
    ty = tl.dense(tp, tx, backend, path="attn/q", out_scale=tos)
    wants = [jl.dense(jp, jx, "w8a8", path="attn/q", out_scale=jos)]
    if not bias:
        wants.append(jl.dense(jp, jx, backend, path="attn/q",
                              out_scale=jos))
    for jy in wants:
        if requant:
            assert isinstance(ty, tq.QTensor)
            np.testing.assert_array_equal(ty.q.numpy(), np.asarray(jy.q))
        else:
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_cim_matmul_ragged_bit_exact():
    """The CPU path of the kernel wrapper (its plain twin) on ragged
    M/K/N equals the JAX reference oracle."""
    from repro.kernels.cim_matmul import ref as jref
    rng = np.random.default_rng(4)
    m, k, n = 7, 36, 20
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.random(n) * 1e-2).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    for relu in (False, True):
        want = jref.cim_matmul_ref(
            jnp.asarray(a), jnp.asarray(w), jnp.float32(0.05),
            jnp.asarray(ws), jnp.asarray(bias), jnp.float32(1.0), relu=relu)
        got = cim_ops.cim_matmul(_t(a), _t(w), 0.05, _t(ws), _t(bias),
                                 relu=relu)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plan_json_crosses_packages():
    """A plan written by either package loads in the other unchanged."""
    jplan = jb.DeploymentPlan(
        rules=(("*attn*", jb.LayerRule("w8a8_kernel", a_scale=0.1)),
               ("lm_head", jb.LayerRule("exact"))),
        default="w8a8", residency=True, paged_attn=True)
    tplan = tb.DeploymentPlan.from_json(jplan.to_json())
    assert tplan.to_json() == jplan.to_json()
    assert jb.DeploymentPlan.from_json(tplan.to_json()) == jplan
    assert tplan.backend_for("stack/blocks/attn/q") == "w8a8_kernel"
    assert tb.load_plan("w8a8_kernel") == tb.DeploymentPlan(
        default="w8a8_kernel")
    assert tb.paged_attn_enabled(tplan) and tb.residency_enabled(tplan)
    with pytest.raises(KeyError):
        tb.DeploymentPlan.from_json('{"default": "no_such_backend"}')


def test_non_cpu_tensor_never_takes_plain_path():
    """A tensor off the CPU goes to the kernel wrapper, which launches or
    raises; it never falls back to the plain version."""
    a = torch.empty(4, 8, device="meta")
    w = torch.empty(8, 8, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cim_ops.cim_matmul(a, w, torch.tensor(0.1, device="meta"),
                           torch.ones(8, device="meta"))


def test_reduced_configs_match():
    assert dataclasses.asdict(tcfg.reduced_config("qwen3-8b")) \
        == dataclasses.asdict(jcfg.reduced_config("qwen3-8b"))
    assert dataclasses.asdict(tcfg.get_config("qwen3-8b")) \
        == dataclasses.asdict(jcfg.get_config("qwen3-8b"))
