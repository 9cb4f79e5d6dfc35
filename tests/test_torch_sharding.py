"""The port's logical-axis sharding against the JAX package's.

* ``model.pspec`` / ``freeze_pspec`` of all ten configs equal JAX's with
  each stacked leaf's leading ``"layers"`` entry dropped (the port keeps a
  per-layer list), under the default deploy plan, ``qat`` and ``exact``.
* ``resolve_param_specs`` gives JAX's PartitionSpecs on a 2 x 2 mesh, the
  16 x 16 production mesh and the 2 x 16 x 16 multi-pod mesh (abstract
  meshes on both sides: resolution reads only axis names and sizes), and
  each spec's DTensor placements shard the named dims.
* ``data_specs`` and ``cache_specs`` equal JAX's on a 2 x 2 mesh of forced
  host devices (``AxisType.Auto``).

The JAX side runs in a subprocess (one JSON line on stdout)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.models import model as M
from repro_torch.models import transformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses, json, sys
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AbstractMesh
from repro import configs as C
from repro.distributed import sharding as S
from repro.models import model as M, transformer as T

def flat(tree):
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda t: isinstance(t, tuple))[0]
    for path, leaf in leaves:
        out["/".join(str(p.key) for p in path)] = leaf
    return out

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s.spec)]

plans = {"default": None, "qat": "qat", "exact": "exact"}
res = {"pspec": {}, "resolved": {}, "data": {}, "cache": {}}
for arch in C.ARCH_IDS:
    cfg = C.reduced_config(arch)
    ps = M.pspec(cfg)
    res["pspec"][arch] = {name: {k: list(v) for k, v in flat(
        M.freeze_pspec(ps, plan=plan) if name != "master" else ps).items()}
        for name, plan in [("master", None)] + list(plans.items())}
    meshes = {"2x2": AbstractMesh((2, 2), ("data", "model")),
              "16x16": AbstractMesh((16, 16), ("data", "model")),
              "2x16x16": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
    res["resolved"][arch] = {
        m: {k: spec(v) for k, v in flat(S.resolve_param_specs(
            M.freeze_pspec(ps), mesh)).items()}
        for m, mesh in meshes.items()}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
for name, (b, s) in {"b8": (8, 32), "b1": (1, 64), "b3": (3, 16)}.items():
    batch = {"tokens": jnp.zeros((b, s), jnp.int32),
             "labels": jnp.zeros((b, s), jnp.int32),
             "positions": jnp.zeros((3, b, s), jnp.int32)}
    res["data"][name] = {k: spec(v) for k, v in
                         S.data_specs(mesh, batch).items()}
for arch, kv in [("qwen3-8b", "int8"), ("qwen3-8b", "bf16"),
                 ("h2o-danube-3-4b", "bf16"), ("mamba2-1.3b", "bf16"),
                 ("zamba2-2.7b", "bf16"), ("whisper-large-v3", "bf16")]:
    cfg = dataclasses.replace(C.reduced_config(arch), kv_cache_dtype=kv)
    for b in (4, 1):
        enc = jnp.zeros((b, 12, cfg.d_model)) \\
            if cfg.arch_type == "encdec" else None
        caches = jax.eval_shape(lambda: T.init_caches(
            cfg, b, 64, jnp.bfloat16, enc_out=enc))
        for seq in (True, False):
            res["cache"][f"{arch}/{kv}/{b}/{seq}"] = {
                k: spec(v) for k, v in flat(S.cache_specs(
                    mesh, caches, cfg, b, seq_shard=seq)).items()}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def jax_specs():
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX)],
                       capture_output=True, text=True, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _flat(tree, prefix=""):
    """path -> leaf over a dict tree; a per-layer list contributes no
    path component, and its layers must agree leaf for leaf."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            for p, leaf in _flat(v, f"{prefix}/{k}" if prefix else k).items():
                out[p] = leaf
    elif isinstance(tree, list):
        per_layer = [_flat(v, prefix) for v in tree]
        assert all(x == per_layer[0] for x in per_layer), prefix
        out.update(per_layer[0] if per_layer else {})
    else:
        out[prefix] = tree
    return out


def _shapes(spec_tree, params) -> bool:
    """The spec tree has the params' structure, one entry a dim."""
    if isinstance(spec_tree, dict):
        return set(spec_tree) == set(params) and all(
            _shapes(spec_tree[k], params[k]) for k in spec_tree)
    if isinstance(spec_tree, list):
        return len(spec_tree) == len(params) and all(
            _shapes(a, b) for a, b in zip(spec_tree, params))
    assert len(spec_tree) == params.ndim, (spec_tree, params.shape)
    return True


def _stacked(path: str) -> bool:
    return path.startswith(("stack/blocks/", "stack/encoder/",
                            "stack/decoder/"))


def _as_json(entry):
    return [list(e) if isinstance(e, tuple) else e for e in entry]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_pspec_trees_equal_jax_without_layers(jax_specs, arch):
    cfg = configs.reduced_config(arch)
    ps = M.pspec(cfg)
    ours = {"master": ps, "default": M.freeze_pspec(ps),
            "qat": M.freeze_pspec(ps, plan="qat"),
            "exact": M.freeze_pspec(ps, plan="exact")}
    for name, tree in ours.items():
        want = jax_specs["pspec"][arch][name]
        got = _flat(tree)
        assert set(got) == set(want), (name, set(got) ^ set(want))
        for path, leaf in got.items():
            jl = want[path]
            if _stacked(path):
                assert jl[0] == "layers", (path, jl)
                jl = jl[1:]
            assert list(leaf) == jl, (name, path, leaf, jl)
    # The tree matches the params' (and the frozen params') structure.
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(ps, params)
    assert _shapes(ours["default"], M.freeze_params(params, a_scale=0.05))


MESHES = {"2x2": sharding.AbstractMesh((2, 2), ("data", "model")),
          "16x16": sharding.AbstractMesh((16, 16), ("data", "model")),
          "2x16x16": sharding.AbstractMesh((2, 16, 16),
                                           ("pod", "data", "model"))}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_resolved_specs_equal_jax_partition_specs(jax_specs, arch):
    cfg = configs.reduced_config(arch)
    tree = M.freeze_pspec(M.pspec(cfg))
    for name, mesh in MESHES.items():
        want = jax_specs["resolved"][arch][name]
        got = _flat(sharding.resolve_param_specs(tree, mesh))
        assert set(got) == set(want)
        names = mesh.mesh_dim_names
        for path, sh in got.items():
            jl = want[path][1:] if _stacked(path) else want[path]
            assert _as_json(sh.spec) == jl, (name, path)
            for i, p in enumerate(sh.placements):
                dims = [d for d, e in enumerate(sh.spec)
                        if e == names[i] or (isinstance(e, tuple)
                                             and names[i] in e)]
                assert p == (Shard(dims[0]) if dims else Replicate())


def test_placements_of_multi_axis_batch_spec():
    mesh = MESHES["2x16x16"]
    sh = sharding.data_specs(mesh, {"tokens": np.zeros((64, 8))})["tokens"]
    assert sh.spec == (("pod", "data"), None)
    assert sh.placements == (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError):
        sharding.NamedSharding(mesh, (("data", "pod"),)).placements


@pytest.mark.parametrize("name", ["b8", "b1", "b3"])
def test_data_specs_equal_jax(jax_specs, name):
    b, s = {"b8": (8, 32), "b1": (1, 64), "b3": (3, 16)}[name]
    batch = {"tokens": torch.zeros(b, s), "labels": torch.zeros(b, s),
             "positions": torch.zeros(3, b, s)}
    got = sharding.data_specs(MESHES["2x2"], batch)
    assert {k: _as_json(v.spec) for k, v in got.items()} \
        == jax_specs["data"][name]


CACHE_CASES = [("qwen3-8b", "int8"), ("qwen3-8b", "bf16"),
               ("h2o-danube-3-4b", "bf16"), ("mamba2-1.3b", "bf16"),
               ("zamba2-2.7b", "bf16"), ("whisper-large-v3", "bf16")]


@pytest.mark.parametrize("arch,kv", CACHE_CASES)
def test_cache_specs_equal_jax(jax_specs, arch, kv):
    import dataclasses
    cfg = dataclasses.replace(configs.reduced_config(arch),
                              kv_cache_dtype=kv)
    for b in (4, 1):
        enc = torch.zeros(b, 12, cfg.d_model) \
            if cfg.arch_type == "encdec" else None
        caches = transformer.init_caches(cfg, b, 64, torch.bfloat16,
                                         device="meta", enc_out=enc)
        for seq in (True, False):
            want = jax_specs["cache"][f"{arch}/{kv}/{b}/{seq}"]
            got = _flat(sharding.cache_specs(MESHES["2x2"], caches, cfg, b,
                                             seq_shard=seq))
            assert {k: _as_json(v.spec) for k, v in got.items()} == want


def test_constrain_is_identity_off_mesh():
    x = torch.randn(4, 8, 2, 16)
    assert sharding.constrain(x, {0: "batch", 2: "model"}) is x
    assert sharding.logits_spec(MESHES["2x2"], 4).spec == ("data", None,
                                                          "model")
