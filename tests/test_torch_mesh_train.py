"""The port's sharded train step and elastic restore against the JAX
package's mesh runs.

* The train step on a 2 x 2 (data, model) mesh of 4 gloo ranks (qwen3-8b
  reduced: 2 layers, d_model 64; params, master, m and v DTensors laid
  out by ``resolve_param_specs``, the batch by ``data_specs``) from JAX's
  own initial state: against the port's single-device step and against
  JAX's sharded step on 4 forced host devices (``AxisType.Auto``); two
  microbatches, the ``qat`` plan (its per-tensor activation scale over
  the global batch) and granite-moe (the balance loss over the global
  batch), likewise against the port's single-device step.  Loss within
  1e-3; params, m, v and grad_norm within ~10x the differences of a CPU
  run (``_assert_close``), tight enough to hold the gradient's
  all-reduce and weights: one AdamW step moves a parameter by about lr
  whatever the gradient's scale.
* Elastic restore: the mesh step's state saved from the 2 x 2 mesh
  (rank 0 writes full arrays) restores onto a 4 x 1 mesh and onto one
  device, ``torch.equal`` to what was saved."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg():
    return configs.reduced_config("qwen3-8b", n_layers=2, d_model=64)


def _tcfg(**kw):
    return TrainConfig(total_steps=10, warmup_steps=2, remat=False, **kw)


def _batch() -> dict:
    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(0, 256, (8, 32)).astype(np.int32),
            "labels": rng.integers(0, 256, (8, 32)).astype(np.int32)}


_JAX = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import json, sys
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro import configs as C
from repro.checkpoint.manager import CheckpointManager
from repro.configs.base import TrainConfig
from repro.distributed import sharding as S
from repro.models import model as M
from repro.train import optimizer as opt_lib
from repro.train.train_loop import make_train_step

out_dir = sys.argv[1]
cfg = C.reduced_config("qwen3-8b", n_layers=2, d_model=64)
tcfg = TrainConfig(total_steps=10, warmup_steps=2, remat=False)
params = M.init(jax.random.PRNGKey(0), cfg)
opt = opt_lib.init_opt_state(params)
CheckpointManager(out_dir + "/init").save(0, {"params": params, "opt": opt})
batch = {k: jnp.asarray(v) for k, v in np.load(out_dir + "/batch.npz").items()}
step = make_train_step(cfg, tcfg)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
param_sh = S.resolve_param_specs(M.pspec(cfg), mesh)
opt_sh = {"master": param_sh, "m": param_sh, "v": param_sh,
          "step": NamedSharding(mesh, P())}
with compat.set_mesh(mesh):
    p2, o2, m2 = jax.jit(step, in_shardings=(
        param_sh, opt_sh, S.data_specs(mesh, batch)))(params, opt, batch)
CheckpointManager(out_dir + "/sharded").save(1, {"params": p2, "opt": o2})
print(json.dumps({"loss": float(m2["loss"]),
                  "grad_norm": float(m2["grad_norm"])}))
"""


def _load_state(path, step, cfg):
    return convert.train_state_from_jax(
        CheckpointManager(path).load_flat(step), cfg)


def _moe_cfg():
    return configs.reduced_config("granite-moe-1b-a400m", n_layers=2,
                                  d_model=64)


def _moe_state():
    from repro_torch.models import model as M
    params = M.init(_moe_cfg(), torch.Generator().manual_seed(0),
                    device="cpu")
    return params, opt_lib.init_opt_state(params)


def _train_rank(rank, out_dir):
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M

    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")

    def lay_out(state, cfg):
        psh = sharding.resolve_param_specs(M.pspec(cfg), mesh)
        return sharding._map(
            lambda x, sh: x if sh is None else sharding.distribute(x, sh),
            state, {"params": psh, "opt": {"master": psh, "m": psh,
                                           "v": psh, "step": None}})

    def run(cfg, state, m):
        step = train_loop.make_train_step(
            cfg, _tcfg(microbatches=2 if m == 2 else 1),
            plan="qat" if m == "qat" else None, mesh=mesh)
        p, o, mets = step(state["params"], state["opt"], batch)
        got = {"loss": float(mets["loss"]), "ce": float(mets["ce"]),
               "gnorm": float(mets["grad_norm"])}
        for name, tree in (("params", p), ("m", o["m"]), ("v", o["v"])):
            got[name] = opt_lib.tree_map(
                lambda x: x.full_tensor().numpy(), tree)
        return p, o, got

    cfg = _cfg()
    params, opt = _load_state(f"{out_dir}/init", 0, cfg)
    batch = {k: torch.from_numpy(v) for k, v in
             np.load(f"{out_dir}/batch.npz").items()}
    state = lay_out({"params": params, "opt": opt}, cfg)
    out = {}
    for m in (1, 2, "qat"):
        p, o, out[m] = run(cfg, state, m)
        if m == 1:
            saved = {"params": p, "opt": o}
    # MoE: the expert banks and the balance loss over the global batch.
    moe_params, moe_opt = _moe_state()
    _, _, out["moe"] = run(_moe_cfg(), lay_out(
        {"params": moe_params, "opt": moe_opt}, _moe_cfg()), 1)
    # Elastic restore: saved from 2 x 2, restored onto 4 x 1.
    mgr = CheckpointManager(f"{out_dir}/elastic", keep=2)
    mgr.save(1, saved)
    psh = sharding.resolve_param_specs(M.pspec(cfg), mesh)
    mesh_b = mesh_lib.make_mesh((4, 1), device="cpu")
    psh_b = sharding.resolve_param_specs(M.pspec(cfg), mesh_b)
    got = mgr.restore(1, saved, {"params": psh_b,
                                 "opt": {"master": psh_b, "m": psh_b,
                                         "v": psh_b, "step": None}},
                      device="cpu")
    same = []
    for a, b in zip(opt_lib.tree_leaves(saved), opt_lib.tree_leaves(got)):
        if isinstance(b, torch.distributed.tensor.DTensor):
            same.append(tuple(b.device_mesh.shape) == (4, 1)
                        and torch.equal(a.full_tensor(), b.full_tensor()))
        else:
            same.append(torch.equal(a, b))
    out["elastic"] = all(same)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_train"))
    np.savez(f"{tmp}/batch.npz", **_batch())
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX), tmp],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    jax_mets = json.loads(r.stdout.strip().splitlines()[-1])
    port = mesh_lib.spawn(_train_rank, 4, device="cpu", args=(tmp,),
                          timeout_s=150, threads=1)
    return tmp, jax_mets, port


def _single(tmp, case):
    """(initial params, params, opt, metrics) of the single-device step."""
    if case == "moe":
        cfg = _moe_cfg()
        params, opt = _moe_state()
    else:
        cfg = _cfg()
        params, opt = _load_state(f"{tmp}/init", 0, cfg)
    p0 = opt_lib.tree_map(lambda x: x.clone(), params)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with train_loop.deterministic():
        p1, o1, m1 = train_loop.make_train_step(
            cfg, _tcfg(microbatches=2 if case == 2 else 1),
            plan="qat" if case == "qat" else None)(params, opt, batch)
    return p0, p1, o1, m1


def _max_diff(a_tree, b_tree) -> float:
    return max(float(np.abs(np.asarray(a, np.float32)
                            - np.asarray(b, np.float32)).max())
               for a, b in zip(opt_lib.tree_leaves(a_tree),
                               opt_lib.tree_leaves(b_tree)))


def _max_abs(tree) -> float:
    return max(float(np.abs(np.asarray(a, np.float32)).max())
               for a in opt_lib.tree_leaves(tree))


def _numpy(tree):
    return opt_lib.tree_map(lambda x: x.numpy(), tree)


ILL_CONDITIONED = 1e-6       # as in test_torch_train_steps.py


def _report(what, got, params, opt, gnorm, p0):
    """The largest differences of ``got`` from the reference step's
    ``params``, ``opt`` (m, v) and ``gnorm``, and their scales.  Parameter
    elements where the first step's ``sqrt(v_hat)`` is below
    ``ILL_CONDITIONED`` (a gradient within ~1e-7 of zero, whose update
    the gradient's rounding noise decides) are reported apart."""
    bc2 = 1 - np.float32(_tcfg().b2)
    out = {"gnorm_rel": abs(got["gnorm"] - gnorm) / gnorm,
           "update": _max_diff(params, p0), "params": 0.0, "ill": 0.0}
    for a, b, v in zip(opt_lib.tree_leaves(got["params"]),
                       opt_lib.tree_leaves(params),
                       opt_lib.tree_leaves(opt["v"])):
        d = np.abs(a - b)
        cond = np.sqrt(v / bc2) >= ILL_CONDITIONED
        out["params"] = max(out["params"], float(d[cond].max(initial=0)))
        out["ill"] = max(out["ill"], float(d[~cond].max(initial=0)))
    for k, ref in (("m", opt["m"]), ("v", opt["v"])):
        out[k] = _max_diff(got[k], ref)
        out[k + "_scale"] = _max_abs(ref)
    print(what, {k: f"{v:.3g}" for k, v in out.items()})
    return out


def _assert_close(d):
    """Within ~10x the largest differences of a CPU run of this file
    (params 3.0e-8, m 3.6e-9 of 2.8e-3 and v 4.7e-11 of 3.8e-5 against
    JAX, grad_norm 1e-7 relative): a first AdamW step moves each element by
    about lr (here 1.7e-4) whatever the gradient's scale, so m, v and
    grad_norm hold the gradient's all-reduce and token weights.
    Ill-conditioned parameter elements (measured up to 4.1e-6) are held
    to the step's update."""
    assert d["params"] < 1e-6, d
    assert d["ill"] <= 1.01 * d["update"], d
    assert d["m"] < 1e-5 * d["m_scale"], d
    assert d["v"] < 1e-5 * d["v_scale"], d
    assert d["gnorm_rel"] < 1e-5, d


@pytest.mark.parametrize("case", [1, 2, "qat", "moe"])
def test_mesh_train_step_matches_single_device(runs, case):
    tmp, _, port = runs
    p0, p1, o1, m1 = _single(tmp, case)
    got = port[0][case]
    assert abs(got["loss"] - float(m1["loss"])) < 1e-3
    assert abs(got["ce"] - float(m1["ce"])) < 1e-3
    _assert_close(_report(f"mesh vs one device ({case}):", got, _numpy(p1),
                          {k: _numpy(o1[k]) for k in ("m", "v")},
                          float(m1["grad_norm"]), _numpy(p0)))
    # Every rank ends with the same parameters.
    for r in port[1:]:
        assert _max_diff(r[case]["params"], got["params"]) == 0.0


def test_mesh_train_step_matches_jax_sharded_step(runs):
    tmp, jax_mets, port = runs
    got = port[0][1]
    assert abs(got["loss"] - jax_mets["loss"]) < 1e-3
    cfg = _cfg()
    want, want_opt = _load_state(f"{tmp}/sharded", 1, cfg)
    p0, _ = _load_state(f"{tmp}/init", 0, cfg)
    _assert_close(_report("mesh vs JAX's sharded step:", got, _numpy(want),
                          {k: _numpy(want_opt[k]) for k in ("m", "v")},
                          jax_mets["grad_norm"], _numpy(p0)))

def test_elastic_restore_across_meshes_and_one_device(runs):
    tmp, _, port = runs
    assert all(r["elastic"] for r in port)
    cfg = _cfg()
    params, opt = _load_state(f"{tmp}/init", 0, cfg)
    mgr = CheckpointManager(f"{tmp}/elastic")
    got = mgr.restore(1, {"params": params, "opt": opt}, device="cpu")
    for a, b in zip(opt_lib.tree_leaves(got["params"]),
                    opt_lib.tree_leaves(port[0][1]["params"])):
        assert torch.equal(a, torch.from_numpy(b))
