"""The residual stream d-sharded over 'model' on the port's mesh path, as
the JAX package lays it out: the token lookup in the rank's d-shard of
the table (``spmd.gather_table``) and ``act_shard`` (a dense block's
output stored as the rank's d-chunk, ``sharding.constrain(...,
carry=True)``, made whole at the next block's entry,
``spmd.model_whole``).  On a 2 x 2 (data, model) mesh of 4 gloo ranks,
reduced configs, one thread a rank:

* (a) serving (``launch.serve.static_generate``, ``w8a8``): greedy tokens
  and prefill logits ``torch.equal`` to one device for qwen3-8b with
  ``act_shard`` off and on and zamba2-2.7b with it on (its shared dense
  block hands a chunk to an SSM block), and the counter sees no
  all-gather of the whole table's bytes (V x d/m x m), where the
  parent's lookup (``gather_block`` of the table, rebuilt here) does;
* (b) the lookup and the table's gradient: each rank's embedding output
  and its table gradient shard ``torch.equal`` to what it gets from the
  table gathered whole (``gather_block``) and sliced, in a serving and a
  training scope;
* (c) two remat'd train steps with ``act_shard`` on against off
  (qwen3-8b, zamba2-2.7b): loss, grad norm, params and AdamW's m and v
  ``torch.equal``;
* (d) the ``act_shard`` train step against JAX's ``act_shard`` step on
  its 2 x 2 CPU mesh (``AxisType.Auto``), from JAX's initial state,
  within ``tests/test_torch_mesh_train.py``'s bounds.

Beside them, in a process of its own, the dry run on rank 0 of a fake
4 x 4 group (``launch.dryrun.run_cell``, a train cell of 16 x 128
tokens):

* (e) reduced qwen3-8b's traced temp grows per layer by one remat carry
  (its 4 rows x 128 x d x 4 B: 131,072 B) without the flag and by its
  d-chunk with it: the slope falls by the carry's (m - 1) / m, counted
  from the config; flops and argument bytes equal.  (At 32 tokens a row
  the chunk, 8,192 B, is below a layer's gradient shards, 16,000 B, and
  the peak moves to the end of the backward, where every layer's
  gradient shard is alive: 32,768 -> 16,000 B a layer.)
* (f) a ``moe`` (granite-moe) and an ``ssm`` (mamba2) stack: temp,
  flops, traffic and argument bytes unchanged by the flag (JAX reads it
  in ``dense_block`` only).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.train import optimizer as opt_lib
from test_torch_mesh_train import (_assert_close, _batch, _cfg,
                                   _load_state, _numpy, _report, _tcfg)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BATCH, PROMPT, NEW = 4, 16, 4
SERVE_CASES = [("qwen3-8b", False), ("qwen3-8b", True),
               ("zamba2-2.7b", True)]
STEP_ARCHS = ("qwen3-8b", "zamba2-2.7b")
STEPS = 2


def _act(cfg, flag: bool):
    return dataclasses.replace(cfg, act_shard=flag)


def _serve(arch, flag, mesh=None):
    from repro_torch.distributed import sharding
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serve import prng

    cfg = _act(configs.reduced_config(arch), flag)
    params = M.freeze_params(
        M.init(cfg, torch.Generator().manual_seed(0), device="cpu"),
        a_scale=0.05, plan="w8a8")
    if mesh is not None:
        params = sharding.distribute(params, sharding.resolve_param_specs(
            M.freeze_pspec(M.pspec(cfg), plan="w8a8"), mesh))
    prompts = prng.randint(prng.PRNGKey(1), (BATCH, PROMPT), 0, cfg.vocab)
    return serve.static_generate(params, cfg, prompts, NEW,
                                 max_len=PROMPT + NEW + 4, plan="w8a8",
                                 mesh=mesh)


def _table_bytes(arch) -> int:
    cfg = configs.reduced_config(arch)
    return cfg.padded_vocab * cfg.d_model * 4


def _largest_gathers(mesh, arch, flag) -> tuple:
    """(tokens, logits, the largest all-gather's bytes) of a mesh serve
    under the counter."""
    from repro_torch.roofline import op_count
    with op_count.OpCounter() as counter:
        tokens, logits = _serve(arch, flag, mesh)
    gathered = [b for kind, b, _ in counter.coll_records
                if kind == "all-gather"]
    return tokens.numpy(), logits.numpy(), max(gathered)


def _serve_cases(mesh) -> dict:
    from repro_torch.distributed import spmd
    out = {(arch, flag): _largest_gathers(mesh, arch, flag)
           for arch, flag in SERVE_CASES}
    # The parent's lookup: the table gathered whole by gather_block.
    shard_local = spmd.gather_table
    spmd.gather_table = spmd.gather_block
    try:
        out["whole_table"] = _largest_gathers(mesh, "qwen3-8b", False)
    finally:
        spmd.gather_table = shard_local
    return out


def _lookup_cases(mesh, rank) -> dict:
    """The shard-local lookup against the table gathered whole and
    sliced: rows, and (training) the table's gradient shard."""
    from repro_torch.distributed import sharding, spmd
    from repro_torch.models import layers

    cfg = configs.reduced_config("qwen3-8b")
    d, m = cfg.d_model, 2
    table = sharding.distribute(
        layers.init_embedding(torch.Generator().manual_seed(0),
                              cfg.padded_vocab, d, torch.float32),
        sharding.resolve_param_specs(layers.embedding_pspec(), mesh))
    gen = torch.Generator().manual_seed(10 + mesh.get_local_rank("data"))
    # Each data rank its own rows, with repeated ids.
    ids = torch.randint(0, 24, (2, 16), generator=gen)
    w = torch.randn((2, 16, d), generator=gen)
    lo = mesh.get_local_rank("model") * d // m
    out = {}
    with spmd.scope(mesh):
        whole = layers.embed(spmd.gather_block(table), ids)
        part = layers.embed(spmd.gather_table(table), ids)
        out["serve_rows"] = bool(
            part.shape == (2, 16, d // m)
            and torch.equal(part, whole[..., lo:lo + d // m])
            and torch.equal(spmd.model_whole(part, d), whole))

    def grad(gather):
        local = table["table"].to_local().detach().requires_grad_(True)
        rest = {"table": spmd.Resting(local, table["table"])}
        with spmd.scope(mesh, keep_model=False):
            rows = spmd.model_whole(layers.embed(gather(rest), ids), d)
            (g,) = torch.autograd.grad((rows * w).sum(), [local])
        return rows.detach(), g

    rows_new, g_new = grad(spmd.gather_table)
    rows_old, g_old = grad(spmd.gather_block)
    out["train_rows"] = bool(torch.equal(rows_new, rows_old))
    out["table_grad"] = bool(g_new.shape == (cfg.padded_vocab, d // m)
                             and torch.equal(g_new, g_old))
    return out


def _state(tree):
    return [x.full_tensor() for x in opt_lib.tree_leaves(tree)]


def _two_steps(mesh, arch, flag) -> dict:
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M
    from repro_torch.train import train_loop

    cfg = _act(configs.reduced_config(arch), flag)
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = opt_lib.init_opt_state(params)
    psh = sharding.resolve_param_specs(M.pspec(cfg), mesh)
    params = sharding.distribute(params, psh)
    opt = {**{k: sharding.distribute(opt[k], psh)
              for k in ("master", "m", "v")}, "step": opt["step"]}
    step = train_loop.make_train_step(
        cfg, TrainConfig(total_steps=10, warmup_steps=2, remat=True),
        mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    mets = []
    with train_loop.deterministic():
        for _ in range(STEPS):
            params, opt, met = step(params, opt, batch)
            mets.append(torch.stack([met["loss"], met["grad_norm"]]))
    return {"metrics": torch.stack(mets), "params": _state(params),
            "m": _state(opt["m"]), "v": _state(opt["v"])}


def _steps_equal(mesh) -> dict:
    out = {}
    for arch in STEP_ARCHS:
        on, off = (_two_steps(mesh, arch, flag) for flag in (True, False))
        out[arch] = {k: (bool(torch.equal(on[k], off[k])) if k == "metrics"
                         else all(torch.equal(a, b)
                                  for a, b in zip(on[k], off[k])))
                     for k in on}
        out[arch]["losses"] = on["metrics"][:, 0].tolist()
    return out


def _jax_layout_step(mesh, out_dir) -> dict:
    """The act_shard step from JAX's initial state (written by the JAX
    process, which meanwhile compiles its own step)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M
    from repro_torch.train import train_loop

    done = pathlib.Path(out_dir) / "init_saved"
    deadline = time.monotonic() + 120
    while not done.exists():
        if time.monotonic() > deadline:
            raise TimeoutError("JAX's initial state was not written")
        time.sleep(0.2)
    cfg = _act(_cfg(), True)
    params, opt = _load_state(f"{out_dir}/init", 0, cfg)
    psh = sharding.resolve_param_specs(M.pspec(cfg), mesh)
    state = sharding._map(
        lambda x, sh: x if sh is None else sharding.distribute(x, sh),
        {"params": params, "opt": opt},
        {"params": psh, "opt": {"master": psh, "m": psh, "v": psh,
                                "step": None}})
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    step = train_loop.make_train_step(cfg, _tcfg(), mesh=mesh)
    p, o, mets = step(state["params"], state["opt"], batch)
    got = {"loss": float(mets["loss"]), "ce": float(mets["ce"]),
           "gnorm": float(mets["grad_norm"])}
    for name, tree in (("params", p), ("m", o["m"]), ("v", o["v"])):
        got[name] = opt_lib.tree_map(lambda x: x.full_tensor().numpy(),
                                     tree)
    return got


def _rank(rank, out_dir):
    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    return {"serve": _serve_cases(mesh),
            "lookup": _lookup_cases(mesh, rank),
            "steps": _steps_equal(mesh),
            "jax": _jax_layout_step(mesh, out_dir)}


_JAX = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses, json, pathlib, sys
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
cfg = dataclasses.replace(C.reduced_config("qwen3-8b", n_layers=2,
                                           d_model=64), act_shard=True)
tcfg = TrainConfig(total_steps=10, warmup_steps=2, remat=False)
params = M.init(jax.random.PRNGKey(0), cfg)
opt = opt_lib.init_opt_state(params)
CheckpointManager(out_dir + "/init").save(0, {"params": params, "opt": opt})
pathlib.Path(out_dir, "init_saved").touch()
batch = {k: jnp.asarray(v) for k, v in np.load(out_dir + "/batch.npz").items()}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
param_sh = S.resolve_param_specs(M.pspec(cfg), mesh)
opt_sh = {"master": param_sh, "m": param_sh, "v": param_sh,
          "step": NamedSharding(mesh, P())}
with compat.set_mesh(mesh):
    p2, o2, m2 = jax.jit(make_train_step(cfg, tcfg), in_shardings=(
        param_sh, opt_sh, S.data_specs(mesh, batch)))(params, opt, batch)
CheckpointManager(out_dir + "/sharded").save(1, {"params": p2, "opt": o2})
print(json.dumps({"loss": float(m2["loss"]),
                  "grad_norm": float(m2["grad_norm"])}))
"""

_TRACE = """
import dataclasses, json, sys
sys.path.insert(0, "src")
import torch
torch.set_num_threads(1)
from repro_torch import configs as cfg_lib
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun, mesh as mesh_lib

get = cfg_lib.get_config
LAYERS = [2]

def reduced(arch):
    cfg_lib.get_config = get
    try:
        return cfg_lib.reduced_config(arch, n_layers=LAYERS[0])
    finally:
        cfg_lib.get_config = reduced

cfg_lib.get_config = reduced
SHAPES["t_act"] = ShapeConfig("t_act", "train", 128, 16)
mesh_lib.init_fake_group(16)
mesh = mesh_lib.make_mesh((4, 4), device="cpu")
out = {}
for arch, layers in (("qwen3-8b", (2, 4)), ("granite-moe-1b-a400m", (2,)),
                     ("mamba2-1.3b", (2,))):
    for n in layers:
        LAYERS[0] = n
        for flag in (False, True):
            r = dryrun.run_cell(arch, "t_act", "single", device="cpu",
                                mesh=mesh, act_shard=flag)
            out[f"{arch}/{n}/{flag}"] = {
                "temp": r["memory"]["temp_bytes"],
                "args": r["memory"]["argument_bytes"],
                "flops": r["flops_per_device"],
                "traffic": r["traffic_bytes_per_device"],
                "gathers": r["collectives"]["all-gather"]["count"],
                "micro": r["microbatches"]}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 gloo ranks, JAX's act_shard step and the dry-run traces, all
    at once."""
    tmp = str(tmp_path_factory.mktemp("act_shard"))
    np.savez(f"{tmp}/batch.npz", **_batch())
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), tmp], cwd=ROOT,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, code in (("jax", _JAX), ("trace", _TRACE))}
    try:
        ranks = mesh_lib.spawn(_rank, 4, device="cpu", args=(tmp,),
                               timeout_s=150, threads=1)
        outs = {name: p.communicate(timeout=150)
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p in procs.items():
        assert p.returncode == 0, (name, outs[name][1][-3000:])
    jax_mets = json.loads(outs["jax"][0].strip().splitlines()[-1])
    line = next(ln for ln in outs["trace"][0].splitlines()
                if ln.startswith("RESULT "))
    return {"tmp": tmp, "ranks": ranks, "jax": jax_mets,
            "trace": json.loads(line[len("RESULT "):])}


@pytest.mark.parametrize("arch,flag", SERVE_CASES)
def test_mesh_serve_equals_one_device(runs, arch, flag):
    tokens, logits = _serve(arch, flag)
    for r in runs["ranks"]:
        got_tokens, got_logits, largest = r["serve"][(arch, flag)]
        assert torch.equal(torch.from_numpy(got_tokens), tokens)
        assert torch.equal(torch.from_numpy(got_logits), logits)
        # No all-gather moves the whole table.
        assert largest < _table_bytes(arch), largest


def test_whole_table_gather_is_what_the_counter_would_see(runs):
    """The parent's lookup, rebuilt from ``gather_block``: the same
    tokens and logits, and an all-gather of the whole table's bytes."""
    tokens, logits = _serve("qwen3-8b", False)
    for r in runs["ranks"]:
        got_tokens, got_logits, largest = r["serve"]["whole_table"]
        assert torch.equal(torch.from_numpy(got_tokens), tokens)
        assert torch.equal(torch.from_numpy(got_logits), logits)
        assert largest == _table_bytes("qwen3-8b")


@pytest.mark.parametrize("case", ["serve_rows", "train_rows", "table_grad"])
def test_lookup_equals_whole_table_sliced(runs, case):
    assert all(r["lookup"][case] for r in runs["ranks"])


@pytest.mark.parametrize("arch", STEP_ARCHS)
@pytest.mark.parametrize("what", ["metrics", "params", "m", "v"])
def test_act_shard_train_steps_equal(runs, arch, what):
    for r in runs["ranks"]:
        got = r["steps"][arch]
        print(arch, "losses", got["losses"])
        assert got[what], (arch, what)


def test_act_shard_step_matches_jax_act_shard_step(runs):
    tmp, jax_mets = runs["tmp"], runs["jax"]
    got = runs["ranks"][0]["jax"]
    assert abs(got["loss"] - jax_mets["loss"]) < 1e-3
    cfg = _cfg()
    want, want_opt = _load_state(f"{tmp}/sharded", 1, cfg)
    p0, _ = _load_state(f"{tmp}/init", 0, cfg)
    _assert_close(_report("act_shard mesh vs JAX's act_shard step:", got,
                          _numpy(want),
                          {k: _numpy(want_opt[k]) for k in ("m", "v")},
                          jax_mets["grad_norm"], _numpy(p0)))
    for r in runs["ranks"][1:]:
        for a, b in zip(opt_lib.tree_leaves(r["jax"]["params"]),
                        opt_lib.tree_leaves(got["params"])):
            assert np.array_equal(a, b)


def test_act_shard_shrinks_the_carry_per_layer(runs):
    """(e): temp per layer falls by the carry's (m - 1) / m; flops and
    argument bytes equal."""
    t = runs["trace"]
    cfg = configs.reduced_config("qwen3-8b")
    m, rows, seq = 4, 16 // 4, 128
    assert t["qwen3-8b/2/False"]["micro"] == 1
    carry = rows * seq * cfg.d_model * 4

    def slope(flag):
        return (t[f"qwen3-8b/4/{flag}"]["temp"]
                - t[f"qwen3-8b/2/{flag}"]["temp"]) / 2

    print(f"temp a layer: {slope(False):.0f} B without act_shard, "
          f"{slope(True):.0f} with; carry {carry} B")
    assert slope(False) == carry
    assert slope(False) - slope(True) == carry * (m - 1) / m
    for n in (2, 4):
        off, on = t[f"qwen3-8b/{n}/False"], t[f"qwen3-8b/{n}/True"]
        assert on["flops"] == off["flops"] and on["args"] == off["args"]
        assert on["temp"] < off["temp"]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-1.3b"])
def test_act_shard_leaves_moe_and_ssm_stacks_alone(runs, arch):
    """(f)"""
    t = runs["trace"]
    assert t[f"{arch}/2/True"] == t[f"{arch}/2/False"]
