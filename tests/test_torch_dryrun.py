"""The port's dry run (``launch/dryrun.py``) against the JAX package's, on
reduced configs and small shapes (decode 64 x 4, prefill 32 x 4, train
32 x 4): JAX's ``run_cell`` compiles each cell on 4 forced host devices
(``AxisType.Auto`` mesh), the port's traces it on rank 0 of a fake group
of 4 ranks (``--device cpu``); each side in a subprocess of its own, the
two at once.

Cells: reduced qwen3-8b x {decode, prefill, train} x {none, w8a8},
reduced granite-moe-1b-a400m x decode x none, and long_500k (JAX's skip
record).  On the 2 x 2 ("data", "model") mesh:

* the JSON keys are JAX's plus ``port``; the skip record is JAX's;
* ``argument_bytes`` equals JAX's ``memory_analysis()`` on every cell:
  a decode cell's caches are the rank's shards as ``cache_specs`` lays
  them out (batch over data, sequence over model), and the cell's
  ``port.jax_layout_argument_bytes`` is JAX's figure; with
  ``seq_shard=False`` the caches are the port's own ``shard_bytes`` of
  ``cache_specs(..., seq_shard=False)`` (batch rows only);
* ``flops_per_device`` is JAX's loop-aware HLO dot count plus the work
  the port's rank does that XLA splits over 'model', counted here from
  the config, exactly: serving, the row-parallel linears (o, down) at
  their full K, a prefill's attention over every head and MoE's router
  (all gathered whole by ``spmd.gather_block``), each (m - 1) / m of it
  extra (a decode step's attention runs on the rank's sequence shard,
  as XLA splits it); training, the whole step (every block gathered
  whole), m times JAX's;
* the w8a8 cells' K1 records sum to 2 M K N over the linears, counted
  here from the config (columns over 'model' for q, k, v, gate, up and
  the head); JAX's HLO count is printed beside;
* train x w8a8 fails on both sides: int8 weights take no gradient.

On a 4 x 1 mesh, where the two layouts agree, flops and argument bytes
are exactly JAX's on every cell traced there.

At production size, qwen3-8b decode_32k w8a8 on rank 0 of the fake
16 x 16 group, the port's token lookup in the rank's d-shard of the
table (``spmd.gather_table``) against the table gathered whole
(``spmd.gather_block``, the lookup before it): the same flops and
argument bytes (JAX's layout), one all-gather of the rank's rows in
place of the table's, and a temp lower by at least the table less its
shard.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = [("qwen3-8b", s, q) for s in ("d_small", "p_small", "t_small")
         for q in ("none", "w8a8")] + [
    ("granite-moe-1b-a400m", "d_small", "none"),
    ("qwen3-8b", "long_500k", "none")]
DECODE_CELLS = [("qwen3-8b", "d_small", "none"),
                ("qwen3-8b", "d_small", "w8a8"),
                ("granite-moe-1b-a400m", "d_small", "none")]
CELLS_4X1 = [("qwen3-8b", s, "none") for s in ("d_small", "p_small",
                                                 "t_small")] + [
    ("qwen3-8b", "d_small", "w8a8")]
# (query length, KV length) of the small serving shapes.
_SEQ = {"d_small": (1, 64), "p_small": (32, 32)}

_COMMON = """
import json, sys
sys.path.insert(0, "src")
CELLS = %(cells)r
CELLS_4X1 = %(cells_4x1)r
DECODE_CELLS = %(decode_cells)r
MESHES = %(meshes)r

def small(cfg_lib, SHAPES, ShapeConfig):
    get = cfg_lib.get_config

    def reduced(arch):
        cfg_lib.get_config = get
        try:
            return cfg_lib.reduced_config(arch)
        finally:
            cfg_lib.get_config = reduced
    cfg_lib.get_config = reduced
    SHAPES.update({"d_small": ShapeConfig("d_small", "decode", 64, 4),
                   "p_small": ShapeConfig("p_small", "prefill", 32, 4),
                   "t_small": ShapeConfig("t_small", "train", 32, 4)})

def run(run_cell, cells):
    out = {}
    for arch, shape, quant in cells:
        key = f"{arch}/{shape}/{quant}"
        try:
            r = run_cell(arch, shape, "single", quant=quant)
            r.pop("top_ops", None)
            out[key] = r
        except Exception as e:
            out[key] = {"error": repr(e)}
    return out
"""

_JAX = _COMMON + """
import math
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
assert len(jax.devices()) == 4
from repro import configs as cfg_lib
from repro.configs.base import SHAPES, ShapeConfig
from repro.distributed import sharding as shard_lib
from repro.launch import dryrun
small(cfg_lib, SHAPES, ShapeConfig)
auto = (jax.sharding.AxisType.Auto,) * 2
res = {}
for shape, cells in (((2, 2), CELLS), ((4, 1), CELLS_4X1)):
    if "x".join(map(str, shape)) not in MESHES:
        continue
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=auto)
    dryrun.make_production_mesh = lambda multi_pod=False: mesh
    out = run(dryrun.run_cell, cells)
    for arch in ("qwen3-8b", "granite-moe-1b-a400m"):
        cfg = cfg_lib.get_config(arch)
        sh = SHAPES["d_small"]
        caches = cfg_lib.decode_input_specs(cfg, sh)["caches"]
        specs = shard_lib.cache_specs(mesh, caches, cfg, sh.global_batch,
                                      seq_shard=True)
        out[f"{arch}/cache_shard_bytes"] = int(sum(
            math.prod(s.shard_shape(c.shape)) * np.dtype(c.dtype).itemsize
            for c, s in zip(jax.tree.leaves(caches), jax.tree.leaves(specs))))
    res["x".join(map(str, shape))] = out
print("RESULT " + json.dumps(res))
"""

_PORT = _COMMON + """
import torch
torch.set_num_threads(1)
from repro_torch import configs as cfg_lib
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun, mesh as mesh_lib
small(cfg_lib, SHAPES, ShapeConfig)
res = {}
for shape, cells in (((2, 2), CELLS), ((4, 1), CELLS_4X1)):
    mesh_lib.init_fake_group(4)
    mesh = mesh_lib.make_mesh(shape, device="cpu")
    res["x".join(map(str, shape))] = run(
        lambda *a, **kw: dryrun.run_cell(*a, device="cpu", mesh=mesh, **kw),
        cells)
    if shape == (2, 2):
        res["2x2"].update({k + "/noseq": v for k, v in run(
            lambda *a, **kw: dryrun.run_cell(*a, device="cpu", mesh=mesh,
                                             seq_shard=False, **kw),
            DECODE_CELLS).items()})
    torch.distributed.destroy_process_group()
print("RESULT " + json.dumps(res))
"""


_PROD = _COMMON + """
import torch
torch.set_num_threads(1)
from repro_torch.distributed import spmd
from repro_torch.launch import dryrun
res = {}
for lookup in ("shard", "whole"):
    if lookup == "whole":
        spmd.gather_table = spmd.gather_block
    r = dryrun.run_cell("qwen3-8b", "decode_32k", "single", quant="w8a8",
                        device="cpu")
    r.pop("top_ops")
    res[lookup] = r
print("RESULT " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def results():
    """Both sides' cells; JAX's two meshes compile in two processes beside
    the port's and its production decode cell, all at once."""
    runs = (("jax", _JAX, ("2x2",)), ("jax", _JAX, ("4x1",)),
            ("port", _PORT, ("2x2", "4x1")), ("prod", _PROD, ()))
    procs = [(side, subprocess.Popen(
        [sys.executable, "-c", code % {"cells": CELLS,
                                       "cells_4x1": CELLS_4X1,
                                       "decode_cells": DECODE_CELLS,
                                       "meshes": meshes}],
        cwd=ROOT, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for side, code, meshes in runs]
    out: dict = {"jax": {}, "port": {}, "prod": {}}
    for side, p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"{side}: {stderr[-3000:]}"
        line = next(ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT "))
        out[side].update(json.loads(line[len("RESULT "):]))
    return out


def _port_cache_bytes(arch: str) -> int:
    """The port's own reckoning of the caches a rank of the 2 x 2 mesh
    holds under ``cache_specs(..., seq_shard=False)``: its 2 rows of 4,
    every position and head."""
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    cfg = configs.reduced_config(arch)
    full = configs.decode_input_specs(
        cfg, configs.ShapeConfig("d", "decode", 64, 4),
        device="meta")["caches"]
    mesh = sharding.AbstractMesh((2, 2), ("data", "model"))
    return dryrun.shard_bytes(full, sharding.cache_specs(
        mesh, full, cfg, 4, seq_shard=False))


def _k1_ops(arch: str, kind: str, rows: int, m: int) -> float:
    """2 M K N over the K1 calls of one rank's step: ``rows`` rows of the
    batch on a mesh whose model axis is ``m``; q, k, v, gate, up and the
    head keep their columns' model shard, o and down run at full width;
    the prefill head sees each row's last position only."""
    from repro_torch import configs
    cfg = configs.reduced_config(arch)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    tokens = rows * (32 if kind == "p_small" else 1)
    col = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
           (d, cfg.n_kv_heads * hd), (d, cfg.d_ff), (d, cfg.d_ff)]
    full = [(cfg.n_heads * hd, d), (cfg.d_ff, d)]
    per_token = sum(k * n // m for k, n in col) + sum(k * n for k, n in full)
    head = rows * d * cfg.padded_vocab // m
    return 2.0 * (cfg.n_layers * tokens * per_token + head)


def test_keys_and_skip_are_jax(results):
    jax, port = results["jax"]["2x2"], results["port"]["2x2"]
    for key, ref in jax.items():
        if not isinstance(ref, dict) or ref.get("status") != "ok":
            continue
        assert set(port[key]) == set(ref) | {"port"}, key
    skip = "qwen3-8b/long_500k/none"
    assert port[skip] == jax[skip]
    assert jax[skip]["status"] == "skipped"
    assert jax[skip]["skipped"].startswith("skip: pure full-attention")


def test_train_w8a8_fails_on_both_sides(results):
    for side in ("jax", "port"):
        err = results[side]["2x2"]["qwen3-8b/t_small/w8a8"]["error"]
        assert "int8" in err or "floating point" in err, (side, err)


@pytest.mark.parametrize("kind", ["p_small", "t_small"])
def test_argument_bytes_exact(results, kind):
    for quant in ("none", "w8a8"):
        key = f"qwen3-8b/{kind}/{quant}"
        ref = results["jax"]["2x2"][key]
        if "error" in ref:
            continue
        assert results["port"]["2x2"][key]["memory"]["argument_bytes"] \
            == ref["memory"]["argument_bytes"], key


@pytest.mark.parametrize("arch,quant", [("qwen3-8b", "none"),
                                        ("qwen3-8b", "w8a8"),
                                        ("granite-moe-1b-a400m", "none")])
def test_decode_argument_bytes_by_layout(results, arch, quant):
    key = f"{arch}/d_small/{quant}"
    ref = results["jax"]["2x2"][key]["memory"]["argument_bytes"]
    jax_caches = results["jax"]["2x2"][f"{arch}/cache_shard_bytes"]
    got = results["port"]["2x2"][key]
    # The caches split over sequence as JAX splits them: JAX's bytes.
    assert got["memory"]["argument_bytes"] == ref
    assert got["port"]["cache_seq_shard"] is True
    # The dry run's own reckoning of JAX's layout (reported per cell).
    assert got["port"]["jax_layout_argument_bytes"] == ref
    # --no-seq-shard: the caches cache_specs(..., seq_shard=False) lays
    # out, by the port's own shard_bytes.
    port_caches = _port_cache_bytes(arch)
    assert port_caches > jax_caches
    noseq = results["port"]["2x2"][key + "/noseq"]
    assert noseq["memory"]["argument_bytes"] == \
        ref - jax_caches + port_caches
    assert noseq["port"]["cache_seq_shard"] is False
    assert noseq["port"]["jax_layout_argument_bytes"] == ref


def _unsplit_flops(arch: str, kind: str, rows: int) -> float:
    """Flops of one rank's serving step that the port runs whole and XLA
    splits over 'model': ``rows`` rows; o and (dense) down at their full
    K, a prefill's q.k and p.v over every head (the whole score matrix,
    as both count dots; a decode step's run on the rank's sequence shard
    of the cache, 1/m of them, as XLA's), MoE's router.  The experts, q,
    k, v, gate, up and the head keep their model shard on both sides."""
    from repro_torch import configs
    cfg = configs.reduced_config(arch)
    d, hd, h = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    sq, skv = _SEQ[kind]
    tokens = rows * sq
    per_layer = 2 * tokens * h * hd * d
    if kind != "d_small":
        per_layer += 4 * rows * h * hd * sq * skv
    if cfg.moe is None:
        per_layer += 2 * tokens * cfg.d_ff * d
    else:
        per_layer += 2 * tokens * d * cfg.moe.n_experts
    return float(cfg.n_layers * per_layer)


@pytest.mark.parametrize("arch,kind", [("qwen3-8b", "d_small"),
                                       ("qwen3-8b", "p_small"),
                                       ("qwen3-8b", "t_small"),
                                       ("granite-moe-1b-a400m", "d_small")])
def test_flops_against_jax(results, arch, kind):
    """On the 2 x 2 mesh (2 rows a rank, m = 2) the port's flops are
    JAX's plus what XLA splits over 'model' and the port does not."""
    key = f"{arch}/{kind}/none"
    ref = results["jax"]["2x2"][key]["flops_per_device"]
    got = results["port"]["2x2"][key]["flops_per_device"]
    m = 2
    if kind == "t_small":
        want = m * ref
    else:
        want = ref + _unsplit_flops(arch, kind, 2) * (m - 1) / m
    print(f"{key}: port {got:.0f} JAX {ref:.0f} want {want:.0f}")
    assert got == want


@pytest.mark.parametrize("kind", ["d_small", "p_small"])
def test_k1_records_sum_to_the_linears(results, kind):
    key = f"qwen3-8b/{kind}/w8a8"
    k1 = results["port"]["2x2"][key]["port"]["kernels"]["cim_matmul"]
    from repro_torch import configs
    assert k1["records"] == configs.reduced_config("qwen3-8b").n_layers * 7 + 1
    assert k1["ops"] == _k1_ops("qwen3-8b", kind, 2, 2)
    print(f"{key}: K1 ops {k1['ops']:.0f}; JAX's HLO dot count "
          f"{results['jax']['2x2'][key]['flops_per_device']:.0f}")


def test_layouts_agree_on_4x1(results):
    jax, port = results["jax"]["4x1"], results["port"]["4x1"]
    for key, ref in jax.items():
        if "/" not in key or key.endswith("bytes"):
            continue
        got = port[key]
        assert got["flops_per_device"] == ref["flops_per_device"], key
        assert got["memory"]["argument_bytes"] == \
            ref["memory"]["argument_bytes"], key
    k1 = port["qwen3-8b/d_small/w8a8"]["port"]["kernels"]["cim_matmul"]
    assert k1["ops"] == _k1_ops("qwen3-8b", "d_small", 1, 1)


def test_production_decode_lookup_is_shard_local(results):
    from repro_torch import configs
    shard, whole = results["prod"]["shard"], results["prod"]["whole"]
    cfg = configs.get_config("qwen3-8b")
    g = 16                                  # the 'model' axis
    table = cfg.padded_vocab * cfg.d_model * 2
    rows = 128 // 16 * cfg.d_model * 2      # this rank's 8 rows, bf16
    for r in (shard, whole):
        assert r["memory"]["argument_bytes"] == 2_524_963_108
        assert r["port"]["jax_layout_argument_bytes"] == 2_524_963_108
    assert shard["flops_per_device"] == whole["flops_per_device"]
    a, b = (r["collectives"]["all-gather"] for r in (shard, whole))
    assert a["count"] == b["count"]
    assert b["payload_bytes"] - a["payload_bytes"] == (table - rows) * g
    drop = whole["memory"]["temp_bytes"] - shard["memory"]["temp_bytes"]
    print(f"temp {whole['memory']['temp_bytes']} -> "
          f"{shard['memory']['temp_bytes']} B; the table {table} B")
    assert drop >= table * (g - 1) / g


def test_dryrun_module_needs_no_card_for_cpu():
    from repro_torch.launch import dryrun
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.check_device("cuda")


def test_cli_writes_jax_skip_record(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch qwen3-8b --shape
    long_500k`` writes JAX's skip record (its reason word for word)."""
    from repro import configs as jcfg
    from repro.configs.base import SHAPES as JSHAPES
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-8b", "--shape", "long_500k", "--device", "cpu", "--out",
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads((tmp_path / "qwen3-8b__long_500k__single__none.json")
                     .read_text())
    ok, reason = jcfg.cell_is_runnable(jcfg.get_config("qwen3-8b"),
                                       JSHAPES["long_500k"])
    assert not ok
    assert got == {"arch": "qwen3-8b", "shape": "long_500k",
                   "quant": "none", "skipped": reason, "mesh": "single",
                   "kv_quant": False, "status": "skipped"}
