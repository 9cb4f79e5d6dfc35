"""The port's roofline package against the JAX package's, and the kernel
wrappers' shape-only arms.

* ``model_flops_for_cell`` equals JAX's for every arch x shape, exactly;
  ``roofline_terms`` equals JAX's on the same result dicts, and
  ``load_cells`` / ``render`` give text byte-identical to JAX's over one
  directory (ok cells, a skipped cell, an old skip record named only by
  its file), with JAX's ``hw`` constants set to the card's in this
  process only (monkeypatch).
* The counter on ``tests/test_roofline.py``'s HLO case: the same program
  in torch on a fake group of 32 ranks (10 iterations of a [8,16]x[16,16]
  matmul and an all-reduce, then one [32,64]x[64,8] matmul) gives JAX's
  ``hlo_parse.aggregate`` flops, all-reduce count and wire bytes.
* Under FakeTensorMode each kernel wrapper (K1-K5 and the decode merge)
  returns its plain version's shape and dtype on real tensors, records
  its formulas' operations and bytes, and neither builds a kernel nor
  counts a launch.
* A reduced decode step counted on real CPU tensors and on fake ones
  gives the same flops, traffic and K1 records.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.roofline import analysis, hw, op_count, report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_roofline.py's case: a 10-trip loop of a dot and an all-reduce
# over groups of 32, then one dot outside it.
HLO = """
HloModule test

%body.1 (p: (s32[], f32[8,16])) -> (s32[], f32[8,16]) {
  %p = (s32[], f32[8,16]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[8,16]{1,0} get-tuple-element(%p), index=1
  %w = f32[16,16]{1,0} constant({...})
  %dot.1 = f32[8,16]{1,0} dot(%x, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ar = f32[8,16]{1,0} all-reduce(%dot.1), replica_groups=[16,32]<=[512], to_apply=%add.1
  %one = s32[] constant(1)
  %ni = s32[] add(%i, %one)
  ROOT %t = (s32[], f32[8,16]) tuple(%ni, %ar)
}

%cond.1 (p: (s32[], f32[8,16])) -> pred[] {
  %p = (s32[], f32[8,16]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(10)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

%add.1 (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

ENTRY %main.1 (arg: f32[8,16]) -> (s32[], f32[8,16]) {
  %arg = f32[8,16]{1,0} parameter(0)
  %c0 = s32[] constant(0)
  %init = (s32[], f32[8,16]) tuple(%c0, %arg)
  %big = f32[32,64]{1,0} constant({...})
  %w2 = f32[64,8]{1,0} constant({...})
  %dot.2 = f32[32,8]{1,0} dot(%big, %w2), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  ROOT %wh = (s32[], f32[8,16]) while(%init), condition=%cond.1, body=%body.1, backend_config={"known_trip_count":{"n":"10"}}
}
"""

# The same program in torch, traced on fake tensors as rank 0 of 32.
_HLO_TORCH = """
import json, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, "src")
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import op_count
mesh_lib.init_fake_group(32)
with FakeTensorMode():
    x = torch.empty(8, 16)
    w = torch.empty(16, 16)
    big = torch.empty(32, 64)
    w2 = torch.empty(64, 8)
    with op_count.OpCounter() as c:
        for _ in range(10):
            x = x @ w
            dist.all_reduce(x)
        big @ w2
print(json.dumps(c.aggregate()))
dist.destroy_process_group()
"""


def _jax_hw(monkeypatch):
    """JAX's roofline constants set to the card's, in this process."""
    from repro.roofline import hw as jhw
    for name in ("PEAK_FLOPS_BF16", "PEAK_FLOPS_INT8", "HBM_BW",
                 "ICI_BW_PER_LINK", "HBM_PER_CHIP", "VMEM_PER_CHIP"):
        monkeypatch.setattr(jhw, name, getattr(hw, name))


def test_model_flops_match_jax():
    from repro import configs as jcfg
    from repro.configs.base import SHAPES as JSHAPES
    from repro.roofline import analysis as janalysis

    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    assert list(SHAPES) == list(JSHAPES)
    assert configs.ARCH_IDS == jcfg.ARCH_IDS
    for arch in configs.ARCH_IDS:
        for name in SHAPES:
            assert analysis.model_flops_for_cell(
                configs.get_config(arch), SHAPES[name]) == \
                janalysis.model_flops_for_cell(jcfg.get_config(arch),
                                               JSHAPES[name]), (arch, name)


def _cells():
    """Result dicts of four kinds: ok cells of both quants and meshes, a
    skipped cell, and an old skip record without its identity."""
    rng = np.random.default_rng(0)
    cells = {}
    for arch, shape, mesh, quant in (
            ("qwen3-8b", "decode_32k", "single", "none"),
            ("qwen3-8b", "train_4k", "single", "none"),
            ("granite-moe-1b-a400m", "prefill_32k", "single", "none"),
            ("qwen3-8b", "decode_32k", "single", "w8a8"),
            ("mamba2-1.3b", "long_500k", "multi", "none")):
        coll = analysis.empty_collectives()
        coll["all-gather"] = {"count": 3, "payload_bytes": 1e9,
                              "wire_bytes": float(rng.uniform(1e8, 1e12))}
        coll["all-reduce"] = {"count": 2, "payload_bytes": 1e8,
                              "wire_bytes": float(rng.uniform(1e6, 1e12))}
        cells[f"{arch}__{shape}__{mesh}__{quant}"] = {
            "arch": arch, "shape": shape, "mesh": mesh, "quant": quant,
            "status": "ok", "n_chips": 512 if mesh == "multi" else 256,
            "compile_s": 1.5,
            "flops_per_device": float(rng.uniform(1e10, 1e15)),
            "traffic_bytes_per_device": float(rng.uniform(1e9, 1e13)),
            "collectives": coll,
            "memory": {"argument_bytes": int(rng.integers(1, 2**36)),
                       "output_bytes": 0,
                       "temp_bytes": int(rng.integers(1, 2**36))}}
    cells["qwen3-8b__long_500k__single__none"] = {
        "arch": "qwen3-8b", "shape": "long_500k", "mesh": "single",
        "quant": "none", "status": "skipped",
        "skipped": "skip: pure full-attention arch"}
    cells["deepseek-7b__long_500k__single__none"] = {
        "status": "skipped", "skipped": "skip: pure full-attention arch"}
    return cells


def test_roofline_terms_match_jax(monkeypatch):
    from repro.roofline import analysis as janalysis
    _jax_hw(monkeypatch)
    for c in _cells().values():
        if c.get("status") != "ok":
            continue
        for int8 in (False, True):
            mine = analysis.roofline_terms(c, model_flops=3e15, int8=int8)
            ref = janalysis.roofline_terms(c, model_flops=3e15, int8=int8)
            assert mine.as_dict() == ref.as_dict()


def test_report_text_matches_jax(monkeypatch, tmp_path):
    from repro.roofline import report as jreport
    _jax_hw(monkeypatch)
    for tag, c in _cells().items():
        (tmp_path / f"{tag}.json").write_text(json.dumps(c))
    mine, ref = report.load_cells(str(tmp_path)), \
        jreport.load_cells(str(tmp_path))
    assert mine == ref
    for mesh in ("single", "multi"):
        for quant in ("none", "w8a8"):
            text = report.render(mine, mesh, quant)
            assert text.encode() == jreport.render(ref, mesh,
                                                   quant).encode()
    assert "| deepseek-7b | long_500k | — |" in report.render(mine)
    for c in mine:
        c.setdefault("port", {"jax_layout_argument_bytes": 2**30})
    detail = report.render_detail(mine).splitlines()
    assert len(detail) == 2 + 3          # the single mesh's (arch, shape)s
    row = next(ln for ln in detail if "| qwen3-8b | decode_32k |" in ln)
    assert " / " in row and "| 1.00 |" in row


def test_counter_on_the_hlo_case():
    from repro.roofline import hlo_parse
    out = subprocess.run([sys.executable, "-c", _HLO_TORCH],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    mine = json.loads(out.stdout.strip().splitlines()[-1])
    ref = hlo_parse.aggregate(HLO)
    assert mine["flops"] == ref["flops"] == 4096 * 10 + 32768
    assert mine["unknown_trip_loops"] == ref["unknown_trip_loops"] == 0
    for kind in analysis.COLL_KINDS:
        for field in ("count", "payload_bytes", "wire_bytes"):
            assert mine["collectives"][kind][field] == pytest.approx(
                ref["collectives"][kind][field], rel=1e-12), (kind, field)
    assert mine["collectives"]["all-reduce"]["count"] == 10
    kinds = {it["kind"] for it in mine["top_ops"]}
    assert {"dot", "all-reduce"} <= kinds
    assert set(mine["top_ops"][0]) == set(ref["top_ops"][0])


# ---------------------------------------------------------------------------
# The shape-only arms
# ---------------------------------------------------------------------------

def _no_build(monkeypatch):
    from repro_torch.kernels import build

    def refuse(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(build, "library", refuse)


def _launches():
    from repro_torch.kernels.bitserial_matmul import ops as bs
    from repro_torch.kernels.caat_mac import ops as caat
    from repro_torch.kernels.cim_matmul import ops as cim
    from repro_torch.kernels.paged_attention import ops as paged
    return (cim.launches, bs.launches, caat.launches, paged.decode_launches,
            paged.prefill_launches, paged.merge_launches)


def _kernel_cases():
    """(name, fn, args, kwargs, ops, bytes) of one call of each wrapper on
    real CPU tensors."""
    from repro_torch.core import quant
    from repro_torch.kernels.bitserial_matmul import ops as bs
    from repro_torch.kernels.caat_mac import ops as caat
    from repro_torch.kernels.cim_matmul import ops as cim
    from repro_torch.kernels.paged_attention import ops as paged
    g = torch.Generator().manual_seed(0)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g).to(torch.int8)

    m, k, n = 6, 32, 48
    a, w = torch.randn(2, 3, k, generator=g), i8(k, n)
    ws, bias = torch.rand(n, generator=g) * 1e-2, torch.randn(n, generator=g)
    k1_bytes = m * k * 4 + k * n + 8 * n + 8
    b, h, kvh, d, bs_, nb, wdt, c = 2, 4, 2, 32, 4, 10, 3, 8
    q = torch.randn(b, 1, h, d, generator=g)
    pages = quant.QTensor(i8(nb, bs_, kvh, d),
                          torch.rand(nb, bs_, kvh, 1, generator=g).to(
                              torch.bfloat16))
    tables = torch.randint(0, nb, (b, wdt), generator=g).to(torch.int32)
    n_valid = torch.tensor([5, 12], dtype=torch.int32)
    page = bs_ * kvh * d + bs_ * kvh * 2
    acc = torch.randn(b, kvh, 3, h // kvh, d, generator=g)
    ml = torch.randn(b, kvh, 3, h // kvh, 1, generator=g)
    qp = torch.randn(b, c, h, d, generator=g)
    kn = torch.randn(b, c, kvh, d, generator=g)
    pos = torch.tensor([4, 0], dtype=torch.int32)
    n_tok = torch.tensor([8, 5], dtype=torch.int32)
    a8, r = i8(5, 64), 64
    planes, w_sum = caat.pack_weight_planes(i8(r, 20), r)
    w_eff = torch.randn(9, 9, dtype=torch.float64, generator=g)
    scal = torch.tensor([1 / r, 0.1, 2.0, 1.0])
    return [
        ("cim_matmul", cim.cim_matmul, (a, w, 0.05, ws, bias), {},
         2.0 * m * k * n, k1_bytes + 4 * m * n),
        ("cim_matmul", cim.cim_matmul, (a, w, 0.05, ws),
         {"out_scale": 0.3}, 2.0 * m * k * n, k1_bytes + m * n),
        ("cim_matmul", cim.cim_matmul_plain,
         (a.reshape(m, k), w, torch.tensor(0.05), ws, bias,
          torch.tensor(1.0)), {}, None, None),
        ("paged_attention", paged.paged_attention,
         (q, pages, pages, tables, n_valid), {},
         4.0 * b * h * d * wdt * bs_,
         2 * q.numel() * 4 + 2 * b * wdt * page + 4 * (b * wdt + b)),
        ("merge_splits", paged.merge_splits_kernel, (acc, ml, ml), {}, 0.0,
         4 * (acc.numel() + 2 * ml.numel() + b * h * d)),
        ("flash_prefill", paged.paged_prefill,
         (qp, kn, kn, pages, pages, tables, pos, n_tok), {},
         4.0 * b * c * h * d * (wdt * bs_ + c),
         2 * qp.numel() * 4 + 2 * kn.numel() * 4
         + 2 * (b * wdt + b * c // bs_) * page + 4 * (b * wdt + 3 * b)),
        ("bitplane_matmul", bs.bitplane_matmul, (i8(m, k), w, 3), {},
         2.0 * m * k * n, m * k + k * n + 4 * m * n),
        ("caat_mac", caat.caat_mac, (a8, planes[0], w_sum[0], w_eff, scal),
         {}, 2.0 * 64 * 5 * r * 20,
         5 * r + planes[0].numel() + 4 * w_sum[0].numel() + 8 * 81 + 16
         + 4 * 5 * 20),
    ]


def _fake(x, mode):
    if isinstance(x, torch.Tensor):
        return mode.from_tensor(x)
    if hasattr(x, "q") and hasattr(x, "scale"):
        from repro_torch.core import quant
        return quant.QTensor(mode.from_tensor(x.q), mode.from_tensor(x.scale))
    return x


def _meta(out):
    if isinstance(out, tuple):
        out = out[0]
    return tuple(out.shape), out.dtype


@pytest.mark.parametrize("case", range(8))
def test_shape_only_arm(case, monkeypatch):
    """A fake tensor takes the shape-only arm: the plain version's shape
    and dtype, the formulas' record, no build and no launch."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    name, fn, args, kwargs, ops, n_bytes = _kernel_cases()[case]
    if fn.__name__.endswith("_plain"):
        # The plain twin itself is not a wrapper: it counts its aten ops.
        with op_count.OpCounter() as c:
            fn(*args, **kwargs)
        assert c.kernels == {} and c.flops > 0
        return
    if name == "merge_splits":
        from repro_torch.kernels.paged_attention import ops as paged
        ref = paged.merge_splits(*args)
    else:
        ref = fn(*args, **kwargs)
    _no_build(monkeypatch)
    before = _launches()
    mode = FakeTensorMode()
    fargs = [_fake(x, mode) for x in args]
    with mode, op_count.OpCounter() as c:
        out = fn(*fargs, **kwargs)
    got = out[0] if isinstance(out, tuple) else out
    assert isinstance(got, FakeTensor)
    assert _meta(out) == _meta(ref)
    assert _launches() == before
    agg = c.aggregate()
    assert agg["kernels"] == {name: {"records": 1, "ops": ops,
                                     "bytes": float(n_bytes)}}
    assert agg["flops"] == ops and agg["traffic_bytes"] == n_bytes
    if name == "merge_splits":   # a CUDA launch only
        return
    # The real call under a counter records the same work.
    with op_count.OpCounter() as c:
        fn(*args, **kwargs)
    assert c.aggregate()["kernels"] == agg["kernels"]


def test_composites_record_every_launch(monkeypatch):
    """bitserial_matmul records its 8 planes, cim_macro_matmul one
    caat_mac per row tile, on fake tensors as on real ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import macro
    from repro_torch.kernels.bitserial_matmul import ops as bs
    from repro_torch.kernels.caat_mac import ops as caat
    g = torch.Generator().manual_seed(1)
    a = torch.randint(-128, 128, (4, 100), generator=g).to(torch.int8)
    w = torch.randint(-128, 128, (100, 24), generator=g).to(torch.int8)
    with op_count.OpCounter() as real:
        y = bs.bitserial_matmul(a, w, torch.tensor(0.1), torch.ones(24))
    _no_build(monkeypatch)
    mode = FakeTensorMode()
    with mode, op_count.OpCounter() as fake:
        yf = bs.bitserial_matmul(mode.from_tensor(a), mode.from_tensor(w),
                                 mode.from_tensor(torch.tensor(0.1)),
                                 mode.from_tensor(torch.ones(24)))
    assert _meta(yf) == _meta(y)
    assert real.aggregate()["kernels"] == fake.aggregate()["kernels"]
    assert real.kernels["bitplane_matmul"]["records"] == 8
    assert real.flops == fake.flops and real.traffic == fake.traffic
    cfg = macro.MacroConfig(rows=32)
    chip = macro.ideal_chip(cfg, "cpu")
    with op_count.OpCounter() as c:
        caat.cim_macro_matmul(a, w, chip, 1e4, cfg)
    assert c.kernels["caat_mac"]["records"] == -(-100 // 32)


def test_real_and_fake_decode_count_alike():
    """A reduced qwen3-8b decode step under w8a8_kernel, counted on real
    CPU tensors and traced on fake ones: the same flops, traffic bytes
    and K1 records (the CPU rehearsal of the card's gate)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    cfg = configs.reduced_config("qwen3-8b")
    shape = configs.ShapeConfig("d", "decode", 64, 3)
    step = dryrun.decode_step_fn(cfg, dryrun.QUANT_PLAN, None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # The trace first, as chip_smoke.py runs them: nothing it makes
        # may reach the real step.
        with FakeTensorMode(allow_non_fake_inputs=True):
            fparams = dryrun.fake_params(cfg, torch.device("cpu"),
                                         dryrun.QUANT_PLAN, True)
            fspecs = configs.decode_input_specs(cfg, shape)
            fake = dryrun.trace(lambda: step(fparams, fspecs["batch"],
                                             fspecs["caches"]))
        params = M.freeze_params(
            M.init(cfg, torch.Generator().manual_seed(0), device="cpu"),
            plan=dryrun.QUANT_PLAN)
        specs = configs.decode_input_specs(cfg, shape)
        batch = {"tokens": torch.zeros((3, 1), dtype=torch.int32)}
        real = dryrun.trace(lambda: step(params, batch, specs["caches"]))
    finally:
        torch.set_num_threads(threads)
    for key in ("flops", "traffic_bytes", "kernels"):
        assert real["agg"][key] == fake["agg"][key], key
    assert real["agg"]["kernels"]["cim_matmul"]["records"] == \
        cfg.n_layers * 7 + 1
    # Memory differs here: on real CPU tensors K1's plain twin allocates
    # its float64 product; the shape-only arm allocates what the kernel
    # does (the card's real run is held to it in chip_smoke.py).
    assert 0 < fake["temp_bytes"] < real["temp_bytes"]
    assert real["out"][0].shape == fake["out"][0].shape
    assert not isinstance(real["out"][0], FakeTensor)


def test_hw_is_the_cards():
    assert hw.PEAK_FLOPS_BF16 == 989e12 and hw.PEAK_FLOPS_INT8 == 1979e12
    assert hw.HBM_BW == 3.35e12 and hw.ICI_BW_PER_LINK == 450e9
    assert hw.VMEM_PER_CHIP == 228 * 1024 * 132
    assert 79 * 2**30 < hw.HBM_PER_CHIP < 80 * 2**30
    assert analysis.ring_factor("all-reduce", 16) == 2 * 15 / 16
    assert analysis.ring_factor("collective-permute", 2) == 1.0


def test_a_fake_trace_caches_no_tensor():
    """RoPE's frequencies are cached per device for real steps; a fake
    trace gets its own copy, so no fake tensor reaches a later real step
    (on the card a cached fake copy turned the real step fake)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.models import layers
    layers._rope_on.cache_clear()
    with FakeTensorMode(allow_non_fake_inputs=True):
        pos = torch.zeros((2, 3), dtype=torch.int32)
        ang = layers.rope_angles(pos, 16, 1e4)
    assert isinstance(ang, FakeTensor)
    assert layers._rope_on.cache_info().currsize == 0
    real = layers.rope_angles(torch.zeros((2, 3), dtype=torch.int32), 16,
                              1e4)
    assert not isinstance(real, FakeTensor)
    assert layers._rope_on.cache_info().currsize == 1


@pytest.mark.parametrize("kind,batch,length", [("decode", 2, 64),
                                               ("prefill", 2, 32)])
def test_chip_smoke_card_check_rehearsal(kind, batch, length):
    """``chip_smoke.dryrun_card_check`` on the CPU at a reduced int8-KV
    bf16 qwen3-8b: the trace and the real step agree on every gate (the
    CUDA allocator's gate reads the real step's live bytes here)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.cim_matmul import ops as cim_ops
    sys.path.insert(0, ROOT)
    import chip_smoke
    cfg = dataclasses.replace(configs.reduced_config("qwen3-8b"),
                              kv_cache_dtype="int8", dtype="bfloat16")
    params, plan, _ = chip_smoke.frozen_params(torch, cfg, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        line, failures = chip_smoke.dryrun_card_check(
            torch, cfg, params, plan, kind, batch, length, cim_ops,
            device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert failures == []
    assert line["k1_records"] == {"fake": 15, "real": 15}
    assert line["flops"]["fake"] == line["flops"]["real"] > 0
    assert line["bound_ms"] > 0 and line["step_ms"] > 0
