"""The port's CUDA kernels against their plain PyTorch twins on the card.

Marked ``gpu``: they skip unless an sm_90 card is present.  This file
imports neither JAX nor the JAX package, so it also runs on the machine
with the card, where JAX is absent (there the shared conftest, which
imports JAX, is skipped):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from repro_torch.core import adc, macro
from repro_torch.kernels.bitserial_matmul import ops as bs_ops
from repro_torch.kernels.caat_mac import ops as caat_ops
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.paged_attention import ops as tops


@pytest.fixture
def hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs an sm_90 CUDA card")


@pytest.mark.gpu
def test_cim_matmul_kernel_bit_exact(hopper):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in ((1, 64, 64), (9, 100, 36), (130, 4096, 260),
                    (70, 27, 128), (5, 1024, 10), (3, 13, 7)):
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        ws = torch.rand(n, generator=gen, device="cuda") * 1e-2
        bias = torch.randn(n, generator=gen, device="cuda")
        a = torch.randn(m, k, generator=gen, device="cuda")
        for requant in (False, True):
            args = (a, w, torch.tensor(0.05, device="cuda"), ws, bias,
                    torch.tensor(0.3, device="cuda"))
            assert torch.equal(
                cim_ops.cim_matmul_kernel(*args, requant=requant),
                cim_ops.cim_matmul_plain(*args, requant=requant))


# The int8 GEMM kernels' paths (autotune.cim_matmul_config): decode tiles
# of 8 and 16 tokens over 64- and 128-column tiles with split-K up to 16
# blocks in a cluster, prefill tiles of 64 and 128 tokens with split-K,
# ragged M/N/K tails zero-filled at 16 bytes, and the masked path (K = 27).
GEMM_PATH_SHAPES = [(1, 4096, 1024), (8, 4096, 4096), (13, 2048, 128),
                    (16, 12288, 4096), (17, 1152, 128), (64, 4096, 1024),
                    (509, 4096, 1024), (70, 1040, 48), (130, 208, 272),
                    (70, 27, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", GEMM_PATH_SHAPES)
def test_cim_matmul_gemm_paths_bit_exact(hopper, m, k, n):
    from repro_torch.kernels import autotune
    cfg = autotune.cim_matmul_config(m, n, k, tops.sm_count("cuda"))
    assert cfg.path == ("masked" if k % 16 else "wgmma")
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    ws = torch.rand(n, generator=gen, device="cuda") * 1e-3
    bias = torch.randn(n, generator=gen, device="cuda")
    a32 = torch.randn(m, k, generator=gen, device="cuda") * 2.0
    a8 = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                       dtype=torch.int32).to(torch.int8)
    for a in (a32, a8):
        for relu, requant in ((False, False), (True, False), (False, True),
                              (True, True)):
            args = (a, w, torch.tensor(0.05, device="cuda"), ws, bias,
                    torch.tensor(0.3, device="cuda"))
            assert torch.equal(
                cim_ops.cim_matmul_kernel(*args, relu=relu, requant=requant),
                cim_ops.cim_matmul_plain(*args, relu=relu, requant=requant))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", GEMM_PATH_SHAPES)
def test_bitplane_gemm_paths_bit_exact(hopper, m, k, n):
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    a, w = _i8(gen, (m, k)), _i8(gen, (k, n), -127)
    for plane in (0, 3, 7):
        assert torch.equal(bs_ops.bitplane_matmul_kernel(a, w, plane),
                           bs_ops.bitplane_matmul_plain(a, w, plane))


def _pages(gen, shape, kind):
    """Two random pools of ``kind`` ("f32", "bf16" or "int8"): (k, v, k_scale,
    v_scale), the scales None for fp pools."""
    if kind == "int8":
        kp, vp = (torch.randint(-127, 128, shape, generator=gen,
                                device="cuda", dtype=torch.int32).to(
                                    torch.int8) for _ in range(2))
        ks, vs = ((torch.rand(shape[:3], generator=gen, device="cuda")
                   * 0.05).to(torch.bfloat16) for _ in range(2))
        return [kp, vp, ks, vs]
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2)] + [None, None]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bs", [16, 32])
def test_decode_kernel_matches_plain(hopper, kind, g, d, bs):
    """K2 at split counts 1, 3, the card's heuristic and the table width,
    one row with n_valid = 0 (zeros), within 1e-4 of its plain twin."""
    from repro_torch.kernels import autotune
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, kvh, w = 4, 2, 8
    nb = b * w + 1
    tables = (torch.randperm(nb - 1, generator=gen, device="cuda")[:b * w]
              + 1).reshape(b, w).to(torch.int32)
    n_valid = torch.tensor([0, 5, 3 * bs + 7, w * bs], dtype=torch.int32,
                           device="cuda")
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda")
    kp, vp, ks, vs = _pages(gen, (nb, bs, kvh, d), kind)
    card = autotune.heuristic_paged_splits_cuda(b, kvh, w,
                                                tops.sm_count("cuda"))
    for splits in (1, 3, card, w):
        args = (q, kp, vp, ks, vs, tables, n_valid)
        got = tops.merge_splits(*tops.paged_attention_kernel(
            *args, kv_splits=splits))
        want = tops.merge_splits(*tops.paged_attention_plain(
            *args, kv_splits=splits))
        assert (got - want).abs().max().item() <= 1e-4, splits
        assert not got[0].any(), "the n_valid = 0 row must be zeros"


@pytest.mark.gpu
@pytest.mark.parametrize("ns", [1, 3, 8, 64])
def test_merge_splits_kernel_matches_plain(hopper, ns):
    """The one-launch merge against merge_splits, a dead split and an
    empty row included; and the public decode wrapper, which runs K2 at
    the card's split count and this merge, against the plain path."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, kvh, g, d = 3, 2, 4, 128
    acc = torch.randn(b, kvh, ns, g, d, generator=gen, device="cuda")
    m = torch.randn(b, kvh, ns, g, 1, generator=gen, device="cuda") * 4
    l = torch.rand(b, kvh, ns, g, 1, generator=gen, device="cuda") + 0.5
    for t, v in ((acc, 0.0), (m, tops.NEG_INF), (l, 0.0)):
        t[0, 0, ns // 2] = v
        t[2] = v
    got = tops.merge_splits_kernel(acc, m, l)
    assert (got - tops.merge_splits(acc, m, l)).abs().max().item() <= 1e-5
    assert not got[2].any()
    w, bs = 8, 16
    kp, vp, ks, vs = _pages(gen, (b * w + 1, bs, kvh, d), "int8")
    tables = (torch.arange(b * w, device="cuda", dtype=torch.int32)
              + 1).reshape(b, w)
    n_valid = torch.tensor([0, 9, w * bs], dtype=torch.int32, device="cuda")
    q = torch.randn(b, 1, kvh * g, d, generator=gen, device="cuda")
    pk, pv = (tops.quant.QTensor(c, s_[..., None]) for c, s_ in
              ((kp, ks), (vp, vs)))
    out = tops.paged_attention(q, pk, pv, tables, n_valid)
    want = tops.merge_splits(*tops.paged_attention_plain(
        q.reshape(b, kvh, g, d), kp, vp, ks, vs, tables, n_valid,
        kv_splits=1)).reshape(b, 1, kvh * g, d)
    assert (out - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("g,bs", [(4, 16), (1, 8)])
def test_prefill_kernel_matches_plain(hopper, dtype, int8, g, bs):
    """K3 at pos 0, 64 and 1024 with a ragged n_tok and a masked row:
    outputs within 1e-3 (plus one bf16 ulp for bf16 outputs), written
    pages bit-exact, the masked row's blocks untouched.  bf16 over int8 or
    bf16 pages is the tensor-core instantiation; G=1 with BS=8 has fewer
    query tiles than chunk pages."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, kvh, d, c = 4, 2, 128, 64
    w = (1024 + c) // bs
    nb = b * w + 1
    tables = (torch.randperm(nb - 1, generator=gen, device="cuda")[:b * w]
              + 1).reshape(b, w).to(torch.int32)
    pos = torch.tensor([0, 64, 1024, 64], dtype=torch.int32, device="cuda")
    n_tok = torch.tensor([64, 20, 64, 64], dtype=torch.int32, device="cuda")
    wm = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device="cuda")
    q = torch.randn(b, kvh, c * g, d, generator=gen, device="cuda").to(dtype)
    k_new = torch.randn(b, c, kvh, d, generator=gen, device="cuda").to(dtype)
    v_new = torch.randn(b, c, kvh, d, generator=gen, device="cuda").to(dtype)
    kind = "int8" if int8 else ("f32" if dtype == torch.float32 else "bf16")
    pool = _pages(gen, (nb, bs, kvh, d), kind)
    p1 = [t.clone() if t is not None else None for t in pool]
    p2 = [t.clone() if t is not None else None for t in pool]
    got = tops.flash_prefill_kernel(q, k_new, v_new, *p1, tables, pos, n_tok,
                                    wm).float()
    want = tops.flash_prefill_plain(q, k_new, v_new, *p2, tables, pos,
                                    n_tok, wm).float()
    tol = 1e-3 + (2.0 ** -7 * want.abs() if dtype == torch.bfloat16 else 0.0)
    assert bool(((got - want).abs() <= tol).all())
    masked = tables[3, 64 // bs:(64 + c) // bs].long()
    for a, b_, orig in zip(p1, p2, pool):
        if a is not None:
            assert torch.equal(a[1:], b_[1:])
            assert torch.equal(a[masked], orig[masked])


def _i8(gen, shape, lo=-128):
    return torch.randint(lo, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.int8)


@pytest.mark.gpu
def test_bitplane_kernel_bit_exact(hopper):
    """K4 per plane at ragged shapes (conv1's K = 27, the head's N = 10),
    and the 8-pass wrapper against the same shift-add over plain planes."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    for m, k, n in ((70, 27, 128), (33, 1152, 10), (5, 200, 70)):
        a, w = _i8(gen, (m, k)), _i8(gen, (k, n), -127)
        for plane in range(8):
            assert torch.equal(bs_ops.bitplane_matmul_kernel(a, w, plane),
                               bs_ops.bitplane_matmul_plain(a, w, plane))
        ws = torch.rand(n, generator=gen, device="cuda")
        bias = torch.randn(n, generator=gen, device="cuda")
        a_s = torch.tensor(0.1, device="cuda")
        got = bs_ops.bitserial_matmul(a, w, a_s, ws, bias, relu=True)
        planes = [bs_ops.bitplane_matmul_plain(a, w, p).float()
                  for p in range(8)]
        acc = torch.zeros_like(planes[0])
        for p, psum in enumerate(planes):
            acc = acc + (-(2.0 ** 7) if p == 7 else 2.0 ** p) * psum
        want = torch.clamp_min(acc * (a_s * ws) + bias, 0.0)
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [False, True])
def test_caat_mac_kernel_matches_plain_and_sim(hopper, relu, monkeypatch):
    """K5 through cim_macro_matmul: equal to its plain version (both sum
    in float64), and to the behavioural simulation with an ideal ADC
    within the code tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    cfg = macro.nominal_config(rows=128)
    chip = macro.sample_chip(gen, cfg)
    for b, k, n in ((40, 27, 128), (65, 300, 70), (3, 128, 10)):
        a, w = _i8(gen, (b, k)), _i8(gen, (k, n), -127)
        v_fs = torch.tensor(0.05 * 128 * 127 * 127, device="cuda")
        got = caat_ops.cim_macro_matmul(a, w, chip, v_fs, cfg, relu=relu)
        with monkeypatch.context() as mp:
            mp.setattr(caat_ops, "caat_mac_kernel", caat_ops.caat_mac_plain)
            want = caat_ops.cim_macro_matmul(a, w, chip, v_fs, cfg, relu=relu)
        assert torch.equal(got, want)
        sim, _ = macro.cim_matmul_sim(
            a, w, {"caat": chip["caat"], "adc": adc.ideal_adc(cfg.adc,
                                                              "cuda")},
            v_fs, cfg, relu=relu)
        d = (got - sim.to(torch.int32)).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("rows", [64, 128, 1152])
def test_caat_mac_kernel_equals_plain(hopper, rows, relu):
    """K5 alone on the packed operands of two row tiles (the second a
    strided view of the activations): codes equal to its plain version,
    both combining the 81 plane counts in float64 in one order, at every
    B in (1, 3, 65, 32768) and N in (10, 70, 128, 1024)."""
    gen = torch.Generator(device="cuda").manual_seed(rows)
    cfg = macro.nominal_config(rows=rows)
    chip = macro.sample_chip(gen, cfg)
    v_fs = torch.tensor(0.02 * rows * 127 * 127, device="cuda")
    for b in (1, 3, 65, 32768):
        for n in (10, 70, 128, 1024):
            a, w = _i8(gen, (b, 2 * rows)), _i8(gen, (2 * rows, n), -127)
            tiles, w_eff, scalars = caat_ops.tile_operands(a, w, chip, v_fs,
                                                           cfg)
            scalars = scalars.clone()
            scalars[3] = 1.0 if relu else 0.0
            for tile in tiles:
                got = caat_ops.caat_mac_kernel(*tile, w_eff, scalars)
                want = caat_ops.caat_mac_plain(*tile, w_eff, scalars)
                assert torch.equal(got, want), (rows, b, n, relu)


@pytest.mark.gpu
def test_caat_mac_kernel_rejects_ragged_rows(hopper):
    """Rows not a multiple of 16 are refused by the launcher, not run."""
    cfg = macro.nominal_config(rows=72)
    a = torch.zeros((8, 72), dtype=torch.int8, device="cuda")
    w = torch.zeros((72, 16), dtype=torch.int8, device="cuda")
    tiles, w_eff, scalars = caat_ops.tile_operands(
        a, w, macro.ideal_chip(cfg, "cuda"), 1e4, cfg)
    with pytest.raises(ValueError, match="multiple of 16"):
        caat_ops.caat_mac_kernel(*tiles[0], w_eff, scalars)


# ---------------------------------------------------------------------------
# Served streams: the kernels against their plain versions end to end
# ---------------------------------------------------------------------------

def _served_model():
    """A reduced qwen3-8b (2 layers, d_model 256, head_dim 64: the decode
    and prefill kernels take D in {32, ..., 256}) with an int8 KV cache,
    random weights from seed 0 frozen under w8a8_kernel on the card.  Its
    f32 reordering noise is far below its top-2 logit margins, so greedy
    streams must be identical; the plain path is held against the JAX
    package on the CPU (test_torch_serve*.py, test_torch_engine.py)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import backend
    from repro_torch.models import model as M
    cfg = dataclasses.replace(
        configs.reduced_config("qwen3-8b", n_layers=2, d_model=256),
        head_dim=64, kv_cache_dtype="int8")
    plan = backend.load_plan("w8a8_kernel")
    params = M.freeze_params(
        M.init(cfg, torch.Generator(device="cuda").manual_seed(0),
               device="cuda"), a_scale=0.05, plan=plan)
    return cfg, plan, params


def _plain_versions(monkeypatch):
    monkeypatch.setattr(cim_ops, "cim_matmul_kernel",
                        cim_ops.cim_matmul_plain)
    monkeypatch.setattr(tops, "paged_attention_kernel",
                        tops.paged_attention_plain)
    monkeypatch.setattr(tops, "merge_splits_kernel", tops.merge_splits)
    monkeypatch.setattr(tops, "flash_prefill_kernel",
                        tops.flash_prefill_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["chunked", "blocking", "generate"])
def test_served_streams_match_plain(hopper, path, monkeypatch):
    """Greedy streams served through the kernels equal those served
    through their plain versions: chunked and blocking ContinuousEngine
    (K1, K2, K3 / K1, K2) and Engine.generate (K1)."""
    import numpy as np

    from repro_torch.serve import ContinuousEngine, Engine, Request
    cfg, plan, params = _served_model()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in (37, 5, 60, 21,
                                                            44, 16)]

    def serve():
        if path == "generate":
            eng = Engine(params, cfg, max_len=96, plan=plan, device="cuda")
            batch = np.stack([p[:21] for p in prompts[::2]])
            return [eng.generate({"tokens": batch},
                                 max_new_tokens=12).tokens.cpu(),
                    eng.generate({"tokens": prompts[2][None]},
                                 max_new_tokens=12).tokens.cpu()]
        ce = ContinuousEngine(params, cfg, plan=plan, max_batch=4,
                              kv_blocks=64, block_size=16, segment_len=4,
                              paged_attn=True,
                              chunked_prefill=path == "chunked",
                              prefill_chunk=32, device="cuda")
        res = ce.run([Request(rid=i, prompt=p, max_new=12,
                              arrival_step=2 * i)
                      for i, p in enumerate(prompts)])
        return [torch.as_tensor(res[i].tokens) for i in range(len(prompts))]

    cim_ops.launches = tops.decode_launches = tops.prefill_launches = 0
    got = serve()
    assert cim_ops.launches > 0
    if path != "generate":
        assert tops.decode_launches > 0
    if path == "chunked":
        assert tops.prefill_launches > 0
    _plain_versions(monkeypatch)
    want = serve()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
