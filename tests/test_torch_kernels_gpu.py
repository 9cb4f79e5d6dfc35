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


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernel_matches_plain(hopper, int8):
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, kvh, g, d, bs, w = 4, 2, 4, 128, 16, 8
    nb = b * w + 1
    tables = (torch.randperm(nb - 1, generator=gen, device="cuda")[:b * w]
              + 1).reshape(b, w).to(torch.int32)
    n_valid = torch.tensor([0, 5, 100, 128], dtype=torch.int32,
                           device="cuda")
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda")
    shape = (nb, bs, kvh, d)
    if int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=gen,
                                device="cuda", dtype=torch.int32).to(
                                    torch.int8) for _ in range(2))
        ks, vs = ((torch.rand(shape[:3], generator=gen, device="cuda")
                   * 0.05).to(torch.bfloat16) for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, generator=gen, device="cuda")
                  for _ in range(2))
        ks = vs = None
    for splits in (1, 3):
        args = (q, kp, vp, ks, vs, tables, n_valid)
        got = tops.merge_splits(*tops.paged_attention_kernel(
            *args, kv_splits=splits))
        want = tops.merge_splits(*tops.paged_attention_plain(
            *args, kv_splits=splits))
        assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_prefill_kernel_matches_plain(hopper, int8):
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, kvh, g, d, bs, c, w = 3, 2, 4, 128, 16, 64, 12
    nb = b * w + 1
    tables = (torch.randperm(nb - 1, generator=gen, device="cuda")[:b * w]
              + 1).reshape(b, w).to(torch.int32)
    pos = torch.tensor([0, 64, 128], dtype=torch.int32, device="cuda")
    n_tok = torch.tensor([64, 20, 64], dtype=torch.int32, device="cuda")
    wm = torch.tensor([1, 1, 0], dtype=torch.int32, device="cuda")
    q = torch.randn(b, kvh, c * g, d, generator=gen, device="cuda")
    k_new = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
    v_new = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
    shape = (nb, bs, kvh, d)
    if int8:
        pool = [torch.randint(-127, 128, shape, generator=gen,
                              device="cuda", dtype=torch.int32).to(
                                  torch.int8) for _ in range(2)]
        pool += [(torch.rand(shape[:3], generator=gen, device="cuda")
                  * 0.05).to(torch.bfloat16) for _ in range(2)]
    else:
        pool = [torch.randn(shape, generator=gen, device="cuda")
                for _ in range(2)] + [None, None]
    p1 = [t.clone() if t is not None else None for t in pool]
    p2 = [t.clone() if t is not None else None for t in pool]
    got = tops.flash_prefill_kernel(q, k_new, v_new, *p1, tables, pos, n_tok,
                                    wm)
    want = tops.flash_prefill_plain(q, k_new, v_new, *p2, tables, pos,
                                    n_tok, wm)
    assert (got - want).abs().max().item() <= 1e-3
    for a, b_ in zip(p1, p2):
        if a is not None:
            assert torch.equal(a[1:], b_[1:])


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
