"""Chip smoke test of the PyTorch + CUDA port on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. env      -- torch / CUDA / card, and the card's name and power limit.
2. build    -- compiles the five CUDA kernels from src/repro_torch/csrc,
               one nvcc per source, all started together.
3. kernels  -- holds each kernel against its plain PyTorch version on the
               card at its path's shapes (K1 at every serving (K, N) and
               M in K1_CASE_MS, and at VGG-8's ragged K = 27 and N = 10;
               K2 at one split and at the card's split count, then the
               decode merge; K4 at all 8 VGG-8 layer shapes and planes;
               K5 at conv2/conv6/fc1 with a sampled chip, codes equal to
               its plain version and within one code of the simulation)
               and times
               kernel, plain version, one PyTorch library call (the
               yardstick) and the bound (bytes / 3.35 TB/s or operations /
               the peak rate for the operand type, the larger).  K1 is
               timed at every serving (K, N) at M = 8 and 512 and K4 at
               every VGG-8 shape, each beside the byte-masked mma.sync
               kernel (the masked path, the previous design; in turns);
               K5 at every VGG-8 shape beside two library yardsticks
               (f32 torch.bmm, torch._int_mm) and the whole
               cim_macro_matmul call.
4. main     -- serves 8 requests through the port's ContinuousEngine at
               qwen3-8b's widths (w8a8_kernel plan, paged attention,
               chunked prefill, int8 KV pool, random weights from a seed),
               checks every request is OK and every kernel launched,
               serves them once more with CUDA events around each kernel
               wrapper and the decode merge (device time by kernel, K1's
               split into decode and prefill calls, its own line), and
               replays the requests through the plain versions.
5. static   -- the static engine (Engine.generate over dense KV caches)
               on the same model and prompts, one call per prompt:
               greedy with the kernels (K1 must launch on every linear),
               greedy with the plain versions (prefill logits gated as in
               main), twice sampled with one key (identical streams); the
               sampler's random bits on the card equal the CPU's and its
               gumbel is within 2 ulp; decode-step and sampler times.
6. blocking -- the serving path with blocking prefill (the engine's
               default), paged attention, sampled at temperature 0.8:
               every request OK, K1 and K2 launched.
7. vgg8     -- the paper's VGG-8 deployment path (repro_torch.launch.fig10)
               at its published widths with random weights from a seed:
               w8a8_kernel (with and without residency) and
               bitserial_kernel logits bit-identical to their plain plans,
               the cim plan with 8 sampled chips, calibrated full scales
               and per-channel fine-tunes, and the CAAT macro op on every
               cim layer's int8 inputs against the behavioural simulation.
8. the ``{"kernels": [...]}`` line, the nvidia-smi line, and last the
   ``{"ok": true, "device": ...}`` line.

``--skip-main`` stops after the kernel phase (a quick kernel check).
``--k5-only --src DIR`` only times the whole CAAT macro op at every VGG-8
shape, with the ``repro_torch`` package of another tree (a parent commit
unpacked beside this one).  Long output goes to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
PEAK_INT8_OPS = 1979e12            # H100 SXM dense int8 tensor-core rate
PEAK_BF16_OPS = 989e12             # H100 SXM dense bf16 tensor-core rate
PEAK_TF32_OPS = 495e12             # H100 SXM dense TF32 tensor-core rate
PEAK_F32_OPS = 67e12               # H100 SXM f32 rate on the CUDA cores
K1_SHAPES = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096),
             (4096, 152064))       # (K, N) of q/o, k/v, gate/up, down, head
# (M, K, N) of VGG-8's eight layers at batch 32 (conv1 ... conv6, fc1,
# head): M is batch x pixels for a conv, K = 9 x C_in.
VGG8_SHAPES = ((32768, 27, 128), (32768, 1152, 128), (8192, 1152, 256),
               (8192, 2304, 256), (2048, 2304, 512), (2048, 4608, 512),
               (32, 8192, 1024), (32, 1024, 10))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def swapped(module, name: str, replacement):
    """Temporarily route ``module.name`` to ``replacement`` (a kernel
    wrapper to its plain twin; those calls are not counted as
    launches)."""
    saved = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def event_timed(torch, targets, tag=lambda: None):
    """Wrap each ``(module, name)`` function so that every call is
    bracketed by CUDA events on the current stream; yields ``{name: [(start,
    end, tag()), ...]}`` (read the times after a synchronize)."""
    events = {name: [] for _, name in targets}
    with contextlib.ExitStack() as stack:
        for module, name in targets:
            def timed(*a, _fn=getattr(module, name), _ev=events[name], **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*a, **k)
                end.record()
                _ev.append((start, end, tag()))
                return out
            stack.enter_context(swapped(module, name, timed))
        yield events


# Device kernels of the port by name, for the profiler's sums.
KERNEL_NAMES = (("cim_matmul", "cim_wgmma_kernel"),
                ("cim_matmul", "cim_matmul_kernel"),
                ("cim_quant_pass", "cim_quant_kernel"),
                ("paged_attention", "paged_decode_kernel"),
                ("merge_splits", "merge_splits_kernel"),
                ("flash_prefill", "prefill_"))


def device_time_by_kernel(prof, wall_s: float) -> dict:
    """Sum the profiler's device time by the port's kernels and the rest
    (PyTorch's own kernels, copies, fills); the busy share is all device
    time over the wall.  K1's wgmma kernel is also split by its token
    tile: decode tiles (8 or 16 tokens) and prefill tiles (64 or 128).
    Empty when the trace holds no device time."""
    sums: dict = {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if not us:
            continue
        name = next((k for k, pat in KERNEL_NAMES if pat in ev.key),
                    "other")
        entry = sums.setdefault(name, {"ms": 0.0, "calls": 0})
        entry["ms"] += us / 1e3
        entry["calls"] += ev.count
        tile = re.search(r"cim_wgmma_kernel<\d+, (\d+)", ev.key)
        if tile:
            kind = ("decode_tiles" if int(tile.group(1)) <= 16
                    else "prefill_tiles")
            sub = entry.setdefault("by_tile", {}).setdefault(
                kind, {"ms": 0.0, "calls": 0})
            sub["ms"] += us / 1e3
            sub["calls"] += ev.count
    busy = sum(e["ms"] for e in sums.values())
    for e in sums.values():
        e["share_of_wall"] = e["ms"] / (wall_s * 1e3)
    return {"by_kernel": sums, "device_busy_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3)} if sums else {}


def rand_i8(torch, shape, gen, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.int8)


def attention_peak(torch, dtype) -> float:
    """Peak rate for attention products on ``dtype`` operands.  The TPU
    kernels do them on the MXU, so the card's matching rate is its
    tensor-core rate for that type (bf16, or TF32 for f32)."""
    return PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_TF32_OPS


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before each
    launch (the main path reads each layer's weights and pages cold).  A
    device-side sleep after the flush keeps the card busy while the host
    enqueues the call, so the events time the device's work, not the
    wrapper's Python overhead on an idle card."""

    HIDE_CYCLES = 1_000_000     # ~0.5 ms of device sleep

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 * 2**20, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.HIDE_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


# ---------------------------------------------------------------------------
# Kernel phases
# ---------------------------------------------------------------------------

# M values of the bit-exact K1 cases: decode sizes, bucket edges, odd
# counts and the prefill sizes of the serving path.
K1_CASE_MS = (1, 3, 7, 8, 9, 16, 17, 509, 512)


def parent_k1(torch, ops, a, w, a_scale, w_scale, bias, out_scale, *,
              relu=False, requant=False):
    """The byte-masked mma.sync kernel (``cim_matmul_launch``, the masked
    path, K1's previous design, its code unchanged) on the same inputs:
    the parent's K1 timed in this run at shapes that now take the wgmma
    path."""
    from repro_torch.kernels import build
    m, k = a.shape
    n = w.shape[1]
    out = torch.empty((m, n), device="cuda",
                      dtype=torch.int8 if requant else torch.float32)
    rc = ops._fn()(a.data_ptr(), int(a.dtype == torch.float32),
                   w.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
                   bias.data_ptr(), out_scale.data_ptr(), out.data_ptr(), m,
                   n, k, int(relu), int(requant),
                   torch.cuda.current_stream().cuda_stream)
    build.check(rc, "cim_matmul (masked kernel)")
    return out


def parent_k4(torch, ops, a, w, plane):
    """The byte-masked bit-plane kernel (``bitplane_matmul_launch``, K4's
    previous design, unchanged) on the same inputs."""
    from repro_torch.kernels import build
    (m, k), n = a.shape, w.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device="cuda")
    rc = ops._fn()(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                   plane, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "bitplane_matmul (masked kernel)")
    return out


def in_turns(timer, new, parent):
    """new, parent, parent, new: each kernel's mean of its two turns."""
    t = [timer.ms(new), timer.ms(parent), timer.ms(parent), timer.ms(new)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def check_k1(torch, timer, ops, gen):
    """cim_matmul against its plain version: bit-exact at every (K, N) of
    the model, every M of K1_CASE_MS, f32 and int8 input, requant on and
    off, and at VGG-8's ragged shapes; then timed at every (K, N) at
    decode M = 8 and prefill M = 512 beside the masked kernel (in turns) and
    the ``torch._int_mm`` + epilogue yardstick."""
    from repro_torch.device import sm_count
    from repro_torch.kernels import autotune
    dev = "cuda"
    n_cases = 0
    for k, n in K1_SHAPES:
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
        w_scale = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        bias = torch.randn(n, generator=gen, device=dev) * 0.1
        a_scale = torch.tensor(0.05, device=dev)
        out_scale = torch.tensor(0.5, device=dev)
        for m in K1_CASE_MS:
            a32 = torch.randn(m, k, generator=gen, device=dev) * 2.0
            a8 = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
            for a in (a32, a8):
                for requant in (False, True):
                    args = (a, w, a_scale, w_scale, bias, out_scale)
                    got = ops.cim_matmul_kernel(*args, requant=requant)
                    want = ops.cim_matmul_plain(*args, requant=requant)
                    if not torch.equal(got, want):
                        bad = (got != want).sum().item()
                        raise AssertionError(
                            f"K1 not bit-exact at M={m} K={k} N={n} "
                            f"a={a.dtype} requant={requant}: {bad} of "
                            f"{got.numel()} outputs differ")
                    n_cases += 1
    # VGG-8's ragged shapes (conv1 K = 27, head N = 10), with the VGG
    # epilogue (bias + ReLU).
    for m, k, n in ((32768, 27, 128), (32, 1024, 10)):
        w = rand_i8(torch, (k, n), gen, -127)
        w_scale = torch.rand(n, generator=gen, device=dev) * 1e-2 + 1e-4
        bias = torch.randn(n, generator=gen, device=dev) * 0.1
        a_scale = torch.tensor(0.02, device=dev)
        out_scale = torch.tensor(0.05, device=dev)
        a32 = torch.rand(m, k, generator=gen, device=dev) * 2.0 - 0.5
        for a in (a32, rand_i8(torch, (m, k), gen)):
            for relu, requant in ((True, False), (True, True),
                                  (False, False)):
                args = (a, w, a_scale, w_scale, bias, out_scale)
                got = ops.cim_matmul_kernel(*args, relu=relu,
                                            requant=requant)
                want = ops.cim_matmul_plain(*args, relu=relu,
                                            requant=requant)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"K1 not bit-exact at ragged M={m} K={k} N={n} "
                        f"a={a.dtype} relu={relu} requant={requant}")
                n_cases += 1
    # Timing at every serving (K, N), decode and prefill, f32 input (what
    # the serving path passes).
    a_scale = torch.tensor(0.05, device=dev)
    one = torch.tensor(1.0, device=dev)
    rows = []
    for k, n in K1_SHAPES:
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
        w_scale = torch.rand(n, generator=gen, device=dev) * 1e-3
        bias = torch.zeros(n, device=dev)
        for m in (8, 512):
            a = torch.randn(m, k, generator=gen, device=dev)
            args = (a, w, a_scale, w_scale, bias, one)
            ms, parent_ms, turns = in_turns(
                timer, lambda: ops.cim_matmul_kernel(*args),
                lambda: parent_k1(torch, ops, *args))
            plain_ms = timer.ms(lambda: ops.cim_matmul_plain(*args),
                                iters=3)
            # Yardstick: torch._int_mm on the pre-quantized A (it needs
            # M > 16, so decode's A is padded to 32 rows) + the epilogue.
            a_pad = torch.zeros(max(m, 32), k, dtype=torch.int8, device=dev)
            a_pad[:m] = torch.clamp(torch.round(a / a_scale), -128,
                                    127).to(torch.int8)

            def library():
                acc = torch._int_mm(a_pad, w)
                return acc[:m].to(torch.float32) * (a_scale * w_scale) + bias

            library_ms = timer.ms(library)
            n_bytes = m * k * 4 + k * n + 2 * n * 4 + m * n * 4
            b_ms, b_by = bound_ms(n_bytes, 2.0 * m * k * n, PEAK_INT8_OPS)
            rows.append({"M": m, "K": k, "N": n,
                         "config": autotune.cim_matmul_config(
                             m, n, k, sm_count(dev))._asdict(),
                         "ms": ms, "parent_ms": parent_ms,
                         "turns_ms": turns, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": b_ms,
                         "bound_by": b_by})
    main = next(r for r in rows if (r["M"], r["K"], r["N"]) == (8, 4096,
                                                                 12288))
    return {"name": "cim_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/cim_matmul.cu",
            "replaces": "src/repro/kernels/cim_matmul/kernel.py:121",
            "max_abs_err": 0.0, "cases": n_cases,
            "case_ms": list(K1_CASE_MS),
            "ragged_cases": "M=32768 K=27 N=128, M=32 K=1024 N=10",
            "shape": "M=8 K=4096 N=12288 f32 in",
            "ms": main["ms"], "parent_ms": main["parent_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": "torch._int_mm on the pre-quantized A (M padded to "
                       "32 at decode) + epilogue",
            "parent": "the masked kernel (cim_matmul_launch), K1's "
                      "previous design, same inputs, in turns",
            "shapes": rows}


def _pool(torch, gen, nb, bs, kvh, d, int8):
    shape = (nb, bs, kvh, d)
    if int8:
        codes = [torch.randint(-127, 128, shape, generator=gen,
                               device="cuda", dtype=torch.int32).to(
                                   torch.int8) for _ in range(2)]
        scales = [(torch.rand(shape[:3], generator=gen, device="cuda")
                   * 0.02 + 0.005).to(torch.bfloat16) for _ in range(2)]
        return codes, scales
    pages = [torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2)]
    return pages, [None, None]


def _dense_kv(torch, pages, scale, tables, n_tokens):
    """[B, W*BS, KVH, D] f32 view of each row's pages (for SDPA)."""
    g = pages[tables.long()].to(torch.float32)
    if scale is not None:
        g = g * scale[tables.long()].to(torch.float32)[..., None]
    b, w, bs = g.shape[:3]
    return g.reshape(b, w * bs, *g.shape[3:])[:, :n_tokens]


def check_k2(torch, timer, ops, gen):
    """paged_attention against its plain version, bf16 and int8 pools,
    B=8 ragged lengths up to 2048 with one empty row, at kv_splits=1 (the
    count the decode kernel was first timed at) and at the card's split
    count (what the main path runs)."""
    from repro_torch.kernels import autotune
    b, kvh, g, d, bs = 8, 8, 4, 128, 16
    lengths = torch.tensor([2048, 1, 777, 0, 1500, 64, 1999, 300],
                           dtype=torch.int32, device="cuda")
    w = 2048 // bs
    card_splits = autotune.heuristic_paged_splits_cuda(
        b, kvh, w, ops.sm_count("cuda"))
    nb = b * w + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * w].reshape(b, w).to(torch.int32).contiguous()
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    entry = None
    err = 0.0
    for int8 in (False, True):
        (kp, vp), (ks, vs) = _pool(torch, gen, nb, bs, kvh, d, int8)
        args = (q, kp, vp, ks, vs, tables, lengths)
        for splits in (1, card_splits):
            got = ops.merge_splits(*ops.paged_attention_kernel(
                *args, kv_splits=splits))
            want = ops.merge_splits(*ops.paged_attention_plain(
                *args, kv_splits=splits))
            e = (got - want).abs().max().item()
            # f32 sums in another order than the plain version's einsum.
            if not e <= 1e-3:
                raise AssertionError(f"K2 int8={int8} splits={splits}: max "
                                     f"abs err {e} > 1e-3")
            if got[3].abs().max().item() != 0.0:
                raise AssertionError("K2: the n_valid=0 row is not zeros")
            err = max(err, e)
        if int8:
            ms = {s_: timer.ms(lambda: ops.paged_attention_kernel(
                *args, kv_splits=s_)) for s_ in (1, card_splits)}
            plain_ms = timer.ms(lambda: ops.paged_attention_plain(
                *args, kv_splits=card_splits), iters=5)
            # Yardstick: SDPA over the gathered, dequantized live pages.
            kd = _dense_kv(torch, kp, ks, tables, 2048)
            vd = _dense_kv(torch, vp, vs, tables, 2048)
            kd = kd.permute(0, 2, 1, 3).repeat_interleave(g, 1)
            vd = vd.permute(0, 2, 1, 3).repeat_interleave(g, 1)
            qd = q.reshape(b, kvh * g, 1, d).to(torch.float32)
            mask = (torch.arange(2048, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            library_ms = timer.ms(lambda: sdpa(qd, kd, vd, attn_mask=mask))
            tokens = int(lengths.sum())
            n_bytes = (tokens * kvh * (2 * d + 2 * 2) + q.numel() * 2
                       + b * kvh * g * (d + 2) * 4 + tables.numel() * 4)
            n_ops = 4.0 * tokens * kvh * g * d
            b_ms, b_by = bound_ms(n_bytes, n_ops,
                                  attention_peak(torch, q.dtype))
            entry = {"name": "paged_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/paged_attention.cu",
                     "replaces":
                         "src/repro/kernels/paged_attention/kernel.py:217",
                     "shape": f"B={b} KVH={kvh} G={g} D={d} BS={bs} "
                              f"int8 pool, {tokens} live tokens",
                     "kv_splits": card_splits,
                     "ms": ms[card_splits], "ms_splits1": ms[1],
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms,
                     "library": "scaled_dot_product_attention over the "
                                "gathered dequantized pages"}
    entry["max_abs_err"] = err
    return entry


def check_merge(torch, timer, ops, gen):
    """merge_splits_kernel against merge_splits on the partials of the K2
    timing shape at the card's split count, a dead split and an empty row
    included."""
    from repro_torch.kernels import autotune
    b, kvh, g, d = 8, 8, 4, 128
    ns = autotune.heuristic_paged_splits_cuda(b, kvh, 2048 // 16,
                                              ops.sm_count("cuda"))
    acc = torch.randn(b, kvh, ns, g, d, generator=gen, device="cuda")
    m = torch.randn(b, kvh, ns, g, 1, generator=gen, device="cuda") * 4
    l = torch.rand(b, kvh, ns, g, 1, generator=gen, device="cuda") + 0.5
    for t, v in ((acc, 0.0), (m, ops.NEG_INF), (l, 0.0)):
        t[0, 0, 1] = v          # a dead split
        t[3] = v                # a row with no live position
    got = ops.merge_splits_kernel(acc, m, l)
    want = ops.merge_splits(acc, m, l)
    err = (got - want).abs().max().item()
    # expf against torch.exp and another summation order over the splits.
    if not err <= 1e-5:
        raise AssertionError(f"merge: max abs err {err} > 1e-5")
    if got[3].abs().max().item() != 0.0:
        raise AssertionError("merge: the empty row is not zeros")
    ms = timer.ms(lambda: ops.merge_splits_kernel(acc, m, l))
    plain_ms = timer.ms(lambda: ops.merge_splits(acc, m, l))
    n_bytes = (acc.numel() + m.numel() + l.numel() + b * kvh * g * d) * 4
    b_ms, b_by = bound_ms(n_bytes, 3.0 * acc.numel(), PEAK_F32_OPS)
    return {"name": "merge_splits", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/ops.py:44 "
                        "(merge_splits, the jnp combine of the Pallas "
                        "decode kernel's partials)",
            "max_abs_err": err,
            "shape": f"B={b} KVH={kvh} S={ns} G={g} D={d}",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "library": "none: no single PyTorch call combines the splits"}


def check_k3(torch, timer, ops, gen):
    """flash_prefill against its plain version at C=64: outputs within
    1e-3, written pages bit-exact, the masked row's pages untouched."""
    b, kvh, g, d, bs, c = 4, 8, 4, 128, 16, 64
    pos = torch.tensor([0, 64, 1024, 64], dtype=torch.int32, device="cuda")
    n_tok = torch.tensor([64, 37, 64, 64], dtype=torch.int32, device="cuda")
    wm = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device="cuda")
    w = (1024 + c) // bs
    nb = b * w + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * w].reshape(b, w).to(torch.int32).contiguous()
    q32 = torch.randn(b, kvh, c * g, d, generator=gen, device="cuda")
    k32 = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
    v32 = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
    masked_blocks = tables[3, 64 // bs:(64 + c) // bs].long()
    err = err_bf16 = tol_used = 0.0
    entry = None
    for dtype, int8 in ((torch.float32, False), (torch.float32, True),
                        (torch.bfloat16, False), (torch.bfloat16, True)):
        q, k_new, v_new = (t.to(dtype) for t in (q32, k32, v32))
        (kp, vp), (ks, vs) = _pool(torch, gen, nb, bs, kvh, d, int8)
        pools = []
        for _ in range(2):
            pools.append([t.clone() if t is not None else None
                          for t in (kp, vp, ks, vs)])
        (k1, v1, ks1, vs1), (k2, v2, ks2, vs2) = pools
        got = ops.flash_prefill_kernel(q, k_new, v_new, k1, v1, ks1, vs1,
                                       tables, pos, n_tok, wm).float()
        want = ops.flash_prefill_plain(q, k_new, v_new, k2, v2, ks2, vs2,
                                       tables, pos, n_tok, wm).float()
        # f32 sums in another order than the plain version's einsum: 1e-3;
        # a bf16 output may also round to the neighbouring bf16 value, so
        # there one bf16 ulp (2**-7 relative) is allowed on top.
        tol = 1e-3 + (2.0 ** -7 * want.abs() if dtype == torch.bfloat16
                      else 0.0)
        diff = (got - want).abs()
        if not bool((diff <= tol).all()):
            raise AssertionError(
                f"K3 {dtype} int8={int8}: max abs err {diff.max().item()}")
        if dtype == torch.float32:      # the CUDA-core instantiation
            err = max(err, diff.max().item())
        else:                           # the tensor-core instantiation
            err_bf16 = max(err_bf16, diff.max().item())
            tol_used = max(tol_used, (diff / tol).max().item())
        for a_, b_, orig in ((k1, k2, kp), (v1, v2, vp), (ks1, ks2, ks),
                             (vs1, vs2, vs)):
            if a_ is None:
                continue
            if not torch.equal(a_[1:], b_[1:]):
                raise AssertionError(f"K3 int8={int8}: pages differ")
            if not torch.equal(a_[masked_blocks], orig[masked_blocks]):
                raise AssertionError("K3: a masked row's pages changed")
        if int8 and dtype == torch.bfloat16:
            args = (q, k_new, v_new, k1, v1, ks1, vs1, tables, pos, n_tok,
                    wm)
            ms = timer.ms(lambda: ops.flash_prefill_kernel(*args))
            plain_ms = timer.ms(lambda: ops.flash_prefill_plain(*args),
                                iters=5)
            # Yardstick: SDPA of each row over its gathered past + chunk.
            sdpa = torch.nn.functional.scaled_dot_product_attention
            calls = []
            for r in range(b):
                p0 = int(pos[r])
                past_k = _dense_kv(torch, k1, ks1, tables[r:r + 1], p0)
                past_v = _dense_kv(torch, v1, vs1, tables[r:r + 1], p0)
                kk = torch.cat([past_k, k_new[r:r + 1].float()], 1)
                vv = torch.cat([past_v, v_new[r:r + 1].float()], 1)
                kk = kk.permute(0, 2, 1, 3).repeat_interleave(g, 1)
                vv = vv.permute(0, 2, 1, 3).repeat_interleave(g, 1)
                qq = q[r].reshape(kvh, c, g, d).permute(0, 2, 1, 3).reshape(
                    1, kvh * g, c, d).float()
                mask = (torch.arange(p0 + c, device="cuda")[None, :]
                        <= p0 + torch.arange(c, device="cuda")[:, None])
                calls.append((qq, kk, vv, mask))
            library_ms = timer.ms(
                lambda: [sdpa(qq, kk, vv, attn_mask=mk)
                         for qq, kk, vv, mk in calls])
            n_ops = 0.0
            n_bytes = (q.numel() * 2 * 2 + k_new.numel() * 2 * 2
                       + tables.numel() * 4)
            for r in range(b):
                p0, nt = int(pos[r]), int(n_tok[r])
                keys = sum(p0 + min(ci + 1, nt) for ci in range(c))
                n_ops += 4.0 * keys * kvh * g * d
                n_bytes += p0 * kvh * (2 * d + 4)
                if int(wm[r]):
                    n_bytes += -(-nt // bs) * bs * kvh * (2 * d + 4)
            b_ms, b_by = bound_ms(n_bytes, n_ops,
                                  attention_peak(torch, q.dtype))
            entry = {"name": "flash_prefill", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_prefill.cu",
                     "replaces":
                         "src/repro/kernels/paged_attention/kernel.py:480",
                     "shape": f"B={b} C={c} KVH={kvh} G={g} D={d} BS={bs} "
                              "pos=[0,64,1024,64] int8 pool",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms,
                     "library": "scaled_dot_product_attention per row over "
                                "the gathered past pages + chunk"}
    entry["max_abs_err"] = err
    entry["max_abs_err_bf16"] = err_bf16
    entry["bf16_tolerance_used"] = tol_used
    return entry


def check_k4(torch, timer, ops, gen):
    """bitplane_matmul against its plain version at all 8 VGG-8 layer
    shapes and every plane, bit-exact; bitserial_matmul through the kernel
    against the same shift-add over the plain planes, bit for bit; then
    one plane timed at every shape beside the masked kernel (in turns) and
    ``torch._int_mm``."""
    from repro_torch.device import sm_count
    from repro_torch.kernels import autotune
    n_cases = 0
    for m, k, n in VGG8_SHAPES:
        a = rand_i8(torch, (m, k), gen)
        w = rand_i8(torch, (k, n), gen, -127)
        for plane in range(8):
            got = ops.bitplane_matmul_kernel(a, w, plane)
            want = ops.bitplane_matmul_plain(a, w, plane)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K4 not bit-exact at M={m} K={k} N={n} plane={plane}: "
                    f"{(got != want).sum().item()} outputs differ")
            n_cases += 1
        w_scale = torch.rand(n, generator=gen, device="cuda") * 1e-2
        bias = torch.randn(n, generator=gen, device="cuda")
        a_scale = torch.tensor(0.02, device="cuda")
        got = ops.bitserial_matmul(a, w, a_scale, w_scale, bias, relu=True)
        with swapped(ops, "bitplane_matmul_kernel",
                     ops.bitplane_matmul_plain):
            want = ops.bitserial_matmul(a, w, a_scale, w_scale, bias,
                                        relu=True)
        if not torch.equal(got, want):
            raise AssertionError(f"K4 bitserial_matmul differs from its "
                                 f"plain twin at M={m} K={k} N={n}")
    # Timing at every layer shape, one plane (the sign plane).
    rows = []
    for m, k, n in VGG8_SHAPES:
        a = rand_i8(torch, (m, k), gen)
        w = rand_i8(torch, (k, n), gen, -127)
        ms, parent_ms, turns = in_turns(
            timer, lambda: ops.bitplane_matmul_kernel(a, w, 7),
            lambda: parent_k4(torch, ops, a, w, 7))
        plain_ms = timer.ms(lambda: ops.bitplane_matmul_plain(a, w, 7),
                            iters=3)
        # Yardstick: torch._int_mm on the plane, extracted beforehand.  It
        # needs M > 16 and K, N multiples of 8: conv1 (K = 27) and the
        # head (N = 10) have no such call.
        library_ms = None
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            bits = ((a.view(torch.uint8) >> 7) & 1).view(torch.int8)
            library_ms = timer.ms(lambda: torch._int_mm(bits, w))
        b_ms, b_by = bound_ms(m * k + k * n + m * n * 4, 2.0 * m * k * n,
                              PEAK_INT8_OPS)
        rows.append({"M": m, "K": k, "N": n,
                     "config": autotune.cim_matmul_config(
                         m, n, k, sm_count("cuda"))._asdict(),
                     "ms": ms, "parent_ms": parent_ms, "turns_ms": turns,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
    main = rows[1]
    return {"name": "bitplane_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/bitplane_matmul.cu",
            "replaces": "src/repro/kernels/bitserial_matmul/kernel.py:62",
            "max_abs_err": 0.0, "cases": n_cases,
            "shape": "M=32768 K=1152 N=128 (conv2), one plane",
            "ms": main["ms"], "parent_ms": main["parent_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": "torch._int_mm on the pre-extracted plane",
            "parent": "the masked kernel (bitplane_matmul_launch), K4's "
                      "previous design, same inputs, in turns",
            "shapes": rows}


def code_diff(torch, got, want, what: str) -> dict:
    """The K5 tolerance against the simulation: its float64 tree combine
    runs in another order than the op's W_eff sum and converts in another
    order in f32, so a code may move by one where v * 128 lands within an
    ulp of a .5 boundary -- on at most 1e-3 of the outputs, and never by
    more than one."""
    d = (got.to(torch.int64) - want.to(torch.int64)).abs()
    worst = int(d.max()) if d.numel() else 0
    n_off = int((d > 0).sum())
    share = n_off / max(d.numel(), 1)
    if worst > 1 or share > 1e-3:
        raise AssertionError(f"{what}: max |code diff| {worst}, "
                             f"{n_off} of {d.numel()} codes differ")
    return {"max_abs": worst, "codes_off_by_one": n_off,
            "codes": d.numel()}


def k5_chip(torch, gen):
    """The K5 checks' macro (1152 rows, nominal mismatch), one sampled chip,
    and a full scale ~2.7 std of a random tile MAC (codes span the
    range)."""
    from repro_torch.core import macro
    cfg = macro.nominal_config(rows=1152)
    chip = macro.sample_chip(gen, cfg)
    v_fs = torch.tensor(0.02 * cfg.rows * 127.0 * 127.0, device="cuda")
    return cfg, chip, v_fs


def k5_whole_op_ms(torch, timer, ops, gen) -> list:
    """cim_macro_matmul, wrapper included, at every VGG-8 shape (ReLU on):
    its time, and the device memory one call adds at its peak over what
    was allocated before it.  Uses only the op's public signature, so
    ``--src`` can measure another tree's op (the parent's) with this
    script."""
    cfg, chip, v_fs = k5_chip(torch, gen)
    rows = []
    for m, k, n in VGG8_SHAPES:
        a = rand_i8(torch, (m, k), gen)
        w = rand_i8(torch, (k, n), gen, -127)

        def op():
            return ops.cim_macro_matmul(a, w, chip, v_fs, cfg, relu=True)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        op()
        torch.cuda.synchronize()
        rows.append({"M": m, "K": k, "N": n,
                     "whole_op_peak_gb":
                         (torch.cuda.max_memory_allocated() - base) / 1e9,
                     "whole_op_ms": timer.ms(op, iters=5)})
    return rows


def check_k5(torch, timer, ops, gen):
    """caat_mac against its plain version through cim_macro_matmul at the
    conv2 (1 tile), conv6 (4 tiles) and fc1 (8 tiles) shapes with a
    sampled chip, ReLU on and off: codes equal; and, with an ideal ADC,
    against the behavioural macro simulation (core.macro.cim_matmul_sim)
    within the code tolerance.  Then timed at every VGG-8 shape, one launch
    per row tile on operands made once, beside the plain version, two
    library yardsticks (f32 ``torch.bmm`` over 9 folded planes, and
    ``torch._int_mm`` over the stacked +/-1 planes + the float64 combine,
    both on planes made outside the timing), the bound, and the whole
    cim_macro_matmul call."""
    from repro_torch.core import adc, macro, numerics
    cfg, chip, v_fs = k5_chip(torch, gen)
    sim_chip = {"caat": chip["caat"], "adc": adc.ideal_adc(cfg.adc, "cuda")}
    checks = []
    for m, k, n in (VGG8_SHAPES[1], VGG8_SHAPES[5], VGG8_SHAPES[6]):
        a = rand_i8(torch, (m, k), gen)
        w = rand_i8(torch, (k, n), gen, -127)
        for relu in (True, False):
            got = ops.cim_macro_matmul(a, w, chip, v_fs, cfg, relu=relu)
            with swapped(ops, "caat_mac_kernel", ops.caat_mac_plain):
                want = ops.cim_macro_matmul(a, w, chip, v_fs, cfg,
                                            relu=relu)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K5 not equal to its plain version at M={m} K={k} "
                    f"N={n} relu={relu}: {int((got != want).sum())} of "
                    f"{got.numel()} codes differ")
            sim, _ = macro.cim_matmul_sim(a, w, sim_chip, v_fs, cfg,
                                          relu=relu)
            checks.append({
                "shape": [m, k, n], "relu": relu, "vs_plain": "equal",
                "vs_sim": code_diff(torch, got, sim.to(torch.int32),
                                    f"K5 vs sim M={m} relu={relu}")})
    whole = k5_whole_op_ms(torch, timer, ops, gen)
    f64 = torch.float64
    rows = []
    for (m, k, n), whole_row in zip(VGG8_SHAPES, whole):
        a = rand_i8(torch, (m, k), gen)
        w = rand_i8(torch, (k, n), gen, -127)
        tiles, w_eff, scalars = ops.tile_operands(a, w, chip, v_fs, cfg,
                                                  relu=True)
        r = cfg.rows
        kp = r * len(tiles)

        def run(fn):
            for tile in tiles:
                fn(*tile, w_eff, scalars)

        ms = timer.ms(lambda: run(ops.caat_mac_kernel))
        plain_ms = timer.ms(lambda: run(ops.caat_mac_plain), iters=3)
        # Library yardsticks on planes made here, outside the timing.
        a_p = torch.nn.functional.pad(a, (0, kp - k))
        w_p = torch.nn.functional.pad(w, (0, 0, 0, kp - k))
        w_pm = numerics.encode_pm1(w_p)                      # [K', N, 9]
        a_pm = numerics.encode_pm1(a_p)                      # [B, K', 9]
        a_fold = torch.einsum("bri,ij->jbr", a_pm.to(f64), w_eff).to(
            torch.float32)
        del a_pm
        w_f32 = w_pm.permute(2, 0, 1).to(torch.float32).contiguous()

        def epilogue(acc):
            v = (acc * scalars[0] + scalars[1]) * scalars[2]
            code = torch.clamp(torch.round(v * 128.0), -128, 127)
            return code.to(torch.int32)

        def bmm_library():
            out = 0
            for t in range(len(tiles)):
                sl = slice(t * r, (t + 1) * r)
                out = out + epilogue(torch.bmm(a_fold[:, :, sl],
                                               w_f32[:, sl]).sum(0))
            return torch.clamp_min(out, 0)

        bmm_ms = timer.ms(bmm_library)
        del a_fold, w_f32
        stacked = [(ops.pm1_planes(a_t).reshape(8 * m, r),
                    w_pm[t * r:(t + 1) * r, :, :8].permute(0, 2, 1)
                    .reshape(r, 8 * n).contiguous())
                   for t, (a_t, _, _) in enumerate(tiles)]
        w_sums = [ws.to(f64) for _, _, ws in tiles]
        we64 = w_eff[:8, :8].reshape(64)

        def int8_library():
            out = 0
            for (a8, w8), ws in zip(stacked, w_sums):
                count = torch._int_mm(a8, w8).view(8, m, 8, n)
                acc = count.permute(1, 3, 0, 2).reshape(m * n, 64).to(
                    f64) @ we64
                row = a8.view(8, m, r).sum(-1, dtype=torch.int32).to(f64)
                acc = (acc.view(m, n) - (w_eff[:8, 8] @ row)[:, None]
                       - (w_eff[8, :8] @ ws)[None, :] + w_eff[8, 8] * r)
                out = out + epilogue(acc.to(torch.float32))
            return torch.clamp_min(out, 0)

        int8_ms = timer.ms(int8_library, iters=5)
        del stacked
        n_bytes = (m * kp + sum(t[1].numel() + t[2].numel() * 4
                                for t in tiles) + 81 * 8 + 16 + m * n * 4)
        b_ms, b_by = bound_ms(n_bytes, 2.0 * 64 * m * kp * n, PEAK_INT8_OPS)
        rows.append({"M": m, "K": k, "N": n, "tiles": len(tiles), "ms": ms,
                     "plain_ms": plain_ms, "bmm_library_ms": bmm_ms,
                     "int8_library_ms": int8_ms, "bound_ms": b_ms,
                     "bound_by": b_by, **whole_row})
    main = rows[1]
    return {"name": "caat_mac", "route": "cuda",
            "source": "src/repro_torch/csrc/caat_mac.cu",
            "replaces": "src/repro/kernels/caat_mac/kernel.py:84",
            "max_abs_err": 0.0,
            "error_unit": "ADC codes against the plain version (equal); "
                          "vs_sim: |diff| <= 1 on <= 1e-3 of outputs",
            "checks": checks,
            "shape": "B=32768 R=1152 N=128 (conv2), one tile, 64 int8 "
                     "plane products",
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["int8_library_ms"],
            "library": "torch._int_mm over the stacked +/-1 planes "
                       "[8B, R] x [R, 8N] + the float64 combine",
            "bmm_library_ms": main["bmm_library_ms"],
            "bmm_library": "torch.bmm over the 9 W_eff-folded f32 planes "
                           "(TF32 off) + epilogue",
            "whole_op_ms": main["whole_op_ms"],
            "bound_rate": "int8 tensor cores, 1979 TOP/s",
            "shapes": rows}


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_versions(cim_ops, paged_ops):
    """Route the kernel wrappers to their plain twins (the replay;
    these calls are not counted as launches)."""
    with swapped(cim_ops, "cim_matmul_kernel", cim_ops.cim_matmul_plain), \
            swapped(paged_ops, "paged_attention_kernel",
                    paged_ops.paged_attention_plain), \
            swapped(paged_ops, "merge_splits_kernel",
                    paged_ops.merge_splits), \
            swapped(paged_ops, "flash_prefill_kernel",
                    paged_ops.flash_prefill_plain):
        yield


# The serving phases' model and requests: qwen3-8b frozen under
# w8a8_kernel (a_scale 0.05) from seed 0, 8 prompts of these lengths drawn
# from seed 1, 32 new tokens each.
PROMPT_LENS = (512, 64, 200, 96, 384, 128, 256, 80)
ARRIVALS = (0, 0, 0, 2, 4, 8, 8, 16)
MAX_NEW = 32
SAMPLE_SEED, TEMPERATURE = 7, 0.8


def frozen_params(torch, cfg, device, cache=None):
    """The serving phases' parameters; returns (params, plan, init_s).
    With a ``cache`` dict they are made once per (cfg, device) and kept
    there for the next serving phase."""
    from repro_torch.core import backend
    from repro_torch.models import model as M
    key = (cfg, str(device))
    if cache is None or key not in cache:
        plan = backend.load_plan("w8a8_kernel")
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(0)
        params = M.freeze_params(M.init(cfg, gen, device=device),
                                 a_scale=0.05, plan=plan)
        if device == "cuda":
            torch.cuda.synchronize()
        built = (params, plan, time.perf_counter() - t0)
        if cache is None:
            return built
        cache[key] = built
    return cache[key]


def serving_requests(torch, cfg):
    from repro_torch.serve import Request
    rng = torch.Generator().manual_seed(1)
    return [Request(rid=i, prompt=torch.randint(
                0, cfg.vocab, (n,), generator=rng).numpy(),
                max_new=MAX_NEW, arrival_step=a)
            for i, (n, a) in enumerate(zip(PROMPT_LENS, ARRIVALS))]


def chunked_prefill_logits(torch, params, cfg, prompt, mode, *, chunk,
                           device):
    """One prompt's last logits through model.prefill_chunk over a fresh
    bf16 pool of 16-token blocks."""
    from repro_torch.models import model as M
    from repro_torch.serve import kv_pool
    n = len(prompt)
    nblk = -(-n // 16)
    pages = kv_pool.init_pages(cfg, nblk + 1, 16, torch.bfloat16,
                               device=device)
    tables = torch.arange(1, nblk + 1, dtype=torch.int32,
                          device=device)[None]
    prompt = torch.as_tensor(prompt, device=device).long()
    for c0 in range(0, n, chunk):
        cnt = min(chunk, n - c0)
        toks = torch.zeros(1, chunk, dtype=torch.long, device=device)
        toks[0, :cnt] = prompt[c0:c0 + cnt]
        lg, pages = M.prefill_chunk(
            params, toks, cfg, pages=pages, block_tables=tables,
            pos=torch.tensor([c0], device=device),
            n_tok=torch.tensor([cnt], device=device),
            write_mask=torch.tensor([True], device=device),
            has_past=c0 > 0, mode=mode)
    return lg[0, :cfg.vocab].float()


def reset_launches(cim_ops, paged_ops):
    cim_ops.launches = 0
    paged_ops.decode_launches = 0
    paged_ops.prefill_launches = 0
    paged_ops.merge_launches = 0


def read_launches(cim_ops, paged_ops) -> dict:
    return {"cim_matmul": cim_ops.launches,
            "paged_attention": paged_ops.decode_launches,
            "flash_prefill": paged_ops.prefill_launches,
            "merge_splits": paged_ops.merge_launches}


def logit_gate(torch, pf_logits, tokens_kernel, tokens_plain) -> dict:
    """Kernel vs plain prefill logits against the plain-vs-plain
    reordering floor (``pf_logits`` holds "kernel", "plain" and "reorder"
    lists), and first tokens that differ beyond that noise."""
    d_kp, d_floor, scale, margins = [], [], [], []
    ties, mismatch, gaps = [], [], {}
    for i, (lk, lp, lr) in enumerate(zip(*pf_logits.values())):
        d_kp.append((lk - lp).abs().max().item())
        d_floor.append((lp - lr).abs().max().item())
        scale.append(lp.abs().max().item())
        top2 = lp.topk(2).values
        margins.append(float(top2[0] - top2[1]))
        tk, tp = int(tokens_kernel[i][0]), int(tokens_plain[i][0])
        if tk != tp:
            # A different first token is a tie at this precision only when
            # the kernel's pick is within this request's reordering noise
            # (plain vs plain) of the plain maximum.
            gaps[i] = float(lp[tp] - lp[tk])
            (ties if gaps[i] <= d_floor[-1] else mismatch).append(i)
    failures = []
    # Tolerance: reordering the attention sums alone moves these logits by
    # several percent of their range (the plain-vs-plain noise floor), so
    # kernel vs plain agreement is held to 1.5x that measured floor.
    if not max(d_kp) <= 1.5 * max(d_floor):
        failures.append(f"prefill logits differ by {max(d_kp)}, beyond 1.5x "
                        f"the noise floor {max(d_floor)}")
    if mismatch:
        failures.append(f"first tokens of {mismatch} differ beyond the "
                        "logit noise")
    return {"first_tokens_identical": sum(
                int(int(a[0]) == int(b[0]))
                for a, b in zip(tokens_kernel, tokens_plain)),
            "first_token_ties": ties, "first_token_mismatches": mismatch,
            "first_token_plain_logit_gaps": gaps,
            "prefill_logit_max_abs_diff": d_kp,
            "prefill_logit_noise_floor": d_floor,
            "prefill_logit_range": scale,
            "prefill_top2_margin_plain": margins}, failures


def main_path(torch, cfg, cim_ops, paged_ops, *, device="cuda",
              chunk: int = 64, cache=None):
    """Serve 8 requests through the port's ContinuousEngine at ``cfg``'s
    widths, then replay them through the plain versions.  (``device`` and
    ``chunk`` let the same code be rehearsed at a reduced size on CPU.)"""
    from repro_torch.models import model as M
    from repro_torch.serve import ContinuousEngine, RequestStatus

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    params, plan, init_s = frozen_params(torch, cfg, device, cache)
    reqs = serving_requests(torch, cfg)
    kw = dict(plan=plan, max_batch=8, kv_blocks=512, block_size=16,
              segment_len=8, paged_attn=True, chunked_prefill=True,
              prefill_chunk=chunk, device=device)

    ce = ContinuousEngine(params, cfg, **kw)
    reset_launches(cim_ops, paged_ops)
    sync()
    t0 = time.perf_counter()
    res = ce.run(reqs)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches(cim_ops, paged_ops)
    n_tok = sum(len(r.tokens) for r in res.values())
    bad = [rid for rid, r in res.items() if r.status is not RequestStatus.OK]
    if len(res) != len(reqs) or bad:
        raise AssertionError(f"requests not OK: {bad}")
    for name, n in launches.items():
        if n <= 0 and device == "cuda":
            raise AssertionError(f"{name} never launched on the main path")
    ce.allocator.check_invariants()

    # Device time by kernel: the same requests once more, each kernel
    # wrapper (and the partials' merge) bracketed by CUDA events.  Not the
    # timed run: the events add host work.
    kernel_time = None
    if device == "cuda":
        # An event pair spans the wrapper's host work too when the card
        # waits for the host, so the same run is also traced with
        # torch.profiler for the kernels' own device time.
        from torch.profiler import ProfilerActivity, profile
        ce_ev = ContinuousEngine(params, cfg, **kw)
        wrappers = ((cim_ops, "cim_matmul_kernel"),
                    (paged_ops, "paged_attention_kernel"),
                    (paged_ops, "flash_prefill_kernel"),
                    (paged_ops, "merge_splits_kernel"))
        # Calls made inside model.prefill_chunk are tagged "prefill", the
        # rest "decode", so K1's time splits by phase.
        phase = ["decode"]

        def prefill_tagged(*a, _fn=M.prefill_chunk, **k):
            phase[0] = "prefill"
            try:
                return _fn(*a, **k)
            finally:
                phase[0] = "decode"

        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                swapped(M, "prefill_chunk", prefill_tagged), \
                event_timed(torch, wrappers, lambda: phase[0]) as events:
            sync()
            t0 = time.perf_counter()
            ce_ev.run(reqs)
            sync()
            ev_wall = time.perf_counter() - t0
        kernel_time = {"phase": "main_kernel_time", "wall_s": ev_wall,
                       "timed_run_wall_s": wall, "events": {},
                       "profiler": device_time_by_kernel(prof, ev_wall)}
        for name, triples in events.items():
            entry = {}
            for tag in (None, "decode", "prefill"):
                sel = [(a, b) for a, b, t in triples
                       if tag is None or t == tag]
                ms = sum(a.elapsed_time(b) for a, b in sel)
                entry[tag or "all"] = {"calls": len(sel), "ms": ms,
                                       "share_of_wall": ms / (ev_wall * 1e3)}
            kernel_time["events"][name] = entry
        emit(kernel_time)

    # Replay through the plain versions on the card.
    ce_plain = ContinuousEngine(params, cfg, **kw)
    with plain_versions(cim_ops, paged_ops):
        res_plain = ce_plain.run(reqs)
    agree = [float((res[i].tokens == res_plain[i].tokens).mean())
             for i in sorted(res)]

    # Each request's prefill logits (its first-token decision), straight
    # through the model three ways: with the kernels, with their plain
    # twins, and with the plain gather-then-attend reference, whose
    # attention sums the same values in yet another order.  The last pair
    # measures how far reordering alone moves the logits (the noise floor
    # of a random-weight bf16 W8A8 model 36 layers deep).
    runs = {"kernel": (False, ce.plan), "plain": (True, ce.plan),
            "reorder": (True, dataclasses.replace(ce.plan,
                                                  paged_attn=False))}
    pf_logits = {name: [] for name in runs}
    for name, (plain, mode) in runs.items():
        ctx = (plain_versions(cim_ops, paged_ops) if plain
               else contextlib.nullcontext())
        with ctx:
            for r in reqs:
                pf_logits[name].append(chunked_prefill_logits(
                    torch, params, cfg, r.prompt, mode, chunk=chunk,
                    device=device))
    gate, failures = logit_gate(
        torch, pf_logits, [res[r.rid].tokens for r in reqs],
        [res_plain[r.rid].tokens for r in reqs])
    result = {"phase": "main",
              "device": (torch.cuda.get_device_name(0) if device == "cuda"
                         else device),
              "layers": cfg.n_layers,
              "requests": len(res), "tokens": n_tok, "wall_s": wall,
              # One cold run: the wall time holds prefill, decode and the
              # process's first-call CUDA start-up.
              "tokens_per_wall_s": n_tok / wall, "init_s": init_s,
              "segments": ce.last_run_segments,
              "prefill_chunks": ce.last_run_prefill_chunks,
              "launches": launches,
              "kernel_device_time": kernel_time,
              **gate,
              "first_tokens": [int(res[i].tokens[0]) for i in sorted(res)],
              "first_tokens_plain": [int(res_plain[i].tokens[0])
                                     for i in sorted(res)],
              "stream_agreement": agree,
              "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if device == "cuda" else None)}
    result["ok"] = not failures
    return result, launches, failures


# ---------------------------------------------------------------------------
# The static engine, blocking prefill and the sampler
# ---------------------------------------------------------------------------

def sampler_check(torch, engine, vocab: int, device="cuda"):
    """The seeded sampler on the card against the CPU: a [8, vocab] draw's
    random bits equal bit for bit, its gumbel within 2 ulp; then the
    engine's sampler's time per call at batch 1 and 8 (CUDA events, mean
    of 20)."""
    from repro_torch.serve import prng
    failures = []
    rids = torch.arange(8, dtype=torch.int32)
    keys = prng.fold_in(prng.fold_in(
        prng.PRNGKey(SAMPLE_SEED).expand(8, 2), rids), 3)
    bits_cpu = prng.random_bits(keys, (vocab,))
    bits_dev = prng.random_bits(keys.to(device), (vocab,))
    g_cpu = prng.gumbel(keys, (vocab,))
    g_dev = prng.gumbel(keys.to(device), (vocab,))
    bits_equal = torch.equal(bits_dev.cpu(), bits_cpu)
    # Within 2 f32 ulp of max(|g|, 1): near g = 0 the outer log passes its
    # input's rounding through as an absolute error.
    gumbel_ok = bool(((g_dev.cpu() - g_cpu).abs() <= 2 * torch.finfo(
        torch.float32).eps * g_cpu.abs().clamp_min(1.0)).all())
    logits = torch.randn(8, vocab, generator=torch.Generator().manual_seed(2))
    temp = torch.tensor(TEMPERATURE)
    draw_cpu = prng.categorical(keys, logits / temp)
    draw_dev = prng.categorical(keys.to(device), logits.to(device)
                                / temp.to(device)).cpu()
    if not bits_equal:
        failures.append("the card's random bits differ from the CPU's")
    if not gumbel_ok:
        failures.append("the card's gumbel is not within 2 ulp of the CPU's")
    result = {"random_bits_equal": bits_equal, "gumbel_within_2ulp": gumbel_ok,
              "gumbel_max_abs_diff": float((g_dev.cpu() - g_cpu).abs().max()),
              "categorical_equal": int((draw_dev == draw_cpu).sum()),
              "shape": [8, vocab]}
    if device == "cuda":
        sample = engine.make_sample(engine.plan, greedy=False)
        key = prng.PRNGKey(SAMPLE_SEED, device=device)
        for b in (1, 8):
            lg = logits[:b].to(device)
            r = torch.arange(b, dtype=torch.int32, device=device)
            t_dev = temp.to(device)
            for _ in range(3):
                sample(lg, key, r, 5, t_dev)
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for _ in range(20):
                sample(lg, key, r, 5, t_dev)
            e.record()
            e.synchronize()
            result[f"sample_ms_b{b}"] = a.elapsed_time(e) / 20
    return result, failures


def static_path(torch, cfg, cim_ops, paged_ops, *, device="cuda",
                chunk: int = 64, cache=None):
    """The static engine (``Engine.generate`` over dense KV caches) at
    ``cfg``'s widths under w8a8_kernel: the 8 serving prompts, one call
    each (bucketed to 32), 32 new tokens, greedy with the kernels (K1 must
    launch on every linear of every prefill and decode step), greedy with
    the plain versions, and twice sampled with one key (identical
    streams).  Prefill logits are gated as the main path's; the decode
    step is timed greedy and sampled, and the sampler alone."""
    from repro_torch.serve import Engine, prng

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    params, plan, init_s = frozen_params(torch, cfg, device, cache)
    prompts = [torch.as_tensor(r.prompt) for r in serving_requests(torch,
                                                                   cfg)]
    max_len = max(PROMPT_LENS) + MAX_NEW + 32
    eng = Engine(params, cfg, max_len=max_len, plan=plan, device=device)
    key = prng.PRNGKey(SAMPLE_SEED, device=device)

    def serve(sampled: bool):
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        out = [eng.generate({"tokens": p[None]}, max_new_tokens=MAX_NEW,
                            temperature=TEMPERATURE if sampled else 0.0,
                            key=key if sampled else None, request_ids=[i])
               for i, p in enumerate(prompts)]
        sync()
        wall = time.perf_counter() - t0
        toks = [r.tokens[0].cpu() for r in out]
        n = sum(len(t) for t in toks)
        return toks, {"wall_s": wall, "tokens": n,
                      "tokens_per_wall_s": n / wall,
                      "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                      if device == "cuda" else None)}

    reset_launches(cim_ops, paged_ops)
    greedy, run_greedy = serve(False)
    launches = read_launches(cim_ops, paged_ops)
    with plain_versions(cim_ops, paged_ops):
        greedy_plain, run_plain = serve(False)
    sampled_a, run_sampled_a = serve(True)
    sampled_b, run_sampled_b = serve(True)

    failures = []
    # K1 on every linear: 7 per layer and the head, in the prefill and in
    # each of the MAX_NEW decode steps of every call.
    want_k1 = len(prompts) * (MAX_NEW + 1) * (7 * cfg.n_layers + 1)
    if device == "cuda" and launches["cim_matmul"] != want_k1:
        failures.append(f"K1 launched {launches['cim_matmul']} times on the "
                        f"static path, not once per linear ({want_k1})")
    if not all(torch.equal(a, b) for a, b in zip(sampled_a, sampled_b)):
        failures.append("two sampled runs with one key differ")

    pf_logits = {"kernel": [], "plain": [], "reorder": []}
    prefill = eng.prefill_fn(plan)
    for p in prompts:
        batch = eng.bucket({"tokens": p[None].to(device)})
        pf_logits["kernel"].append(
            prefill(params, batch)[0][0, -1, :cfg.vocab].float())
        with plain_versions(cim_ops, paged_ops):
            pf_logits["plain"].append(
                prefill(params, batch)[0][0, -1, :cfg.vocab].float())
            # The same logits through the chunked paged prefill's gather
            # reference: another summation order of the same attention.
            pf_logits["reorder"].append(chunked_prefill_logits(
                torch, params, cfg, p.numpy(),
                dataclasses.replace(plan, paged_attn=False), chunk=chunk,
                device=device))
    gate, gate_failures = logit_gate(torch, pf_logits, greedy, greedy_plain)
    failures += gate_failures

    # Time of one decode step at batch 1 after the longest prompt, greedy
    # and sampled (host clock around 16 steps, synchronized), beside the
    # sampler alone.
    step_ms = {}
    batch = eng.bucket({"tokens": prompts[0][None].to(device)})
    rids = torch.zeros(1, dtype=torch.int32, device=device)
    temp = torch.tensor(TEMPERATURE, device=device)
    for greedy_step in (True, False):
        step = eng.make_step(plan, greedy_step)
        logits, caches = prefill(params, batch)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        tok, _, _, caches = step(params, tok, caches, key, rids, 1, temp)
        sync()
        t0 = time.perf_counter()
        for t in range(16):
            tok, _, _, caches = step(params, tok, caches, key, rids, t + 2,
                                     temp)
        sync()
        step_ms["greedy" if greedy_step else "sampled"] = \
            (time.perf_counter() - t0) / 16 * 1e3
    sampler, sampler_failures = sampler_check(torch, eng, cfg.padded_vocab,
                                              device)
    failures += sampler_failures
    if "sample_ms_b1" in sampler:
        sampler["share_of_sampled_step"] = (sampler["sample_ms_b1"]
                                            / step_ms["sampled"])

    result = {"phase": "static",
              "device": (torch.cuda.get_device_name(0) if device == "cuda"
                         else device),
              "layers": cfg.n_layers, "calls": len(prompts),
              "prompt_lens": list(PROMPT_LENS), "max_new": MAX_NEW,
              "buckets": [int(eng.bucket({"tokens": p[None]})["tokens"]
                              .shape[1]) for p in prompts],
              "init_s": init_s, "launches": launches,
              "k1_launches_expected": want_k1,
              "runs": {"greedy": run_greedy, "greedy_plain": run_plain,
                       "sampled": run_sampled_a,
                       "sampled_again": run_sampled_b},
              "stream_agreement_plain": [
                  float((a == b).float().mean()) for a, b in
                  zip(greedy, greedy_plain)],
              "sampled_equal_greedy": [
                  float((a == b).float().mean()) for a, b in
                  zip(sampled_a, greedy)],
              **gate,
              "decode_step_ms_b1": step_ms, "sampler": sampler}
    result["ok"] = not failures
    return result, launches, failures


def blocking_path(torch, cfg, cim_ops, paged_ops, *, device="cuda",
                  cache=None):
    """The serving path with blocking prefill (the ContinuousEngine
    default): the main path's requests and pool, paged attention,
    sampled at temperature 0.8 with one key; every request must be OK and
    K1 and K2 must launch."""
    from repro_torch.serve import ContinuousEngine, RequestStatus, prng

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    params, plan, _ = frozen_params(torch, cfg, device, cache)
    reqs = serving_requests(torch, cfg)
    ce = ContinuousEngine(params, cfg, plan=plan, max_batch=8,
                          kv_blocks=512, block_size=16, segment_len=8,
                          paged_attn=True, chunked_prefill=False,
                          device=device)
    reset_launches(cim_ops, paged_ops)
    sync()
    t0 = time.perf_counter()
    res = ce.run(reqs, key=prng.PRNGKey(SAMPLE_SEED, device=device),
                 temperature=TEMPERATURE)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches(cim_ops, paged_ops)
    ce.allocator.check_invariants()
    failures = []
    bad = [rid for rid, r in res.items() if r.status is not RequestStatus.OK]
    if len(res) != len(reqs) or bad:
        failures.append(f"blocking-prefill requests not OK: {bad}")
    for name in ("cim_matmul", "paged_attention"):
        if device == "cuda" and launches[name] <= 0:
            failures.append(f"{name} never launched on the blocking path")
    n_tok = sum(len(r.tokens) for r in res.values())
    result = {"phase": "blocking", "layers": cfg.n_layers,
              "requests": len(res), "ok_requests": len(res) - len(bad),
              "tokens": n_tok, "wall_s": wall,
              "tokens_per_wall_s": n_tok / wall,
              "prefills": ce.last_run_prefills,
              "prefill_s": ce.last_run_prefill_seconds,
              "segments": ce.last_run_segments, "launches": launches,
              "temperature": TEMPERATURE,
              "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if device == "cuda" else None)}
    result["ok"] = not failures
    return result, launches, failures


# ---------------------------------------------------------------------------
# The VGG-8 deployment path
# ---------------------------------------------------------------------------

def vgg8_path(torch, cim_ops, bs_ops, caat_ops, *, device="cuda", cfg=None,
              n_calib: int = 64, n_images: int = 64):
    """The paper's VGG-8 deployment (repro_torch.launch.fig10) at ``cfg``'s
    widths (default: the published VGG-8) with random weights from seed 0.
    Checks the kernel plans bit for bit against their plain plans, runs
    the cim plan raw and fine-tuned, and holds the CAAT macro op on every
    cim layer's int8 inputs against the behavioural simulation with an
    ideal ADC.  (``device``, ``cfg``, ``n_calib`` and ``n_images`` let it
    be rehearsed at a reduced size on CPU.)"""
    from repro_torch.configs import vgg8_cifar10
    from repro_torch.core import adc, macro
    from repro_torch.core import backend as backend_lib
    from repro_torch.data import synthetic
    from repro_torch.launch import fig10
    from repro_torch.models import vgg

    cfg = cfg or vgg8_cifar10.config()
    failures = []

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    forward_s = {}

    def timed(name, fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        forward_s[name] = time.perf_counter() - t
        if not bool(torch.isfinite(out).all()):
            failures.append(f"{name}: non-finite logits")
        return out

    t0 = time.perf_counter()
    params = vgg.init_vgg8(gen(0), cfg)
    images, _ = synthetic.synthetic_cifar(gen(99), n_images, cfg.n_classes,
                                          cfg.image_size)
    calib, _ = synthetic.synthetic_cifar(gen(7), n_calib, cfg.n_classes,
                                         cfg.image_size)
    cim_ops.launches = bs_ops.launches = caat_ops.launches = 0
    a_scales = vgg.collect_activation_scales(params, calib, cfg)
    frozen = vgg.freeze_vgg8(params, cfg, a_scales, mode="w8a8")

    def forward(plan):
        return vgg.vgg8_forward(frozen, images, cfg, mode=plan,
                                a_scales=a_scales)

    expected = {}   # launches each kernel must show, per the path's shapes
    w8a8 = timed("w8a8", lambda: forward("w8a8"))
    expected["cim_matmul"] = 2 * len(vgg.VGG8_LAYER_PATHS)
    for residency in (False, True):
        plan = backend_lib.DeploymentPlan(default="w8a8_kernel",
                                          residency=residency)
        name = "w8a8_kernel" + ("+residency" if residency else "")
        if not torch.equal(timed(name, lambda: forward(plan)), w8a8):
            failures.append(f"{name} logits differ from plain w8a8")
    expected["bitplane_matmul"] = 8 * len(vgg.VGG8_LAYER_PATHS)
    bitserial = timed("bitserial", lambda: forward("bitserial"))
    if not torch.equal(timed("bitserial_kernel",
                             lambda: forward("bitserial_kernel")),
                       bitserial):
        failures.append("bitserial_kernel logits differ from plain "
                        "bitserial")
    # bitserial vs w8a8: equal up to the f32 shift-add rounding past 2**24;
    # a different argmax is a tie only inside that rounding.
    rounding = (bitserial - w8a8).abs().amax(-1)
    top2 = w8a8.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    differ = bitserial.argmax(-1) != w8a8.argmax(-1)
    ties = differ & (gap <= 2 * rounding)
    if bool((differ & ~ties).any()):
        failures.append("bitserial argmax differs from w8a8 beyond the "
                        "shift-add rounding")

    # The cim plan: calibrated full scales, 8 sampled chips, per-channel
    # fine-tunes, at batch 32.
    d = fig10.deploy(params, cfg, "cim", calib, 0, device)
    cim_imgs = images[:32]
    stats_raw: list = []
    timed("cim_raw", lambda: fig10.batched_logits(
        d["raw"], cim_imgs, cfg, "cim", d["a_scales"], d["chips"], 32,
        stats_raw))
    calls = []
    sim = macro.cim_matmul_sim

    def recording_sim(a, w, chip, v_fs, mcfg, relu=True):
        calls.append((a, w, chip, v_fs, mcfg, relu))
        return sim(a, w, chip, v_fs, mcfg, relu=relu)

    stats_ft: list = []
    with swapped(macro, "cim_matmul_sim", recording_sim):
        ft = timed("cim_finetuned", lambda: fig10.batched_logits(
            d["finetuned"], cim_imgs, cfg, "cim", d["a_scales"], d["chips"],
            32, stats_ft))
    layers = fig10.layer_report("cim", cfg, stats_ft)
    # The CAAT macro op on each cim layer's actual int8 inputs: one launch
    # per row tile.
    expected["caat_mac"] = sum(-(-sp.in_dim // sp.macro.rows)
                               for sp in cfg.layer_specs())
    # Its device memory alone: the peak over the 8 calls, beside what was
    # allocated before them.
    cuda = device == "cuda"
    sync()
    phase_peak = torch.cuda.max_memory_allocated() if cuda else 0
    k5_base = torch.cuda.memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    k5_codes = [caat_ops.cim_macro_matmul(a, w, chip, v_fs, mcfg, relu=relu)
                for a, w, chip, v_fs, mcfg, relu in calls]
    sync()
    k5_peak = torch.cuda.max_memory_allocated() if cuda else 0
    k5 = []
    for path, got, (a, w, chip, v_fs, mcfg, relu) in zip(
            vgg.VGG8_LAYER_PATHS, k5_codes, calls):
        ideal = {"caat": chip["caat"], "adc": adc.ideal_adc(mcfg.adc,
                                                              device)}
        want, _ = sim(a, w, ideal, v_fs, mcfg, relu=relu)
        try:
            k5.append({"layer": path, **code_diff(
                torch, got, want.to(torch.int32), f"K5 on {path}")})
        except AssertionError as e:
            failures.append(str(e))
    sync()
    launches = {"cim_matmul": cim_ops.launches,
                "bitplane_matmul": bs_ops.launches,
                "caat_mac": caat_ops.launches}
    if len(calls) != len(vgg.VGG8_LAYER_PATHS):
        failures.append(f"{len(calls)} cim layers recorded, not 8")
    for name, n in launches.items():
        if n != expected[name] and device == "cuda":
            failures.append(f"{name} launched {n} times on the vgg8 path, "
                            f"not {expected[name]}")
    result = {"phase": "vgg8",
              "device": (torch.cuda.get_device_name(0) if device == "cuda"
                         else device),
              "image_size": cfg.image_size, "images": n_images,
              "cim_images": int(cim_imgs.shape[0]),
              "seconds": time.perf_counter() - t0, "forward_s": forward_s,
              "launches": launches, "launches_expected": expected,
              "bitserial_vs_w8a8": {
                  "max_abs_logit_diff": float(rounding.max()),
                  "argmax_differs": int(differ.sum()),
                  "ties": int(ties.sum())},
              "cim_layers": layers,
              "cim_agree_with_w8a8": int(
                  (ft.argmax(-1) == w8a8[:32].argmax(-1)).sum()),
              "macro_energy_j": fig10.macro_energy_j(layers),
              "macro_energy_source": "65nm macro energy model of the "
                                     "fine-tuned cim forward's conversions",
              "k5_vs_sim": k5,
              "peak_mem_gb": (max(phase_peak,
                                  torch.cuda.max_memory_allocated()) / 1e9
                              if cuda else None),
              "k5_peak_mem_gb": k5_peak / 1e9 if cuda else None,
              "k5_base_mem_gb": k5_base / 1e9 if cuda else None}
    result["ok"] = not failures
    return result, launches, failures


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-main", action="store_true")
    ap.add_argument("--k5-only", action="store_true",
                    help="only time the whole CAAT macro op at every "
                         "VGG-8 shape")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch package is driven "
                         "(with --k5-only: another tree's op)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels.bitserial_matmul import ops as bs_ops
    from repro_torch.kernels.caat_mac import ops as caat_ops
    from repro_torch.kernels.cim_matmul import ops as cim_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": name,
          "capability": list(torch.cuda.get_device_capability(0)),
          "nvidia_smi": smi})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report: dict = {"nvidia_smi": smi}

    if args.k5_only:   # builds the one kernel at its first launch
        emit({"phase": "k5_whole_op", "src": args.src, "nvidia_smi": smi,
              "shapes": k5_whole_op_ms(
                  torch, Timer(torch), caat_ops,
                  torch.Generator(device="cuda").manual_seed(1234))})
        return 0
    build_s = build.build_all()
    report["ptxas"] = build.BUILD_LOG
    emit({"phase": "build", "seconds": build_s,
          "sources": list(build.SOURCES)})

    gen = torch.Generator(device="cuda").manual_seed(1234)
    timer = Timer(torch)
    kernels = []
    for check, ops in ((check_k1, cim_ops), (check_k2, paged_ops),
                       (check_merge, paged_ops), (check_k3, paged_ops),
                       (check_k4, bs_ops), (check_k5, caat_ops)):
        t = time.perf_counter()
        entry = check(torch, timer, ops, gen)
        entry["check_s"] = time.perf_counter() - t
        kernels.append(entry)
        emit({"phase": "kernel", **entry})
    del timer

    # Launches by path: each path is driven with every count set to 0
    # just before it and read just after.
    by_path = {}
    if not args.skip_main:
        from repro_torch import configs
        qwen = dataclasses.replace(configs.get_config("qwen3-8b"),
                                   kv_cache_dtype="int8")
        # The three serving phases share one model, made in the first.
        served: dict = {}
        paths = (
            ("main", lambda: main_path(torch, qwen, cim_ops, paged_ops,
                                       cache=served)),
            ("static", lambda: static_path(torch, qwen, cim_ops, paged_ops,
                                           cache=served)),
            ("blocking", lambda: blocking_path(torch, qwen, cim_ops,
                                               paged_ops, cache=served)),
            ("vgg8", lambda: vgg8_path(torch, cim_ops, bs_ops, caat_ops)))
        for path, drive in paths:
            if path == "vgg8":
                served.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            result, by_path[path], failures = drive()
            result["nvidia_smi"] = smi
            emit(result)
            report[path] = result
            if failures:
                (out_dir / "chip_smoke.json").write_text(
                    json.dumps(report, indent=1))
                raise AssertionError("; ".join(failures))
    for k in kernels:
        counts = {p: c[k["name"]] for p, c in by_path.items()
                  if k["name"] in c}
        k["launches"] = sum(counts.values()) if counts else None
        k["launches_by_path"] = counts
    report["kernels"] = kernels
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
