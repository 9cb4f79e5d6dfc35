"""Public wrapper of the fused W8A8 single-conversion matmul (port of
``repro/kernels/cim_matmul/ops.py``).

``cim_matmul`` handles leading batch dims, the optional f32 input (quantized
in the kernel prologue), bias and the optional int8 requant epilogue, then
runs :func:`cim_matmul_kernel` (the CUDA kernel ``csrc/cim_matmul.cu``) on
a CUDA tensor or :func:`cim_matmul_plain` (the same function in plain
PyTorch) on a CPU tensor.  A CUDA tensor never takes the plain path: the
kernel launches or the wrapper raises.  Every shape is taken.  Which of
the file's two kernels runs, with which tile and split, is
``autotune.cim_matmul_config`` of the shape: the wgmma kernel where K and
N are multiples of 16 (an f32 input is then quantized once per launch
into an int8 scratch allocated here), else the byte-masked kernel (VGG-8's
conv1 has K = 27, its head N = 10).  Nothing is padded here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import autotune, build

# Launches of the CUDA kernel (plain integer; reset it to 0 before a run).
launches = 0


def cim_matmul_plain(a, w_q, a_scale, w_scale, bias, out_scale, *,
                     relu: bool = False, requant: bool = False
                     ) -> torch.Tensor:
    """The kernel's function in plain PyTorch.  a [M,K] int8 or f32; w_q
    [K,N] int8; a_scale / out_scale 0-dim f32; w_scale, bias [N] f32.

    The int8 product is exact (float64 accumulation, see core/quant.py),
    then the same f32 epilogue as the kernel, so the two agree bit for
    bit."""
    if a.dtype != torch.int8:
        a = torch.clamp(torch.round(a / a_scale), -128, 127).to(torch.int8)
    acc = torch.matmul(a.to(torch.float64), w_q.to(torch.float64))
    y = acc.to(torch.int32).to(torch.float32) * (a_scale * w_scale)
    y = y + bias
    if relu:
        y = torch.clamp_min(y, 0.0)
    if requant:
        return torch.clamp(torch.round(y / out_scale), -128, 127).to(
            torch.int8)
    return y


@functools.cache
def _fn():
    lib = build.library("cim_matmul")
    fn = lib.cim_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _wgmma_fn():
    fn = build.library("cim_matmul").cim_matmul_wgmma_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def cim_matmul_kernel(a, w_q, a_scale, w_scale, bias, out_scale, *,
                      relu: bool = False, requant: bool = False
                      ) -> torch.Tensor:
    """Launch the CUDA kernel; same arguments and result as
    :func:`cim_matmul_plain`.  Raises on anything the kernel does not
    take."""
    global launches
    m, k = a.shape
    k2, n = w_q.shape
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"cim_matmul_kernel needs CUDA tensors, got {dev}")
    if k != k2:
        raise ValueError(f"inner dims differ: {a.shape} x {w_q.shape}")
    if a.dtype not in (torch.int8, torch.float32) or w_q.dtype != torch.int8:
        raise TypeError(f"a must be int8 or f32 and w_q int8, got "
                        f"{a.dtype}, {w_q.dtype}")
    scalars = (a_scale, out_scale)
    vectors = (w_scale, bias)
    for s in scalars:
        if s.dtype != torch.float32 or s.numel() != 1 or s.device != dev:
            raise ValueError("a_scale/out_scale must be 1-element f32 "
                             "tensors on the kernel's device")
    for v in vectors:
        if v.dtype != torch.float32 or v.shape != (n,) or v.device != dev:
            raise ValueError(f"w_scale/bias must be [N={n}] f32 tensors on "
                             "the kernel's device")
    for t in (a, w_q, *vectors):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous, 16-byte "
                             "aligned tensors on one device")
    out = torch.empty((m, n), dtype=torch.int8 if requant else torch.float32,
                      device=dev)
    if m == 0:
        return out
    f32_in = int(a.dtype == torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cfg = autotune.cim_matmul_config(m, n, k, sm_count(dev))
    if cfg.path == "wgmma":
        scratch = (torch.empty((m, k), dtype=torch.int8, device=dev)
                   if f32_in else a)
        rc = _wgmma_fn()(a.data_ptr(), f32_in, scratch.data_ptr(),
                         w_q.data_ptr(), a_scale.data_ptr(),
                         w_scale.data_ptr(), bias.data_ptr(),
                         out_scale.data_ptr(), out.data_ptr(), m, n, k,
                         int(relu), int(requant), cfg.nt, cfg.bt,
                         cfg.splits, stream)
    else:
        rc = _fn()(a.data_ptr(), f32_in, w_q.data_ptr(), a_scale.data_ptr(),
                   w_scale.data_ptr(), bias.data_ptr(), out_scale.data_ptr(),
                   out.data_ptr(), m, n, k, int(relu), int(requant), stream)
    build.check(rc, "cim_matmul")
    launches += 1
    return out


def cim_matmul(a_q, w_q, a_scale, w_scale, bias=None, out_scale=None, *,
               relu: bool = False, requant: bool | None = None
               ) -> torch.Tensor:
    """Fused W8A8 linear: y = epilogue(a_q @ w_q) over leading dims.
    Returns f32, or int8 when requantizing (``out_scale`` given)."""
    if requant is None:
        requant = out_scale is not None
    k, n = w_q.shape
    lead = a_q.shape[:-1]
    dev = a_q.device
    if a_q.dtype != torch.int8:
        a_q = a_q.to(torch.float32)
    a2 = a_q.reshape(-1, k)
    if a2.data_ptr() % 16 or not a2.is_contiguous():
        a2 = a2.clone(memory_format=torch.contiguous_format)

    def f32(x, shape):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(
            shape)

    a_s = f32(a_scale, ())
    ws = f32(w_scale, (n,))
    b = (torch.zeros(n, dtype=torch.float32, device=dev) if bias is None
         else f32(bias, (n,)))
    os_ = f32(1.0 if out_scale is None else out_scale, ())
    if dev.type == "cpu":
        out = cim_matmul_plain(a2, w_q, a_s, ws, b, os_, relu=relu,
                               requant=requant)
    else:
        out = cim_matmul_kernel(a2, w_q, a_s, ws, b, os_, relu=relu,
                                requant=requant)
    return out.reshape(*lead, n)
