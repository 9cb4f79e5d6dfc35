"""The 8-pass bit-serial baseline (port of
``repro/kernels/bitserial_matmul/ops.py``): one bit-plane matmul per
two's-complement activation bit, then a digital shift-add.

:func:`bitplane_matmul` runs one plane through :func:`bitplane_matmul_kernel`
(the CUDA kernel ``csrc/bitplane_matmul.cu``) on a CUDA tensor, or through
:func:`bitplane_matmul_plain` (the same function in plain PyTorch) on a CPU
tensor; a CUDA tensor never takes the plain path.  Which of the file's
two kernels runs is ``autotune.cim_matmul_config`` of the shape (the
wgmma kernel where K and N are multiples of 16, else the byte-masked
one); both mask ragged M/N/K themselves, so nothing is padded.
:func:`bitserial_matmul` launches the 8 planes and shift-adds their partial sums in f32 from plane 0 up, the
sign plane weighted -2**7, exactly in the reference's order: past 2**24
the f32 accumulator rounds, and the same order gives the same rounding.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import autotune, build

# Launches of the CUDA kernel (plain integer; reset it to 0 before a run).
launches = 0


def bitplane_matmul_plain(a_q: torch.Tensor, w_q: torch.Tensor,
                          plane: int) -> torch.Tensor:
    """Plane ``plane`` of int8 A [M, K], ``(uint8(a) >> plane) & 1``,
    times int8 W [K, N] -> int32 [M, N].  The product is exact (float64,
    as torch has no int8 GEMM on CUDA)."""
    bits = (a_q.view(torch.uint8) >> plane) & 1
    acc = torch.matmul(bits.to(torch.float64), w_q.to(torch.float64))
    return acc.to(torch.int32)


@functools.cache
def _fn():
    fn = build.library("bitplane_matmul").bitplane_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _wgmma_fn():
    fn = build.library("bitplane_matmul").bitplane_matmul_wgmma_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def bitplane_matmul_kernel(a_q: torch.Tensor, w_q: torch.Tensor,
                           plane: int) -> torch.Tensor:
    """Launch the CUDA kernel; same arguments and result as
    :func:`bitplane_matmul_plain`.  Raises on anything it does not take."""
    global launches
    dev = a_q.device
    if dev.type != "cuda":
        raise ValueError(f"bitplane_matmul_kernel needs CUDA tensors, got "
                         f"{dev}")
    if a_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"a_q and w_q must be int8, got {a_q.dtype}, "
                        f"{w_q.dtype}")
    if a_q.ndim != 2 or w_q.ndim != 2 or a_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"need [M,K] x [K,N], got {tuple(a_q.shape)} x "
                         f"{tuple(w_q.shape)}")
    if not 0 <= plane < 8:
        raise ValueError(f"plane must be in [0, 8), got {plane}")
    for t in (a_q, w_q):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous, 16-byte "
                             "aligned tensors on one device")
    (m, k), n = a_q.shape, w_q.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    cfg = autotune.cim_matmul_config(m, n, k, sm_count(dev))
    if cfg.path == "wgmma":
        rc = _wgmma_fn()(a_q.data_ptr(), w_q.data_ptr(), out.data_ptr(), m,
                         n, k, plane, cfg.nt, cfg.bt, cfg.splits, stream)
    else:
        rc = _fn()(a_q.data_ptr(), w_q.data_ptr(), out.data_ptr(), m, n, k,
                   plane, stream)
    build.check(rc, "bitplane_matmul")
    launches += 1
    return out


def bitplane_matmul(a_q: torch.Tensor, w_q: torch.Tensor, plane: int
                    ) -> torch.Tensor:
    """One bit-plane pass: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if a_q.device.type == "cpu":
        return bitplane_matmul_plain(a_q, w_q, plane)
    return bitplane_matmul_kernel(a_q, w_q, plane)


def bitserial_matmul(a_q, w_q, a_scale, w_scale, bias=None, *,
                     relu: bool = False, nbits: int = 8) -> torch.Tensor:
    """8 bit-plane passes + f32 shift-add + one dequant/bias/ReLU epilogue
    over leading batch dims.  a_q [..., K] int8, w_q [K, N] int8, w_scale
    and bias [N]."""
    k, n = w_q.shape
    lead = a_q.shape[:-1]
    a2 = a_q.reshape(-1, k)
    if a2.data_ptr() % 16 or not a2.is_contiguous():
        a2 = a2.clone(memory_format=torch.contiguous_format)
    acc = torch.zeros((a2.shape[0], n), dtype=torch.float32,
                      device=a_q.device)
    for plane in range(nbits):  # 8 separate passes over the data
        psum = bitplane_matmul(a2, w_q, plane).to(torch.float32)
        weight = -(2.0 ** (nbits - 1)) if plane == nbits - 1 else 2.0 ** plane
        acc = acc + weight * psum
    y = acc * (a_scale * w_scale[None, :])
    if bias is not None:
        y = y + bias[None, :]
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.reshape(*lead, n)
