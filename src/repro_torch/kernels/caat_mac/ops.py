"""Full CiM matmul on the CAAT macro-tile kernel, the 9-plane fast form of
the behavioural simulation (port of ``repro/kernels/caat_mac/ops.py``).

:func:`cim_macro_matmul` mirrors ``core.macro.cim_matmul_sim`` (row tiling
+ digital accumulation) but runs each row tile through :func:`caat_mac`:
the CUDA kernel ``csrc/caat_mac.cu`` on a CUDA tensor, its plain PyTorch
version :func:`caat_mac_plain` on a CPU tensor (a CUDA tensor never takes
the plain path).  The ADC is the ideal quantizer here (no INL), as in the
reference.

Because the CAAT is linear, the wrapper folds the tree's effective
weights W_eff into the activation bit planes first (``a_fold[i] =
sum_k a_bits[k] * W_eff[k, i]``, 9 planes instead of 81), correctly
rounded to f32, the same on every device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import caat as caat_lib
from repro_torch.core import numerics
from repro_torch.kernels import build

# Launches of the CUDA kernel (plain integer; reset it to 0 before a run).
launches = 0


def caat_mac_plain(a_fold: torch.Tensor, w_bits: torch.Tensor,
                   scalars: torch.Tensor) -> torch.Tensor:
    """One macro row tile.  a_fold [P, B, R] f32 (folded activation
    planes), w_bits [P, R, N] int8 in {-1, +1}, scalars [4] f32 = (inv_m,
    tree offset, fs_ratio, relu flag).  Returns int32 codes [B, N]:
    ``clip(round((acc * inv_m + off) * fs_ratio * 128), -128, 127)``,
    ReLU'd when the flag is > 0.

    acc is the sum over planes and rows, taken in float64 and rounded
    once to f32.  The float64 error is far below f32 resolution, so the
    result does not depend on the order of the sum (barring a tie within
    2**-53 of an f32 rounding boundary), and the CUDA kernel, which sums in
    float64 too, matches it.  (An f32 sum in some order would move up to
    ~1e-3 of the codes by one at VGG-8's shapes, where v * 128 lands within
    its rounding of a .5 boundary.)"""
    acc = torch.zeros((a_fold.shape[1], w_bits.shape[2]),
                      dtype=torch.float64, device=a_fold.device)
    for p in range(a_fold.shape[0]):
        acc = acc + torch.matmul(a_fold[p].to(torch.float64),
                                 w_bits[p].to(torch.float64))
    v = (acc.to(torch.float32) * scalars[0] + scalars[1]) * scalars[2]
    code = torch.clamp(torch.round(v * 128.0), -128, 127)
    code = torch.where(scalars[3] > 0, torch.clamp_min(code, 0.0), code)
    return code.to(torch.int32)


@functools.cache
def _fn():
    fn = build.library("caat_mac").caat_mac_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def caat_mac_kernel(a_fold: torch.Tensor, w_bits: torch.Tensor,
                    scalars: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; same arguments and result as
    :func:`caat_mac_plain`.  The operands may be strided views (one row
    tile of larger planes) as long as their last axis is contiguous and
    w_bits' rows are dense.  Raises on anything it does not take."""
    global launches
    dev = a_fold.device
    if dev.type != "cuda":
        raise ValueError(f"caat_mac_kernel needs CUDA tensors, got {dev}")
    if (a_fold.dtype != torch.float32 or w_bits.dtype != torch.int8
            or scalars.dtype != torch.float32):
        raise TypeError(f"need f32 a_fold, int8 w_bits, f32 scalars; got "
                        f"{a_fold.dtype}, {w_bits.dtype}, {scalars.dtype}")
    if a_fold.ndim != 3 or w_bits.ndim != 3 or scalars.numel() != 4:
        raise ValueError("need a_fold [P,B,R], w_bits [P,R,N], scalars [4]")
    p, b, r = a_fold.shape
    p2, r2, n = w_bits.shape
    if (p, r) != (p2, r2):
        raise ValueError(f"plane/row dims differ: {tuple(a_fold.shape)} vs "
                         f"{tuple(w_bits.shape)}")
    if a_fold.stride(2) != 1 or w_bits.stride(2) != 1 \
            or w_bits.stride(1) != n or not scalars.is_contiguous():
        raise ValueError("a_fold needs a contiguous last axis, w_bits dense "
                         "[R, N] rows, scalars contiguous")
    for t in (w_bits, scalars):
        if t.device != dev:
            raise ValueError("kernel operands must share one device")
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return out
    rc = _fn()(a_fold.data_ptr(), a_fold.stride(0), a_fold.stride(1),
               w_bits.data_ptr(), w_bits.stride(0), scalars.data_ptr(),
               out.data_ptr(), b, r, n, p,
               torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "caat_mac")
    launches += 1
    return out


def caat_mac(a_fold, w_bits, scalars) -> torch.Tensor:
    """One row tile: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if a_fold.device.type == "cpu":
        return caat_mac_plain(a_fold, w_bits, scalars)
    return caat_mac_kernel(a_fold, w_bits, scalars)


def fold_planes(a_bits: torch.Tensor, w_eff: torch.Tensor) -> torch.Tensor:
    """a_bits [..., 9] +/-1 int8 -> a_fold [9, ...] f32 with
    ``a_fold[i] = sum_k a_bits[..., k] * w_eff[k, i]``.  The 9-term sum is
    exact in float64 (w_eff is float64) and rounds once to f32: every
    padded row of a tile carries the same a_fold value, so its rounding
    error adds up over hundreds of rows, and a correctly rounded value
    keeps it smallest."""
    w64 = w_eff.to(torch.float64)
    shape = (-1,) + (1,) * (a_bits.ndim - 1)
    a_fold = a_bits[..., 0].to(torch.float64) * w64[0].reshape(shape)
    for k in range(1, a_bits.shape[-1]):
        a_fold = a_fold + a_bits[..., k].to(torch.float64) * w64[k].reshape(
            shape)
    return a_fold.to(torch.float32)


def cim_macro_matmul(a_int8: torch.Tensor, w_int8: torch.Tensor, chip,
                     v_fs_mac, cfg, *, relu: bool = True) -> torch.Tensor:
    """[B, K] x [K, N] int8 on the macro: per row tile of ``cfg.rows``, one
    caat_mac launch (one conversion per output), codes summed in int32;
    ReLU fused per tile when the reduction fits one tile, else applied
    after the sum.  Returns int32 codes [B, N]."""
    b, k = a_int8.shape
    n = w_int8.shape[1]
    dev = a_int8.device
    rows = cfg.rows
    n_tiles = -(-k // rows)
    pad_k = n_tiles * rows - k
    w_eff, tree_off = caat_lib.effective_linear_weights(chip["caat"])
    a_p = torch.nn.functional.pad(a_int8.to(torch.int32), (0, pad_k))
    w_p = torch.nn.functional.pad(w_int8.to(torch.int32), (0, 0, 0, pad_k))
    a_fold = fold_planes(numerics.encode_pm1(a_p), w_eff)    # [9, B, K']
    w_bits = numerics.encode_pm1(w_p).permute(2, 0, 1).contiguous()
    fused_relu = relu and n_tiles == 1
    v_fs = torch.as_tensor(v_fs_mac, dtype=torch.float32, device=dev)
    scalars = torch.stack([
        torch.tensor(1.0 / rows, dtype=torch.float32, device=dev),
        tree_off.to(device=dev, dtype=torch.float32),
        (rows * cfg.act_sum * cfg.w_sum) / v_fs,
        torch.tensor(1.0 if fused_relu else 0.0, device=dev)])
    acc = torch.zeros((b, n), dtype=torch.int32, device=dev)
    for t in range(n_tiles):
        sl = slice(t * rows, (t + 1) * rows)
        acc = acc + caat_mac(a_fold[:, :, sl], w_bits[:, sl], scalars)
    if relu and not fused_relu:
        acc = torch.clamp_min(acc, 0)
    return acc
