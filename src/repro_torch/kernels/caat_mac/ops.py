"""Full CiM matmul on the CAAT macro-tile kernel (port of
``repro/kernels/caat_mac/ops.py``).

:func:`cim_macro_matmul` mirrors ``core.macro.cim_matmul_sim`` (row tiling
+ digital accumulation) but runs each row tile through :func:`caat_mac`:
the CUDA kernel ``csrc/caat_mac.cu`` on a CUDA tensor, its plain PyTorch
version :func:`caat_mac_plain` on a CPU tensor (a CUDA tensor never takes
the plain path).  The ADC is the ideal quantizer here (no INL), as in the
reference.

One row tile of R rows computes, from int8 activations ``a [B, R]`` and
the weights' +/-1 bit planes ``w_i [R, N]``,

    count[k, i] = sum_r a_k[r] * w_i[r]        (exact integers, |.| <= R)
    acc         = sum_k sum_i W_eff[k, i] * count[k, i]   (float64)

with ``a_k`` the +/-1 planes of ``encode_pm1`` and W_eff the tree's
effective linear weights (``core.caat.effective_linear_weights``), then
rounds acc once to f32 and converts it.  ``encode_pm1`` is offset binary:
with ``u = a + 128``, plane k < 7 is bit 7 - k of u, plane 7 is bit 0 and
plane 8 is always -1.  So only the 8 x 8 products of the real planes are
computed; the constant plane gives ``count[k, 8] = -sum_r a_k[r]`` (a row
sum of the activation plane), ``count[8, i] = -sum_r w_i[r]`` (a column
sum of the weight plane, made once per call) and ``count[8, 8] = R``.

The 81 terms are combined k outer, i inner, every multiply and add
rounded on its own (no FMA), in the kernel and in the plain version
alike, so the two give equal codes.  This is the TPU kernel's function
composed with its wrapper's W_eff fold, taken exactly; the JAX package
folds into f32 planes first, so a code may differ from JAX's by one where
v * 128 lies within that rounding of a .5 boundary.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import caat as caat_lib
from repro_torch.kernels import build

# Launches of the CUDA kernel (plain integer; reset it to 0 before a run).
launches = 0

COLS = 16          # weight columns per group of the packed planes
MAX_ROWS = 1472    # the kernel keeps a tile's 128 x R activations resident


def pm1_planes(x: torch.Tensor) -> torch.Tensor:
    """int8 [...] -> the 8 non-constant +/-1 planes of ``encode_pm1``,
    int8 [8, ...], by the offset-binary bit rule the kernel uses."""
    u = x.to(torch.int16) + 128
    shifts = [7 - k for k in range(7)] + [0]
    return torch.stack([((u >> s) & 1) * 2 - 1 for s in shifts]).to(
        torch.int8)


def pack_weight_planes(w: torch.Tensor, rows: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 [T * rows, N] -> the kernel's weight operands for each of the T
    row tiles: ``w_planes`` int8 [T, G, 8, COLS, rows] (G = ceil(N / COLS);
    row i * COLS + c of group g is plane i of column g * COLS + c, K-major,
    columns past N zero) and ``w_sum`` int32 [T, 8, N], each plane's sum
    over the tile's rows."""
    k, n = w.shape
    t, g = k // rows, -(-n // COLS)
    bits = pm1_planes(w).reshape(8, t, rows, n)
    w_sum = bits.sum(2, dtype=torch.int32).permute(1, 0, 2)
    bits = torch.nn.functional.pad(bits, (0, g * COLS - n))
    planes = bits.reshape(8, t, rows, g, COLS).permute(1, 3, 0, 4, 2)
    return planes.contiguous(), w_sum.contiguous()


def caat_mac_plain(a: torch.Tensor, w_planes: torch.Tensor,
                   w_sum: torch.Tensor, w_eff: torch.Tensor,
                   scalars: torch.Tensor) -> torch.Tensor:
    """One macro row tile.  a int8 [B, R]; w_planes int8 [G, 8, COLS, R]
    and w_sum int32 [8, N] from :func:`pack_weight_planes`; w_eff float64
    [9, 9]; scalars [4] f32 = (inv_m, tree offset, fs_ratio, relu flag).
    Returns int32 codes [B, N]: ``clip(round((acc * inv_m + off) *
    fs_ratio * 128), -128, 127)``, ReLU'd when the flag is > 0, with acc
    the float64 combine of the module docstring rounded once to f32.  The
    counts come from float64 matmuls of +/-1 values, exact below
    2**53."""
    b, r = a.shape
    n = w_sum.shape[1]
    f64 = torch.float64
    w = w_planes.permute(3, 1, 0, 2).reshape(r, 8, -1)[:, :, :n]
    w = w.reshape(r, 8 * n).to(f64)                        # [R, (i, n)]
    planes = pm1_planes(a)
    coef = w_eff.tolist()
    acc = torch.zeros((b, n), dtype=f64, device=a.device)
    for k in range(9):
        if k < 8:
            a_k = planes[k].to(f64)
            count = (a_k @ w).reshape(b, 8, n)
            row = -a_k.sum(1, keepdim=True)
        for i in range(9):
            if k < 8:
                c = count[:, i] if i < 8 else row
            else:
                c = -w_sum[i].to(f64) if i < 8 else float(r)
            acc = acc + coef[k][i] * c
    v = (acc.to(torch.float32) * scalars[0] + scalars[1]) * scalars[2]
    code = torch.clamp(torch.round(v * 128.0), -128, 127)
    code = torch.where(scalars[3] > 0, torch.clamp_min(code, 0.0), code)
    return code.to(torch.int32)


@functools.cache
def _fn():
    fn = build.library("caat_mac").caat_mac_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def caat_mac_kernel(a: torch.Tensor, w_planes: torch.Tensor,
                    w_sum: torch.Tensor, w_eff: torch.Tensor,
                    scalars: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; same arguments and result as
    :func:`caat_mac_plain`.  ``a`` may be a strided view (one row tile of
    the padded activations) with a contiguous last axis and rows starting
    16-byte aligned; R must be a multiple of 16 and at most MAX_ROWS.
    Raises on anything it does not take."""
    global launches
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"caat_mac_kernel needs CUDA tensors, got {dev}")
    if (a.dtype != torch.int8 or w_planes.dtype != torch.int8
            or w_sum.dtype != torch.int32 or w_eff.dtype != torch.float64
            or scalars.dtype != torch.float32):
        raise TypeError("need int8 a and w_planes, int32 w_sum, float64 "
                        f"w_eff, f32 scalars; got {a.dtype}, "
                        f"{w_planes.dtype}, {w_sum.dtype}, {w_eff.dtype}, "
                        f"{scalars.dtype}")
    if a.ndim != 2 or w_sum.ndim != 2 or w_sum.shape[0] != 8:
        raise ValueError("need a [B, R] and w_sum [8, N]")
    b, r = a.shape
    n = w_sum.shape[1]
    if r % 16 or not 0 < r <= MAX_ROWS:
        raise ValueError(f"rows must be a multiple of 16 in [16, "
                         f"{MAX_ROWS}], got {r}")
    if tuple(w_planes.shape) != (-(-n // COLS), 8, COLS, r):
        raise ValueError(f"w_planes {tuple(w_planes.shape)} does not match "
                         f"R={r}, N={n}")
    if tuple(w_eff.shape) != (9, 9) or scalars.numel() != 4:
        raise ValueError("need w_eff [9, 9] and scalars [4]")
    if a.stride(1) != 1 or a.stride(0) % 16 or a.data_ptr() % 16:
        raise ValueError("a needs a contiguous last axis and 16-byte "
                         "aligned rows")
    if not all(t.is_contiguous() for t in (w_planes, w_sum, w_eff, scalars)):
        raise ValueError("w_planes, w_sum, w_eff and scalars must be "
                         "contiguous")
    for t in (w_planes, w_sum, w_eff, scalars):
        if t.device != dev:
            raise ValueError("kernel operands must share one device")
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return out
    rc = _fn()(a.data_ptr(), a.stride(0), w_planes.data_ptr(),
               w_sum.data_ptr(), w_eff.data_ptr(), scalars.data_ptr(),
               out.data_ptr(), b, r, n,
               torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "caat_mac")
    launches += 1
    return out


def caat_mac(a, w_planes, w_sum, w_eff, scalars) -> torch.Tensor:
    """One row tile: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if a.device.type == "cpu":
        return caat_mac_plain(a, w_planes, w_sum, w_eff, scalars)
    return caat_mac_kernel(a, w_planes, w_sum, w_eff, scalars)


def tile_operands(a_int8: torch.Tensor, w_int8: torch.Tensor, chip,
                  v_fs_mac, cfg, *, relu: bool = True):
    """The operands of :func:`cim_macro_matmul`'s launches, made once per
    call: ``(tiles, w_eff, scalars)`` with ``tiles`` one ``(a, w_planes,
    w_sum)`` per row tile of ``cfg.rows`` (``a`` a strided view of the
    zero-padded int8 activations).  No activation plane is built."""
    k = a_int8.shape[1]
    dev = a_int8.device
    rows = cfg.rows
    n_tiles = -(-k // rows)
    pad_k = n_tiles * rows - k
    w_eff, tree_off = caat_lib.effective_linear_weights(chip["caat"])
    a_p = a_int8.to(torch.int8).contiguous()
    w_p = w_int8.to(torch.int8)
    if pad_k:
        a_p = torch.nn.functional.pad(a_p, (0, pad_k))
        w_p = torch.nn.functional.pad(w_p, (0, 0, 0, pad_k))
    w_planes, w_sum = pack_weight_planes(w_p, rows)
    v_fs = torch.as_tensor(v_fs_mac, dtype=torch.float32, device=dev)
    scalars = torch.stack([
        torch.tensor(1.0 / rows, dtype=torch.float32, device=dev),
        tree_off.to(device=dev, dtype=torch.float32),
        (rows * cfg.act_sum * cfg.w_sum) / v_fs,
        torch.tensor(1.0 if relu and n_tiles == 1 else 0.0, device=dev)])
    tiles = [(a_p[:, t * rows:(t + 1) * rows], w_planes[t], w_sum[t])
             for t in range(n_tiles)]
    return tiles, w_eff.to(device=dev, dtype=torch.float64).contiguous(), \
        scalars


def cim_macro_matmul(a_int8: torch.Tensor, w_int8: torch.Tensor, chip,
                     v_fs_mac, cfg, *, relu: bool = True) -> torch.Tensor:
    """[B, K] x [K, N] int8 on the macro: per row tile of ``cfg.rows``, one
    caat_mac launch (one conversion per output), codes summed in int32;
    ReLU fused per tile when the reduction fits one tile, else applied
    after the sum.  Returns int32 codes [B, N]."""
    tiles, w_eff, scalars = tile_operands(a_int8, w_int8, chip, v_fs_mac,
                                          cfg, relu=relu)
    acc = torch.zeros((a_int8.shape[0], w_int8.shape[1]), dtype=torch.int32,
                      device=a_int8.device)
    for tile in tiles:
        acc = acc + caat_mac(*tile, w_eff, scalars)
    if relu and len(tiles) > 1:
        acc = torch.clamp_min(acc, 0)
    return acc
