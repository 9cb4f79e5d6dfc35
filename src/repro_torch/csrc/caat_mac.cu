// Behavioural CAAT macro tile for Hopper (sm_90a): the analog MAC of one
// 1152-row macro invocation with the chip's sampled capacitor mismatch,
// then its single ideal ADC conversion and fused ReLU.
//
// Replaces the Pallas TPU kernel `caat_mac_kernel`
// (src/repro/kernels/caat_mac/kernel.py, body `_kernel`):
//   acc[b,n] = sum_{p<9} sum_{r<R} a_fold[p,b,r] * w_bits[p,r,n]   (-> f32)
//   code     = clip(rint((acc * inv_m + off) * fs_ratio * 128), -128, 127),
//              ReLU'd when scalars[3] > 0, stored as int32,
// where a_fold holds the activation's +/-1 bit planes with the tree's
// effective weights W_eff folded in (9 planes instead of 81, folded by the
// wrapper) and w_bits the weights' +/-1 bit planes as int8.
//
// What bounds it on this card: 2 * 9 * R operations per output on data
// that is mostly re-read from shared memory; at conv2 (B = 32768, R =
// 1152, N = 128) that is 8.7e10 operations (1.3 ms at the 67 TFLOP/s f32
// CUDA-core rate) against 1.36 GB of f32 a_fold (0.41 ms at 3.35 TB/s), so
// the arithmetic rate bounds it.
//
// Design (simple first): one block per 64x64 (B, N) output tile, 256
// threads each holding a 4x4 register tile; the 9 planes and the R rows
// stream through shared memory 32 rows at a time (a_fold transposed to
// [r][b], both operands widened to float64 there).  The sum runs in
// float64 FMAs on the CUDA cores and rounds to f32 once.  Its error
// (~1e-16 relative) is far below f32 resolution, so the f32 result does
// not depend on the order of the sum and equals the plain PyTorch
// version's float64 matmuls bit for bit, barring a tie within 2^-53 of an
// f32 rounding boundary.  An f32 sum (in any order, let alone TF32) would
// move codes by one wherever v * 128 lands within its rounding of a .5
// boundary -- up to ~1e-3 of VGG-8's outputs, mostly in padded row tiles
// whose identical rows round coherently.  The
// float64 rate is half the f32 rate; speed is later work.  The convert
// epilogue runs in registers with __fmul_rn/__fadd_rn (no FMA
// contraction) and rintf (half to even, like torch.round).  The +/-1
// structure of w_bits is kept as data, as the TPU kernel takes it;
// exploiting it (add/subtract, or int8 tensor cores on the 81 exact
// plane counts) is later work.  Operands are read through strides, so
// the wrapper passes one row tile's view of the [9, B, K'] and [9, K', N]
// planes without copying it.

#include "common.cuh"

namespace {

constexpr int TB = 64, TN = 64, TR = 32;
constexpr int THREADS = 256;       // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
caat_mac_kernel(const float* __restrict__ a, long long a_plane_stride,
                long long a_row_stride, const int8_t* __restrict__ w,
                long long w_plane_stride, const float* __restrict__ scalars,
                int32_t* __restrict__ out, int B, int R, int N, int P) {
  __shared__ __align__(16) double sA[TR][TB + 2];   // [r][b]
  __shared__ __align__(16) double sW[TR][TN];       // [r][n]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b0 = blockIdx.y * TB, n0 = blockIdx.x * TN;

  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;

  for (int p = 0; p < P; ++p) {
    const float* ap = a + (size_t)p * a_plane_stride;
    const int8_t* wp = w + (size_t)p * w_plane_stride;
    for (int r0 = 0; r0 < R; r0 += TR) {
      for (int i = threadIdx.x; i < TB * TR; i += THREADS) {
        const int bb = i / TR, rr = i % TR;
        const int gb = b0 + bb, gr = r0 + rr;
        sA[rr][bb] = (gb < B && gr < R)
                         ? (double)ap[(size_t)gb * a_row_stride + gr]
                         : 0.0;
      }
      for (int i = threadIdx.x; i < TR * TN; i += THREADS) {
        const int rr = i / TN, nn = i % TN;
        const int gr = r0 + rr, gn = n0 + nn;
        sW[rr][nn] =
            (gr < R && gn < N) ? (double)wp[(size_t)gr * N + gn] : 0.0;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < TR; ++kk) {
        const double2 a01 = *reinterpret_cast<const double2*>(&sA[kk][ty * 4]);
        const double2 a23 =
            *reinterpret_cast<const double2*>(&sA[kk][ty * 4 + 2]);
        const double2 w01 = *reinterpret_cast<const double2*>(&sW[kk][tx * 4]);
        const double2 w23 =
            *reinterpret_cast<const double2*>(&sW[kk][tx * 4 + 2]);
        const double a4[4] = {a01.x, a01.y, a23.x, a23.y};
        const double w4[4] = {w01.x, w01.y, w23.x, w23.y};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fma(a4[i], w4[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // The single conversion, in the reference's operation order.
  const float inv_m = scalars[0], off = scalars[1], fs_ratio = scalars[2];
  const bool relu = scalars[3] > 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (b >= B || n >= N) continue;
      const float sum = __double2float_rn(acc[i][j]);
      const float v =
          __fmul_rn(__fadd_rn(__fmul_rn(sum, inv_m), off), fs_ratio);
      float code = rintf(__fmul_rn(v, 128.f));
      code = fminf(fmaxf(code, -128.f), 127.f);
      if (relu) code = fmaxf(code, 0.f);
      out[(size_t)b * N + n] = (int32_t)code;
    }
}

}  // namespace

extern "C" int caat_mac_launch(const void* a_fold, long long a_plane_stride,
                               long long a_row_stride, const void* w_bits,
                               long long w_plane_stride, const void* scalars,
                               void* out, int B, int R, int N, int P,
                               void* stream) {
  dim3 grid((N + TN - 1) / TN, (B + TB - 1) / TB);
  caat_mac_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a_fold), a_plane_stride, a_row_stride,
      static_cast<const int8_t*>(w_bits), w_plane_stride,
      static_cast<const float*>(scalars), static_cast<int32_t*>(out), B, R,
      N, P);
  return (int)cudaGetLastError();
}
