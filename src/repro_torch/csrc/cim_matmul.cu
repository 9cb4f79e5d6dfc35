// Fused single-conversion W8A8 matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cim_matmul_kernel`
// (src/repro/kernels/cim_matmul/kernel.py, body `_kernel`):
//   out = epilogue(A[M,K] . W[K,N]) with int32 accumulation, where A is int8
//   or f32 (quantized in the prologue as clip(rint(a / a_scale), -128, 127))
//   and the epilogue runs once per output: acc * (a_scale * w_scale[n]),
//   + bias[n], optional ReLU, optional requant clip(rint(y / out_scale)).
//
// What bounds it on this card: at decode (M <= 8) every int8 weight byte is
// read once and used M times, so the kernel is bound by device-memory
// bytes (K*N weight bytes over 3.35 TB/s); at prefill (M = 64..512) the
// int8 tensor-core rate starts to matter.
//
// Design (simple first): 64x64 output tiles, 4 warps of 32x32, K in steps
// of 64 through shared memory, int8 tensor cores through
// mma.sync.m16n8k32 (s8 x s8 -> s32).  The W tile is transposed into a
// K-contiguous [n][k] layout on its way into shared memory so that both
// operand fragments are single 32-bit shared loads; rows are padded to 80
// bytes so fragment reads are bank-conflict free.  The f32 -> int8
// prologue quantization happens on the A-tile load, and the epilogue runs
// in registers, so neither the f32 activation's int8 copy nor the int32
// accumulator ever reaches device memory.  Ragged M/N/K edges are masked
// in the tile loads and the epilogue (K and N must be multiples of 4).
// No pipelining, no TMA, no wgmma yet: those come with tuning.
//
// Bit-exactness with the plain PyTorch version: int32 sums do not depend
// on order; the epilogue uses __fmul_rn/__fadd_rn/__fdiv_rn so nothing is
// contracted into an FMA or turned into a reciprocal multiply, and rintf
// rounds half to even like torch.round.

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int THREADS = 128;       // 4 warps: 2 along M x 2 along N
constexpr int SROW = BK + 16;      // shared row pitch in bytes

__device__ __forceinline__ int quant_a(float a, float s) {
  float q = rintf(__fdiv_rn(a, s));
  q = fminf(fmaxf(q, -128.f), 127.f);
  return (int)q;
}

__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return (uint32_t)(b0 & 0xff) | ((uint32_t)(b1 & 0xff) << 8) |
         ((uint32_t)(b2 & 0xff) << 16) | ((uint32_t)(b3 & 0xff) << 24);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool F32_IN, bool RELU, bool REQUANT>
__global__ void __launch_bounds__(THREADS)
cim_matmul_kernel(const void* __restrict__ a, const int8_t* __restrict__ w,
                  const float* __restrict__ a_scale,
                  const float* __restrict__ w_scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ out_scale,
                  void* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[BM * SROW];   // [m][k]
  __shared__ __align__(16) int8_t sB[BN * SROW];   // [n][k] (transposed W)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float as = *a_scale;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: 4-byte groups along K (K % 4 == 0: a group is all in or out).
    for (int i = tid; i < BM * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4), c4 = (i % (BK / 4)) * 4;
      const int gm = m0 + r, gk = k0 + c4;
      uint32_t packed = 0;
      if (gm < M && gk < K) {
        if (F32_IN) {
          const float4 v = *reinterpret_cast<const float4*>(
              static_cast<const float*>(a) + (size_t)gm * K + gk);
          packed = pack4(quant_a(v.x, as), quant_a(v.y, as),
                         quant_a(v.z, as), quant_a(v.w, as));
        } else {
          packed = *reinterpret_cast<const uint32_t*>(
              static_cast<const int8_t*>(a) + (size_t)gm * K + gk);
        }
      }
      *reinterpret_cast<uint32_t*>(sA + r * SROW + c4) = packed;
    }
    // W tile: 4x4-byte micro-tiles, transposed to K-contiguous columns.
    for (int i = tid; i < (BK / 4) * (BN / 4); i += THREADS) {
      const int kq = i / (BN / 4), nq = i % (BN / 4);
      const int gk = k0 + kq * 4, gn = n0 + nq * 4;
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = (gk + j < K && gn < N)
                   ? *reinterpret_cast<const uint32_t*>(
                         w + (size_t)(gk + j) * N + gn)
                   : 0u;
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
      const uint32_t col[4] = {
          __byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
          __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(sB + (nq * 4 + j) * SROW + kq * 4) =
            col[j];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* base = sA + (wm * 32 + mi * 16 + g) * SROW + kk + t * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * SROW);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * SROW + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* base = sB + (wn * 32 + ni * 8 + g) * SROW + kk + t * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // Epilogue: THE single conversion, in the reference's operation order.
  const float os = REQUANT ? *out_scale : 1.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm * 32 + mi * 16 + g + (c >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + ni * 8 + t * 2 + (c & 1);
        if (row >= M || col >= N) continue;
        float y = __fmul_rn(__int2float_rn(acc[mi][ni][c]),
                            __fmul_rn(as, w_scale[col]));
        y = __fadd_rn(y, bias[col]);
        if (RELU) y = (y < 0.f) ? 0.f : y;
        const size_t o = (size_t)row * N + col;
        if (REQUANT) {
          float q = rintf(__fdiv_rn(y, os));
          q = fminf(fmaxf(q, -128.f), 127.f);
          static_cast<int8_t*>(out)[o] = (int8_t)(int)q;
        } else {
          static_cast<float*>(out)[o] = y;
        }
      }
}

template <bool F32_IN, bool RELU, bool REQUANT>
cudaError_t launch(const void* a, const void* w, const void* a_scale,
                   const void* w_scale, const void* bias,
                   const void* out_scale, void* out, int M, int N, int K,
                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cim_matmul_kernel<F32_IN, RELU, REQUANT><<<grid, THREADS, 0, stream>>>(
      a, static_cast<const int8_t*>(w), static_cast<const float*>(a_scale),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<const float*>(out_scale), out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cim_matmul_launch(const void* a, int a_is_f32, const void* w,
                                 const void* a_scale, const void* w_scale,
                                 const void* bias, const void* out_scale,
                                 void* out, int M, int N, int K, int relu,
                                 int requant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sel = (a_is_f32 ? 4 : 0) | (relu ? 2 : 0) | (requant ? 1 : 0);
  cudaError_t e;
  switch (sel) {
    case 0: e = launch<false, false, false>(a, w, a_scale, w_scale, bias, out_scale, out, M, N, K, s); break;
    case 1: e = launch<false, false, true>(a, w, a_scale, w_scale, bias, out_scale, out, M, N, K, s); break;
    case 2: e = launch<false, true, false>(a, w, a_scale, w_scale, bias, out_scale, out, M, N, K, s); break;
    case 3: e = launch<false, true, true>(a, w, a_scale, w_scale, bias, out_scale, out, M, N, K, s); break;
    case 4: e = launch<true, false, false>(a, w, a_scale, w_scale, bias, out_scale, out, M, N, K, s); break;
    case 5: e = launch<true, false, true>(a, w, a_scale, w_scale, bias, out_scale, out, M, N, K, s); break;
    case 6: e = launch<true, true, false>(a, w, a_scale, w_scale, bias, out_scale, out, M, N, K, s); break;
    default: e = launch<true, true, true>(a, w, a_scale, w_scale, bias, out_scale, out, M, N, K, s); break;
  }
  return (int)e;
}
