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
// Design (simple first): the int8 tile machinery of int8_tiles.cuh (64x64
// output tiles, 4 warps of 32x32, K in steps of 64 through shared memory,
// mma.sync.m16n8k32 s8 x s8 -> s32).  The f32 -> int8 prologue
// quantization happens on the A-tile load, and the epilogue runs in
// registers, so neither the f32 activation's int8 copy nor the int32
// accumulator ever reaches device memory.  Ragged M/N/K edges are masked
// in the tile loads (at byte granularity where K or N is not a multiple
// of 4, e.g. VGG-8's conv1 K = 27 and head N = 10) and in the epilogue.
// No pipelining, no TMA, no wgmma yet: those come with tuning.
//
// Bit-exactness with the plain PyTorch version: int32 sums do not depend
// on order; the epilogue uses __fmul_rn/__fadd_rn/__fdiv_rn so nothing is
// contracted into an FMA or turned into a reciprocal multiply, and rintf
// rounds half to even like torch.round.

#include "int8_tiles.cuh"

namespace {

using namespace repro::i8;

__device__ __forceinline__ int quant_a(float a, float s) {
  float q = rintf(__fdiv_rn(a, s));
  q = fminf(fmaxf(q, -128.f), 127.f);
  return (int)q;
}

struct Identity {
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const {
    return v;
  }
};

// f32 A tile quantized to int8 on its way into sA [m][k].
__device__ __forceinline__ void load_a_tile_f32(int8_t* sA, const float* a,
                                                float as, int m0, int k0,
                                                int M, int K) {
  const bool vec = (K & 3) == 0;
  for (int i = threadIdx.x; i < BM * (BK / 4); i += THREADS) {
    const int r = i / (BK / 4), c4 = (i % (BK / 4)) * 4;
    const int gm = m0 + r, gk = k0 + c4;
    uint32_t packed = 0;
    if (gm < M) {
      const float* row = a + (size_t)gm * K;
      if (vec) {
        if (gk < K) {
          const float4 v = *reinterpret_cast<const float4*>(row + gk);
          packed = pack4(quant_a(v.x, as), quant_a(v.y, as),
                         quant_a(v.z, as), quant_a(v.w, as));
        }
      } else {
        int q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          q[j] = gk + j < K ? quant_a(row[gk + j], as) : 0;
        packed = pack4(q[0], q[1], q[2], q[3]);
      }
    }
    *reinterpret_cast<uint32_t*>(sA + r * SROW + c4) = packed;
  }
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
    if (F32_IN)
      load_a_tile_f32(sA, static_cast<const float*>(a), as, m0, k0, M, K);
    else
      load_a_tile(sA, static_cast<const int8_t*>(a), m0, k0, M, K,
                  Identity());
    load_w_tile(sB, w, k0, n0, K, N);
    __syncthreads();
    mma_slab(acc, sA, sB, wm, wn, g, t);
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
