// Fused single-conversion W8A8 matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cim_matmul_kernel`
// (src/repro/kernels/cim_matmul/kernel.py, body `_kernel`):
//   out = epilogue(A[M,K] . W[K,N]) with int32 accumulation, where A is int8
//   or f32 (quantized as clip(rint(a / a_scale), -128, 127)) and the
//   epilogue runs once per output: acc * (a_scale * w_scale[n]), + bias[n],
//   optional ReLU, optional requant clip(rint(y / out_scale)).
//
// What bounds it on this card: at decode (M <= 16) every int8 weight byte
// is read once and used M times, so device-memory bytes bound it (K*N
// weight bytes over 3.35 TB/s); at prefill (M = 64..512) the int8
// tensor-core rate starts to matter.
//
// Two kernels, chosen by shape in Python (kernels/autotune.py,
// cim_matmul_config):
// - cim_wgmma_kernel, every shape whose K and N are multiples of 16 (all
//   serving shapes): the ring / wgmma / cluster split-K machinery of
//   int8_wgmma.cuh with the operands swapped (W^T from registers,
//   activations from shared memory).  Decode takes 64-column tiles and
//   8 or 16 tokens, and enough split-K blocks per cluster that even k/v
//   fills the card; prefill takes 128-column x 64- or 128-token tiles.  An
//   f32 input is quantized ONCE per launch by cim_quant_kernel into an int8
//   scratch the wrapper allocates (not once per column tile).  The
//   split-K partials are summed in distributed shared memory, and the
//   epilogue runs once, in registers, storing 8 or 16 bytes a thread: the
//   int32 accumulators never reach device memory.
// - cim_matmul_kernel (the first design), for rows 16-byte copies
//   cannot describe (VGG-8's conv1 K = 27, head N = 10): the
//   int8_tiles.cuh tiles with byte-granular edge masks and the
//   quantization on the A-tile load.
//
// Bit-exactness with the plain PyTorch version: int32 sums do not depend
// on order; the epilogue and the quantization use __fmul_rn/__fadd_rn/
// __fdiv_rn so nothing is contracted into an FMA or turned into a
// reciprocal multiply, and rintf rounds half to even like torch.round.

#include <algorithm>

#include "int8_tiles.cuh"
#include "int8_wgmma.cuh"

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

// ---------------------------------------------------------------------------
// The wgmma path
// ---------------------------------------------------------------------------

namespace {

namespace wg = repro::wg;

// f32 activations -> int8 codes, four a thread per step (K % 16 == 0).
__global__ void __launch_bounds__(256)
cim_quant_kernel(const float* __restrict__ a, const float* __restrict__ a_scale,
             int8_t* __restrict__ q, size_t n4) {
  const float as = *a_scale;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(a)[i];
    reinterpret_cast<uint32_t*>(q)[i] =
        pack4(quant_a(v.x, as), quant_a(v.y, as), quant_a(v.z, as),
              quant_a(v.w, as));
  }
}

// THE single conversion of 2 * NT adjacent outputs of one token.
template <int NT, bool RELU, bool REQUANT>
struct CimEpilogue {
  const float* w_scale;
  const float* bias;
  float as, os;
  void* out;
  int N;
  __device__ __forceinline__ void operator()(int token, int n,
                                             const int (&v)[2 * NT]) const {
    float y[2 * NT];
#pragma unroll
    for (int q = 0; q < 2 * NT; ++q) {
      y[q] = __fmul_rn(__int2float_rn(v[q]), __fmul_rn(as, w_scale[n + q]));
      y[q] = __fadd_rn(y[q], bias[n + q]);
      if (RELU) y[q] = (y[q] < 0.f) ? 0.f : y[q];
    }
    const size_t o = (size_t)token * N + n;
    if (REQUANT) {
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int q = 0; q < 2 * NT; ++q) {
        float r = rintf(__fdiv_rn(y[q], os));
        c[q] = (int)fminf(fmaxf(r, -128.f), 127.f);
      }
      const uint32_t packed = pack4(c[0], c[1], c[2], c[3]);
      int8_t* dst = static_cast<int8_t*>(out) + o;
      if constexpr (NT == 2)
        *reinterpret_cast<uint32_t*>(dst) = packed;
      else
        *reinterpret_cast<uint16_t*>(dst) = (uint16_t)packed;
    } else {
      float* dst = static_cast<float*>(out) + o;
      if constexpr (NT == 2)
        *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
    }
  }
};

template <int NT, int BT, bool RELU, bool REQUANT>
__global__ void __launch_bounds__(wg::THREADS)
cim_wgmma_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                 const float* __restrict__ a_scale,
                 const float* __restrict__ w_scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ out_scale, void* __restrict__ out,
                 int M, int N, int K, int splits) {
  using T = wg::Tile<NT, BT>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = wg::init_ring<NT, BT>(smem);
  const int m0 = blockIdx.z * BT, n0 = blockIdx.y * T::BN;
  int step0, nsteps;
  wg::split_range(K, blockIdx.x, splits, step0, nsteps);
  int acc[NT][T::ACC];
#pragma unroll
  for (int tl = 0; tl < NT; ++tl)
#pragma unroll
    for (int r = 0; r < T::ACC; ++r) acc[tl][r] = 0;
  wg::mainloop<NT, BT>(acc, smem, bars, a, w, m0, n0, step0, nsteps, M, N,
                       K, wg::NoPass());
  const CimEpilogue<NT, RELU, REQUANT> epi{
      w_scale, bias, *a_scale, REQUANT ? *out_scale : 1.f, out, N};
  wg::finish<NT, BT>(acc, smem, splits, m0, n0, M, N, epi);
}

template <int NT, int BT>
cudaError_t run_wgmma(const int8_t* a, const int8_t* w, const float* as,
                      const float* ws, const float* bias, const float* os,
                      void* out, int M, int N, int K, bool relu,
                      bool requant, int splits, cudaStream_t s) {
#define REPRO_CIM_WGMMA(R, Q)                                               \
  wg::launch<NT, BT>(cim_wgmma_kernel<NT, BT, R, Q>, M, N, splits, s, a, w, \
                     as, ws, bias, os, out, M, N, K, splits)
  if (relu)
    return requant ? REPRO_CIM_WGMMA(true, true) : REPRO_CIM_WGMMA(true, false);
  return requant ? REPRO_CIM_WGMMA(false, true) : REPRO_CIM_WGMMA(false, false);
#undef REPRO_CIM_WGMMA
}

}  // namespace

// The wgmma path: K and N multiples of 16, (nt, bt) one of (1, 8),
// (1, 16), (2, 8), (2, 16), (2, 64), (2, 128), 1 <= splits <= 16 with no
// split empty.  An
// f32 `a` is first quantized into `a_q` (M x K int8 scratch), one launch
// of cim_quant_kernel.
extern "C" int cim_matmul_wgmma_launch(
    const void* a, int a_is_f32, void* a_q, const void* w,
    const void* a_scale, const void* w_scale, const void* bias,
    const void* out_scale, void* out, int M, int N, int K, int relu,
    int requant, int nt, int bt, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a8 = static_cast<const int8_t*>(a);
  if (a_is_f32) {
    const size_t n4 = (size_t)M * K / 4;
    const int blocks = (int)std::min<size_t>((n4 + 255) / 256, 4096);
    cim_quant_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(a),
                                        static_cast<const float*>(a_scale),
                                        static_cast<int8_t*>(a_q), n4);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    a8 = static_cast<const int8_t*>(a_q);
  }
  const int8_t* w8 = static_cast<const int8_t*>(w);
  const float* as = static_cast<const float*>(a_scale);
  const float* ws = static_cast<const float*>(w_scale);
  const float* b = static_cast<const float*>(bias);
  const float* os = static_cast<const float*>(out_scale);
  cudaError_t e;
  if (nt == 1 && bt == 8)
    e = run_wgmma<1, 8>(a8, w8, as, ws, b, os, out, M, N, K, relu, requant, splits, s);
  else if (nt == 1 && bt == 16)
    e = run_wgmma<1, 16>(a8, w8, as, ws, b, os, out, M, N, K, relu, requant, splits, s);
  else if (nt == 2 && bt == 8)
    e = run_wgmma<2, 8>(a8, w8, as, ws, b, os, out, M, N, K, relu, requant, splits, s);
  else if (nt == 2 && bt == 16)
    e = run_wgmma<2, 16>(a8, w8, as, ws, b, os, out, M, N, K, relu, requant, splits, s);
  else if (nt == 2 && bt == 64)
    e = run_wgmma<2, 64>(a8, w8, as, ws, b, os, out, M, N, K, relu, requant, splits, s);
  else if (nt == 2 && bt == 128)
    e = run_wgmma<2, 128>(a8, w8, as, ws, b, os, out, M, N, K, relu, requant, splits, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
