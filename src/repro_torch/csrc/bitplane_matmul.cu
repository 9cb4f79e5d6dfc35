// One activation bit-plane times int8 weights, for Hopper (sm_90a): the
// bit-serial baseline of the paper's prior works.
//
// Replaces the Pallas TPU kernel `bitplane_matmul_kernel`
// (src/repro/kernels/bitserial_matmul/kernel.py, body `_plane_kernel`):
//   out[M,N] (int32) = bits_p(A)[M,K] . W[K,N],  bits_p(a) = (uint8(a) >> p) & 1
// for one two's-complement plane p of the int8 activations.  The wrapper
// launches it once per plane (8 launches) and shift-adds the partial sums
// in f32 outside the kernel, as the TPU package does: the 8 passes over A
// and W, and the 8 int32 partial-sum writes, ARE the interface cost the
// paper's single-conversion design removes, so they are kept, not fused.
//
// What bounds it on this card: each launch reads int8 A and W once and
// writes an int32 [M,N].  At conv2 (M = 32768, K = 1152, N = 128) that is
// ~55 MB against ~9.7 Gop, so device-memory bytes bound it (16 us at
// 3.35 TB/s vs 5 us at the int8 tensor-core peak).
//
// Two kernels, chosen by shape in Python (kernels/autotune.py,
// cim_matmul_config, shared with K1):
// - bitplane_wgmma_kernel, K and N multiples of 16 (conv2 .. head's fc1):
//   int8_wgmma.cuh's ring, wgmma and cluster split-K.  The activations
//   are wgmma's shared-memory operand, so one pass over each landed tile
//   keeps bit p of every byte, ((v >> p) & 0x01010101) on 16-byte words,
//   before it is multiplied.  A block covers 128 weight columns, all of
//   conv2's N, so A is read from device memory once.  The int32 sums are
//   stored 16 bytes a thread.
// - bitplane_matmul_kernel (the first design), for rows 16-byte copies
//   cannot describe (conv1's K = 27, the head's N = 10): int8_tiles.cuh
//   with byte-granular masks, the plane extracted on the A-tile load.

#include "int8_tiles.cuh"
#include "int8_wgmma.cuh"

namespace {

using namespace repro::i8;

struct PlaneBits {
  int p;
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const {
    return (v >> p) & 0x01010101u;
  }
};

__global__ void __launch_bounds__(THREADS)
bitplane_matmul_kernel(const int8_t* __restrict__ a,
                       const int8_t* __restrict__ w, int32_t* __restrict__ out,
                       int M, int N, int K, int plane) {
  __shared__ __align__(16) int8_t sA[BM * SROW];   // [m][k] plane bits
  __shared__ __align__(16) int8_t sB[BN * SROW];   // [n][k] (transposed W)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a_tile(sA, a, m0, k0, M, K, PlaneBits{plane});
    load_w_tile(sB, w, k0, n0, K, N);
    __syncthreads();
    mma_slab(acc, sA, sB, wm, wn, g, t);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm * 32 + mi * 16 + g + (c >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + ni * 8 + t * 2 + (c & 1);
        if (row < M && col < N) out[(size_t)row * N + col] = acc[mi][ni][c];
      }
}

}  // namespace

extern "C" int bitplane_matmul_launch(const void* a, const void* w, void* out,
                                      int M, int N, int K, int plane,
                                      void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bitplane_matmul_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), M, N, K, plane);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wgmma path
// ---------------------------------------------------------------------------

namespace {

namespace wg = repro::wg;

// Keeps bit `p` of every byte of a landed activation tile, in place.
struct PlanePass {
  int p;
  __device__ __forceinline__ void operator()(uint8_t* tile, int bytes) const {
    uint4* v = reinterpret_cast<uint4*>(tile);
    for (int i = threadIdx.x; i < bytes / 16; i += wg::THREADS) {
      uint4 x = v[i];
      x.x = (x.x >> p) & 0x01010101u;
      x.y = (x.y >> p) & 0x01010101u;
      x.z = (x.z >> p) & 0x01010101u;
      x.w = (x.w >> p) & 0x01010101u;
      v[i] = x;
    }
    wg::fence_proxy_async();
    __syncthreads();
  }
};

template <int NT>
struct StoreInt32 {
  int32_t* out;
  int N;
  __device__ __forceinline__ void operator()(int token, int n,
                                             const int (&v)[2 * NT]) const {
    int32_t* dst = out + (size_t)token * N + n;
    if constexpr (NT == 2)
      *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
  }
};

template <int NT, int BT>
__global__ void __launch_bounds__(wg::THREADS)
bitplane_wgmma_kernel(const int8_t* __restrict__ a,
                      const int8_t* __restrict__ w,
                      int32_t* __restrict__ out, int M, int N, int K,
                      int plane, int splits) {
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
                       K, PlanePass{plane});
  wg::finish<NT, BT>(acc, smem, splits, m0, n0, M, N,
                     StoreInt32<NT>{out, N});
}

}  // namespace

// The wgmma path: K and N multiples of 16, (nt, bt) one of (1, 8),
// (1, 16), (2, 8), (2, 16), (2, 64), (2, 128), 1 <= splits <= 16 with no
// split empty.
extern "C" int bitplane_matmul_wgmma_launch(const void* a, const void* w,
                                            void* out, int M, int N, int K,
                                            int plane, int nt, int bt,
                                            int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  int32_t* o = static_cast<int32_t*>(out);
#define REPRO_PLANE_WGMMA(NT, BT)                                        \
  wg::launch<NT, BT>(bitplane_wgmma_kernel<NT, BT>, M, N, splits, s, a8, \
                     w8, o, M, N, K, plane, splits)
  cudaError_t e;
  if (nt == 1 && bt == 8)
    e = REPRO_PLANE_WGMMA(1, 8);
  else if (nt == 1 && bt == 16)
    e = REPRO_PLANE_WGMMA(1, 16);
  else if (nt == 2 && bt == 8)
    e = REPRO_PLANE_WGMMA(2, 8);
  else if (nt == 2 && bt == 16)
    e = REPRO_PLANE_WGMMA(2, 16);
  else if (nt == 2 && bt == 64)
    e = REPRO_PLANE_WGMMA(2, 64);
  else if (nt == 2 && bt == 128)
    e = REPRO_PLANE_WGMMA(2, 128);
  else
    e = cudaErrorInvalidValue;
#undef REPRO_PLANE_WGMMA
  return (int)e;
}
