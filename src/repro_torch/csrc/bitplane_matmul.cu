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
// Design (simple first): K1's tile machinery (int8_tiles.cuh: 64x64 tiles,
// mma.sync.m16n8k32 s8 -> s32, byte-granular masks for ragged M/N/K such
// as conv1's K = 27).  The plane is extracted on the A-tile load, four
// bytes at a time: ((packed >> p) & 0x01010101) keeps bit p of each byte.
// The int32 accumulators are stored as they are, with no epilogue.

#include "int8_tiles.cuh"

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
