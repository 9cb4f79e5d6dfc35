// Shared int8 GEMM tile machinery of the W8A8 matmul (cim_matmul.cu) and
// the bit-plane matmul (bitplane_matmul.cu): 64x64 output tiles, 4 warps
// of 32x32, K in steps of 64 through shared memory, int8 tensor cores via
// mma.sync.m16n8k32 (s8 x s8 -> s32).
//
// The W tile is transposed into a K-contiguous [n][k] layout on its way
// into shared memory so both operand fragments are single 32-bit shared
// loads; rows are padded to 80 bytes so fragment reads are bank-conflict
// free.  Every load masks the ragged M/N/K edges at byte granularity: a
// row whose length is a multiple of 4 is read four bytes at a time, any
// other row byte by byte (K = 27 and N = 10 occur in VGG-8), so no
// operand has to be padded in device memory.
#pragma once

#include "common.cuh"

namespace repro {
namespace i8 {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int THREADS = 128;       // 4 warps: 2 along M x 2 along N
constexpr int SROW = BK + 16;      // shared row pitch in bytes

__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return (uint32_t)(b0 & 0xff) | ((uint32_t)(b1 & 0xff) << 8) |
         ((uint32_t)(b2 & 0xff) << 16) | ((uint32_t)(b3 & 0xff) << 24);
}

// Bytes c..c+3 of a row of `len` int8 values, zero past the end.  `vec`:
// len % 4 == 0 (with a 4-byte aligned base every group is aligned and
// wholly inside or outside the row).
__device__ __forceinline__ uint32_t load4(const int8_t* row, int c, int len,
                                          bool vec) {
  if (vec) return c < len ? *reinterpret_cast<const uint32_t*>(row + c) : 0u;
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < len) r |= (uint32_t)(uint8_t)row[c + j] << (8 * j);
  return r;
}

// A tile [BM x BK] of row-major int8 A [M, K] into sA [m][k]; `op` maps
// each packed group of four bytes (the bit-plane kernel extracts a plane
// there; zero bytes must map to zero bytes).
template <typename Op>
__device__ __forceinline__ void load_a_tile(int8_t* sA, const int8_t* a,
                                            int m0, int k0, int M, int K,
                                            Op op) {
  const bool vec = (K & 3) == 0;
  for (int i = threadIdx.x; i < BM * (BK / 4); i += THREADS) {
    const int r = i / (BK / 4), c4 = (i % (BK / 4)) * 4;
    const int gm = m0 + r;
    const uint32_t packed =
        gm < M ? op(load4(a + (size_t)gm * K, k0 + c4, K, vec)) : 0u;
    *reinterpret_cast<uint32_t*>(sA + r * SROW + c4) = packed;
  }
}

// W tile [BK x BN] of row-major int8 W [K, N], as 4x4-byte micro-tiles
// transposed into sB [n][k].
__device__ __forceinline__ void load_w_tile(int8_t* sB, const int8_t* w,
                                            int k0, int n0, int K, int N) {
  const bool vec = (N & 3) == 0;
  for (int i = threadIdx.x; i < (BK / 4) * (BN / 4); i += THREADS) {
    const int kq = i / (BN / 4), nq = i % (BN / 4);
    const int gk = k0 + kq * 4, gn = n0 + nq * 4;
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = gk + j < K ? load4(w + (size_t)(gk + j) * N, gn, N, vec) : 0u;
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
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One BK slab of the warp's 32x32 sub-tile: acc[mi][ni] holds the m16n8
// fragment (rows wm*32 + mi*16 + g (+8), cols wn*32 + ni*8 + 2t (+1)).
__device__ __forceinline__ void mma_slab(int (&acc)[2][4][4],
                                         const int8_t* sA, const int8_t* sB,
                                         int wm, int wn, int g, int t) {
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
}

}  // namespace i8
}  // namespace repro
