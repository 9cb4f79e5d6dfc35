// Shared Hopper int8 GEMM machinery of the W8A8 matmul (cim_matmul.cu) and
// the bit-plane matmul (bitplane_matmul.cu): wgmma tiles fed by a ring of
// 16-byte cp.async stages tracked by mbarriers, split-K across a thread
// block cluster reduced through distributed shared memory, and an
// epilogue that stores 8 or 16 bytes a thread.
//
// Operand roles are swapped (out^T = W^T . A^T): for 8-bit types wgmma
// takes only K-major shared-memory operands, and W is stored [K, N]
// (N-major).  So W^T is wgmma's A operand, built in registers from the W
// tile as it lands (a 4x4 byte transpose per 32-bit word group, the trick
// int8_tiles.cuh does on the global load), and the activations [M, K],
// already K-major, are the B operand read from shared memory.  The token
// count becomes wgmma's N (8 or 16 at decode, 64 or 128 at prefill), so
// decode pays for no 64-row padding.  One block is one warpgroup (128
// threads) that both issues the copies and runs the products: a stage is
// refilled as soon as every thread is done with it, so up to STAGES - 1
// stages are in flight while one is multiplied.
//
// Tile geometry (NT = 1 or 2 wgmma row tiles of 64 weight columns, BT
// tokens):
// - W stage: BK = 64 rows of NT * 64 bytes, 16-byte chunks XOR-swizzled by
//   ((row >> 2) & 3) * NT so each fragment load is bank-conflict free.  Thread
//   (warp w, g = lane / 4, t = lane % 4) owns weight columns
//   n0 + 32w + 4g + {0..3} (NT = 2) or n0 + 16w + 2g + {0, 1} (NT = 1);
//   column q of that group is row g + 8 (q & 1) of row tile q >> 1.
// - A stage: BT rows of BK bytes in 8 x 16-byte core matrices, K-adjacent
//   core matrices 128 bytes apart (LBO), 8-row groups 8 * BK apart (SBO),
//   no swizzle.
// Every operand row must start 16-byte aligned: K and N multiples of 16
// (callers route other shapes to int8_tiles.cuh's byte-masked kernel).
// Ragged M, N and K are zero-filled on the copy (cp.async src-size 0).
#pragma once

#include <utility>

#include "common.cuh"

namespace repro {
namespace wg {

constexpr int BK = 64;          // K bytes per ring stage
constexpr int THREADS = 128;    // one warpgroup

// Decode tiles (BT <= 16) hold little per stage, so their ring is deeper.
template <int NT, int BT>
struct Tile {
  static constexpr int BN = 64 * NT;                 // weight columns
  static constexpr int STAGES = BT <= 16 ? 8 : 4;
  static constexpr int W_BYTES = BK * BN;
  static constexpr int A_BYTES = BT * BK;
  static constexpr int STAGE = W_BYTES + A_BYTES;    // a multiple of 512
  static constexpr int RING = STAGES * STAGE;
  static constexpr int ACC = BT / 2;                 // s32 per row tile
  static constexpr int SMEM = RING + 8 * STAGES;     // + full barriers
  static_assert(NT * ACC * THREADS * 4 <= RING,
                "split-K partials reuse the drained ring");
};

// ---- barriers, fences, cluster ------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive on `bar` once all of this thread's earlier cp.async copies land.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for phase `parity` of `bar` to complete.  A phase that never
// completes (a lost arrival) traps after ~2**26 polls, seconds, so a
// fault surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t polls = 0; !mbar_try_wait(bar, parity);)
    if (++polls == (1u << 26)) __trap();
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's view of generic-proxy shared-memory writes (the
// copies, the plane pass) before wgmma's async-proxy reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The int32 at `p` in the shared memory of cluster block `rank`.
__device__ __forceinline__ int ld_dsmem(const int* p, uint32_t rank) {
  uint32_t remote;
  int v;
  // No memory clobber: issued after cluster_sync (a volatile asm with
  // one), independent loads may be in flight together.
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(remote));
  return v;
}

// ---- wgmma ---------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across the async
// products.
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Shared-memory descriptor of a K-major, unswizzled B operand (the A
// stage at byte address `addr`): LBO 128 bytes between K-adjacent core
// matrices, SBO 8 * BK between 8-row groups.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t LBO = 128, SBO = (BK / 16) * 128;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) |
         ((SBO >> 4) << 32);
}

// d[BT / 2] (+)= A[64 x 32] (registers, s8) . B[32 x BT] (descriptor, s8),
// m64nBTk32 with s32 accumulators.
template <int BT>
struct Wgmma;

template <> struct Wgmma<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// ---- the ring ------------------------------------------------------------

template <int NT>
__device__ __forceinline__ int swz(int row) {
  return ((row >> 2) & 3) * NT;
}

// Issue the copies of K step `k0` into stage `st`: W rows k0.. of columns
// n0.. (swizzled) and activation rows m0.. (core-matrix layout).
template <int NT, int BT>
__device__ __forceinline__ void load_stage(uint8_t* st, const int8_t* a,
                                           const int8_t* w, int m0, int n0,
                                           int k0, int M, int N, int K) {
  using T = Tile<NT, BT>;
  constexpr int WCH = T::BN / 16;
#pragma unroll
  for (int j = 0; j < BK * WCH / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / WCH, c = i % WCH;
    const int gk = k0 + r, gn = n0 + c * 16;
    const bool ok = gk < K && gn < N;
    cp_async16(st + r * T::BN + ((c ^ swz<NT>(r)) << 4),
               ok ? w + (size_t)gk * N + gn : w, ok);
  }
  uint8_t* sa = st + T::W_BYTES;
  constexpr int ACH = BK / 16;
  for (int i = threadIdx.x; i < BT * ACH; i += THREADS) {
    const int r = i / ACH, c = i % ACH;
    const int gm = m0 + r, gk = k0 + c * 16;
    const bool ok = gm < M && gk < K;
    cp_async16(sa + (r >> 3) * (ACH * 128) + c * 128 + (r & 7) * 16,
               ok ? a + (size_t)gm * K + gk : a, ok);
  }
}

// 4x4 byte transpose: col[q] byte j = r[j] byte q.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

// W^T fragments of k32 step `kk` for each row tile, in wgmma's register
// A layout: a[tl][0] row g, k 4t..4t+3; [1] row g + 8; [2] row g,
// k 16+4t..; [3] row g + 8, k 16+4t...
template <int NT>
__device__ __forceinline__ void w_frags(uint32_t (&a)[NT][4],
                                        const uint8_t* sw, int kk, int warp,
                                        int g, int t) {
  constexpr int RP = 64 * NT;
  const int nb = NT == 2 ? 32 * warp + 4 * g : 16 * warp + 2 * g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t r[4], col[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kk + 16 * h + 4 * t + j;
      const uint8_t* p = sw + k * RP + (((nb >> 4) ^ swz<NT>(k)) << 4) +
                         (nb & 15);
      r[j] = NT == 2 ? *reinterpret_cast<const uint32_t*>(p)
                     : (uint32_t)*reinterpret_cast<const uint16_t*>(p);
    }
    transpose4(r, col);
#pragma unroll
    for (int tl = 0; tl < NT; ++tl) {
      a[tl][2 * h] = col[2 * tl];
      a[tl][2 * h + 1] = col[2 * tl + 1];
    }
  }
}

// Pass-through for a landed activation tile (K1's int8 codes).
struct NoPass {
  __device__ __forceinline__ void operator()(uint8_t*, int) const {}
};

// acc += W[k-steps step0 .. step0+nsteps) of this block's columns times the
// activation rows m0.., through the ring.  `pass(tile, bytes)` may rewrite
// each landed activation tile in place before it is multiplied (it must
// end with fence_proxy_async() and __syncthreads()).
template <int NT, int BT, typename Pass>
__device__ __forceinline__ void mainloop(int (&acc)[NT][Tile<NT, BT>::ACC],
                                         uint8_t* smem, uint64_t* bars,
                                         const int8_t* a, const int8_t* w,
                                         int m0, int n0, int step0,
                                         int nsteps, int M, int N, int K,
                                         Pass pass) {
  using T = Tile<NT, BT>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < T::STAGES && i < nsteps; ++i) {
    load_stage<NT, BT>(smem + i * T::STAGE, a, w, m0, n0,
                       (step0 + i) * BK, M, N, K);
    mbar_arrive_cp_async(&bars[i]);
  }
  for (int i = 0; i < nsteps; ++i) {
    const int s = i % T::STAGES;
    uint8_t* st = smem + s * T::STAGE;
    mbar_wait(&bars[s], (uint32_t)(i / T::STAGES) & 1u);
    fence_proxy_async();
    pass(st + T::W_BYTES, T::A_BYTES);
    constexpr int KS = BK / 32;   // k32 steps per stage
    uint32_t af[KS][NT][4];
#pragma unroll
    for (int h = 0; h < KS; ++h) w_frags<NT>(af[h], st, 32 * h, warp, g, t);
    const uint32_t sa = smem_u32(st + T::W_BYTES);
#pragma unroll
    for (int tl = 0; tl < NT; ++tl)
#pragma unroll
      for (int r = 0; r < T::ACC; ++r) fence_operand(acc[tl][r]);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < KS; ++h)
#pragma unroll
      for (int tl = 0; tl < NT; ++tl)
        Wgmma<BT>::mma(acc[tl], af[h][tl], b_desc(sa + h * 256));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int tl = 0; tl < NT; ++tl)
#pragma unroll
      for (int r = 0; r < T::ACC; ++r) fence_operand(acc[tl][r]);
    __syncthreads();   // every thread is done with stage s
    if (i + T::STAGES < nsteps) {
      load_stage<NT, BT>(st, a, w, m0, n0, (step0 + i + T::STAGES) * BK, M,
                         N, K);
      mbar_arrive_cp_async(&bars[s]);
    }
  }
}

// The K steps of split `split` of `splits`: ceil(steps / splits) each.
__device__ __forceinline__ void split_range(int K, int split, int splits,
                                            int& step0, int& nsteps) {
  const int steps = (K + BK - 1) / BK;
  const int per = (steps + splits - 1) / splits;
  step0 = split * per;
  nsteps = min(per, steps - step0);
}

// Sum the cluster's split-K partials (when splits > 1) and hand each
// thread's outputs to `epi(token, n, v)`: v[q] is column n + q,
// q < 2 * NT, for one token.  Token groups of 8 are spread over the
// cluster's blocks, so the partials never leave shared memory.
template <int NT, int BT, typename Epi>
__device__ __forceinline__ void finish(int (&acc)[NT][Tile<NT, BT>::ACC],
                                       uint8_t* smem, int splits, int m0,
                                       int n0, int M, int N, Epi epi) {
  using T = Tile<NT, BT>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nb = n0 + (NT == 2 ? 32 * warp + 4 * g : 16 * warp + 2 * g);
  uint32_t rank = 0;
  if (splits > 1) {
    int* red = reinterpret_cast<int*>(smem);   // the drained ring
#pragma unroll
    for (int tl = 0; tl < NT; ++tl)
#pragma unroll
      for (int r = 0; r < T::ACC; ++r)
        red[(tl * T::ACC + r) * THREADS + tid] = acc[tl][r];
    cluster_sync();
    rank = cluster_rank();
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      if (j % splits != (int)rank) continue;
      int sum[NT][4] = {};
      for (int q = 0; q < splits; ++q)   // NT * 4 loads in flight
#pragma unroll
        for (int tl = 0; tl < NT; ++tl)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sum[tl][c] += ld_dsmem(
                red + (tl * T::ACC + 4 * j + c) * THREADS + tid, q);
#pragma unroll
      for (int tl = 0; tl < NT; ++tl)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[tl][4 * j + c] = sum[tl][c];
    }
  }
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    if (j % splits != (int)rank) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int token = m0 + 8 * j + 2 * t + b;
      if (token >= M || nb >= N) continue;
      int v[2 * NT];
#pragma unroll
      for (int tl = 0; tl < NT; ++tl) {
        v[2 * tl] = acc[tl][4 * j + b];
        v[2 * tl + 1] = acc[tl][4 * j + 2 + b];
      }
      epi(token, nb, v);
    }
  }
  if (splits > 1) cluster_sync();   // keep the partials until all are read
}

// Block setup shared by the kernels: the full barriers, one per stage,
// each completed by the 128 threads' cp.async arrivals.
template <int NT, int BT>
__device__ __forceinline__ uint64_t* init_ring(uint8_t* smem) {
  using T = Tile<NT, BT>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::RING);
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) mbar_init(&bars[s], THREADS);
    fence_barrier_init();
  }
  __syncthreads();
  return bars;
}

// Opt `kern` in to its dynamic shared memory and to clusters of up to 16
// blocks, once per kernel.
template <typename Kern>
cudaError_t opt_in(Kern kern, int smem) {
  static const void* done[64];
  static int n = 0;
  const void* fn = reinterpret_cast<const void*>(kern);
  for (int i = 0; i < n; ++i)
    if (done[i] == fn) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && n < 64) done[n++] = fn;
  return e;
}

// Launch `kern` on grid (splits, N tiles, M tiles) with `splits` blocks
// per cluster along x.
template <int NT, int BT, typename... Exp, typename... Act>
cudaError_t launch(void (*kern)(Exp...), int M, int N, int splits,
                   cudaStream_t stream, Act&&... args) {
  using T = Tile<NT, BT>;
  cudaError_t e = opt_in(kern, T::SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + T::BN - 1) / T::BN, (M + BT - 1) / BT);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, std::forward<Act>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace wg
}  // namespace repro
