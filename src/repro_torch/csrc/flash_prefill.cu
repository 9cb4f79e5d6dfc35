// Causal chunked paged prefill with in-kernel K/V quantization and page
// writes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_prefill_kernel`
// (src/repro/kernels/paged_attention/kernel.py, body `_prefill_kernel`):
// every query of a C-token chunk attends the row's past pool pages
// [0, pos) plus the causal prefix of the in-hand fp chunk (ragged n_tok);
// then the chunk's K/V is quantized exactly as attention.quantize_kv does
// (scale = bf16(max(absmax / 127, 1e-8)), codes = clip(rint(x / scale),
// -127, 127)) -- or rounded to the pool's fp type -- and written into the
// row's pages in place.
//
// What bounds it on this card: at chunk length C = 64 and G = 4 a past page
// byte serves C*G = 256 queries, so past-page attention leans towards the
// arithmetic, and the self tile is C x C per kv-head: the tensor cores.
//
// Two instantiations, chosen by the C entry point:
//
// * bf16 queries over int8 or bf16 pages (the serving path), D in {64,
//   128): prefill_tensor_core_kernel.  One block (8 warps) per (row,
//   kv-head, 64-row query tile); the rows of a kv-head are the chunk's C*G
//   rows in chunk-major order (row = c*G + g), so the GQA group that
//   shares K/V forms the M dimension.  Each group of 16 rows is scored by
//   two warps, one per 32-key half of every tile, each with its own
//   online softmax; the halves are merged in shared memory at the end.
//   The block walks the row's past keys once, in 64-key tiles staged as raw
//   codes by 16-byte cp.async copies into a ring (3 stages for int8, 2 for
//   bf16), so the next tile is in flight while the current one is scored;
//   int8 codes become bf16 once per tile in shared memory (exact: |code| <=
//   127).  Then the in-hand chunk in 64-key tiles up to the block's last
//   causal key; key halves wholly above a warp's diagonal are skipped, the
//   diagonal tile is masked.  The row's past block ids are read into
//   shared memory once.  Products on exact operands, so the result is
//   the f32 math of the plain version in another order:
//     S = Q.K^T by mma.sync.m16n8k16 bf16 -> f32 on the raw codes; the
//     per-token K scale and 1/sqrt(D) (with log2 e, for exp2f) multiply
//     the f32 scores afterwards; the online softmax runs in f32 registers;
//     O += P.V with the per-token V scale folded into P in f32 and P split
//     into a bf16 hi and a bf16 lo part, two products on the exact V codes
//     (P kept to ~16 mantissa bits).  No TF32 anywhere.
// * Every other combination (f32 queries -- tests only --, f32 pages, D in
//   {32, 160, 256}): prefill_cuda_core_kernel, f32 dot products on the CUDA
//   cores, one block per (row, kv-head, 16-row query tile), one dequantized
//   page in shared memory at a time, each warp owning 4 query rows.  D =
//   160 (stablelm-12b's heads, five elements a lane) serves on this path.
//
// Both keep the batch axis parallel -- the TPU ran it sequentially only
// because masked rows aliased the null block -- and tile the causal self
// block instead of the TPU's single [C*G, C] tile.  Page writes skip masked
// rows and dead tail pages instead of sending them to null block 0, and are
// assigned independently of the query tile: the block of query tile qt
// writes chunk pages qt, qt + n_tiles, ..., so every chunk page has exactly
// one writer at any C, G and BS.  A chunk's pages are disjoint from the
// past pages any block reads, so attention and writes need no ordering
// between blocks.

#include <type_traits>

#include "common.cuh"

using repro::from_f32;
using repro::to_f32;
using repro::warp_max;
using repro::warp_sum;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 4;
constexpr int ROWS = 4;               // query rows per warp
constexpr int QTILE = WARPS * ROWS;   // query rows per block
constexpr int KTILE = 16;             // in-hand keys per self-tile step

__device__ __forceinline__ int8_t quant_kv(float x, float s) {
  float q = rintf(__fdiv_rn(x, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return (int8_t)(int)q;
}

template <typename PT>
struct PageWriter;

template <>
struct PageWriter<int8_t> {
  // One warp quantizes one token-head vector: absmax over D, bf16 scale.
  template <int DPL>
  __device__ static void write(const float (&x)[DPL], int8_t* dst,
                               __nv_bfloat16* scale_dst, int lane) {
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) amax = fmaxf(amax, fabsf(x[j]));
    amax = warp_max(amax);
    const __nv_bfloat16 sb =
        __float2bfloat16_rn(fmaxf(__fdiv_rn(amax, 127.f), 1e-8f));
    const float s = __bfloat162float(sb);
#pragma unroll
    for (int j = 0; j < DPL; ++j) dst[lane + 32 * j] = quant_kv(x[j], s);
    if (lane == 0) *scale_dst = sb;
  }
};

template <typename PT>
struct PageWriter {
  template <int DPL>
  __device__ static void write(const float (&x)[DPL], PT* dst,
                               __nv_bfloat16*, int lane) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) dst[lane + 32 * j] = from_f32<PT>(x[j]);
  }
};

// Page writes, independent of the query tile: the block that holds query
// tile `first` writes chunk pages first, first + step, ... of its (row,
// kv-head), one warp per token-head vector, so every chunk page has one
// writer whatever C, G and BS are.  Ragged dead-tail pages and slots past
// the table are skipped.
template <typename QT, typename PT, int DPL>
__device__ void write_chunk_pages(
    const QT* __restrict__ k_new, const QT* __restrict__ v_new,
    PT* __restrict__ k_pages, PT* __restrict__ v_pages,
    __nv_bfloat16* __restrict__ k_scale, __nv_bfloat16* __restrict__ v_scale,
    const int* __restrict__ tables, int b, int h, int KVH, int C, int BS,
    int W, int p0, int nt, int first, int step) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int j = first; j * BS < C && j * BS < nt; j += step) {
    const int slot = p0 / BS + j;
    if (slot >= W) return;
    const int blk = tables[(size_t)b * W + slot];
    for (int tk = warp; tk < BS; tk += nwarps) {
      const size_t src = (((size_t)b * C + j * BS + tk) * KVH + h) * (32 * DPL);
      const size_t tok = ((size_t)blk * BS + tk) * KVH + h;
      float xk[DPL], xv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        xk[e] = to_f32(k_new[src + lane + 32 * e]);
        xv[e] = to_f32(v_new[src + lane + 32 * e]);
      }
      PageWriter<PT>::template write<DPL>(xk, k_pages + tok * 32 * DPL,
                                          k_scale + (k_scale ? tok : 0), lane);
      PageWriter<PT>::template write<DPL>(xv, v_pages + tok * 32 * DPL,
                                          v_scale + (v_scale ? tok : 0), lane);
    }
  }
}

// Online-softmax update of one query row against n staged keys.
template <int DPL>
__device__ __forceinline__ void attend_tile(
    const float (&qr)[DPL], float& m, float& l, float (&acc)[DPL],
    const float* sk, const float* sv, int n, int lane, float sqrt_d,
    int key0, int key_end, float* ss) {
  constexpr int D = 32 * DPL;
  float mx = NEG_INF;
  for (int tk = 0; tk < n; ++tk) {
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) part += qr[j] * sk[tk * D + lane + 32 * j];
    float sc = warp_sum(part) / sqrt_d;
    if (key0 + tk >= key_end) sc = NEG_INF;
    mx = fmaxf(mx, sc);
    if (lane == 0) ss[tk] = sc;
  }
  __syncwarp();
  const float m_new = fmaxf(m, mx);
  const float alpha = expf(m - m_new);
  float psum = 0.f;
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] *= alpha;
  for (int tk = 0; tk < n; ++tk) {
    const float pr = (key0 + tk < key_end) ? expf(ss[tk] - m_new) : 0.f;
    psum += pr;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] += pr * sv[tk * D + lane + 32 * j];
  }
  l = l * alpha + psum;
  m = m_new;
  __syncwarp();
}

template <typename QT, typename PT, int DPL>
__global__ void __launch_bounds__(WARPS * 32) prefill_cuda_core_kernel(
    const QT* __restrict__ q,        // [B, KVH, C*G, D]
    const QT* __restrict__ k_new,    // [B, C, KVH, D]
    const QT* __restrict__ v_new,
    PT* __restrict__ k_pages,        // [NB, BS, KVH, D]
    PT* __restrict__ v_pages,
    __nv_bfloat16* __restrict__ k_scale,   // [NB, BS, KVH] or null
    __nv_bfloat16* __restrict__ v_scale,
    const int* __restrict__ tables,  // [B, W]
    const int* __restrict__ pos,     // [B]
    const int* __restrict__ n_tok,   // [B]
    const int* __restrict__ wmask,   // [B]
    QT* __restrict__ out,            // [B, KVH, C*G, D]
    int KVH, int C, int G, int BS, int W) {
  constexpr int D = 32 * DPL;
  extern __shared__ float smem[];
  const int TK = max(BS, KTILE);
  float* sk = smem;                      // [TK, D]
  float* sv = smem + TK * D;             // [TK, D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ss = smem + 2 * TK * D + warp * TK;   // per-warp scores [TK]

  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH, qt = blockIdx.y;
  const int CG = C * G;
  const int p0 = pos[b], nt = n_tok[b];
  const float sqrt_d = sqrtf((float)D);

  // This warp's query rows (chunk-major: row = c * G + g).
  float qr[ROWS][DPL], acc[ROWS][DPL], m[ROWS], l[ROWS];
  int qi[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = min(qt * QTILE + warp * ROWS + r, CG - 1);
    qi[r] = row / G;
    const QT* qp = q + (((size_t)b * KVH + h) * CG + row) * D;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      qr[r][j] = to_f32(qp[lane + 32 * j]);
      acc[r][j] = 0.f;
    }
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  // ---- past-page walk: every chunk query sees every past key ----------
  const int n_past = min((p0 + BS - 1) / BS, W);
  for (int p = 0; p < n_past; ++p) {
    const int blk = tables[(size_t)b * W + p];
    __syncthreads();
    for (int i = threadIdx.x; i < BS * D; i += blockDim.x) {
      const int tk = i / D, d = i % D;
      const size_t tok = ((size_t)blk * BS + tk) * KVH + h;
      float kv = to_f32(k_pages[tok * D + d]);
      float vv = to_f32(v_pages[tok * D + d]);
      if (k_scale != nullptr) {
        kv = kv * __bfloat162float(k_scale[tok]);
        vv = vv * __bfloat162float(v_scale[tok]);
      }
      sk[i] = kv;
      sv[i] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      attend_tile<DPL>(qr[r], m[r], l[r], acc[r], sk, sv, BS, lane, sqrt_d,
                       p * BS, p0, ss);
  }

  // ---- self tile: causal within the chunk, in-hand fp K/V ------------
  const int last_q = min(qt * QTILE + QTILE - 1, CG - 1) / G;
  const int self_end = min(last_q + 1, nt);
  for (int k0 = 0; k0 < self_end; k0 += KTILE) {
    const int n = min(KTILE, C - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
      const int tk = i / D, d = i % D;
      const size_t src = (((size_t)b * C + k0 + tk) * KVH + h) * D + d;
      sk[i] = to_f32(k_new[src]);
      sv[i] = to_f32(v_new[src]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      attend_tile<DPL>(qr[r], m[r], l[r], acc[r], sk, sv, n, lane, sqrt_d,
                       k0, min(qi[r] + 1, nt), ss);
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = qt * QTILE + warp * ROWS + r;
    if (row >= CG) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    QT* op = out + (((size_t)b * KVH + h) * CG + row) * D;
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      op[lane + 32 * j] = from_f32<QT>(acc[r][j] / denom);
  }

  if (wmask[b] != 0)
    write_chunk_pages<QT, PT, DPL>(k_new, v_new, k_pages, v_pages, k_scale,
                                   v_scale, tables, b, h, KVH, C, BS, W, p0,
                                   nt, qt, gridDim.y);
}

// ---------------------------------------------------------------------------
// bf16 queries over int8 or bf16 pages: the bf16 tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_ROWS = 64;   // query rows per block, 16 per row group
constexpr int KT = 64;        // keys per tile
constexpr int TC_WARPS = 8;   // 4 row groups x 2 key halves
constexpr int KH = KT / 2;    // keys of a tile per warp

template <typename PT, int D>
struct TcCfg {
  static constexpr bool I8 = std::is_same<PT, int8_t>::value;
  static constexpr int PITCH = D + 8;          // bf16 per compute-tile row
  static constexpr int TILE = KT * PITCH * 2;  // bytes of one K or V tile
  // Ring rows: raw int8 codes, or bf16 rows already in compute layout.
  static constexpr int RAW_ROW = I8 ? D : PITCH * 2;
  static constexpr int STAGE =
      (2 * KT * RAW_ROW + (I8 ? 2 * KT * 4 : 0) + 15) & ~15;
  static constexpr int STAGES = I8 ? 3 : 2;
  static constexpr int SMEM =
      STAGES * STAGE + (I8 ? 2 * TILE + 2 * KT * 4 : 0);
  // The key halves' merge reuses the tile buffers.
  static_assert(4 * 32 * (D / 8 * 4 + 4) * 4 <= SMEM, "merge area");
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(repro::smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(repro::smem_u32(p))
      : "memory");
}

// (lo, hi) -> bf16x2, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

template <typename PT, int D>
__global__ void __launch_bounds__(TC_WARPS * 32) prefill_tensor_core_kernel(
    const __nv_bfloat16* __restrict__ q,      // [B, KVH, C*G, D]
    const __nv_bfloat16* __restrict__ k_new,  // [B, C, KVH, D]
    const __nv_bfloat16* __restrict__ v_new,
    PT* __restrict__ k_pages,                 // [NB, BS, KVH, D]
    PT* __restrict__ v_pages,
    __nv_bfloat16* __restrict__ k_scale,      // [NB, BS, KVH] (int8 pages)
    __nv_bfloat16* __restrict__ v_scale,
    const int* __restrict__ tables,           // [B, W]
    const int* __restrict__ pos,              // [B]
    const int* __restrict__ n_tok,            // [B]
    const int* __restrict__ wmask,            // [B]
    __nv_bfloat16* __restrict__ out,          // [B, KVH, C*G, D]
    int KVH, int C, int G, int BS, int W) {
  using Cfg = TcCfg<PT, D>;
  constexpr bool I8 = Cfg::I8;
  constexpr int PITCH = Cfg::PITCH;
  constexpr int NKS = D / 16;      // k-steps of Q.K^T
  constexpr int NDT = D / 8;       // output n-tiles
  constexpr int NST = KH / 8;      // score n-tiles per warp and tile
  constexpr float NINF = -__builtin_huge_valf();
  extern __shared__ __align__(16) uint8_t smem_tc[];
  uint8_t* smem = smem_tc;
  uint8_t* conv = smem + Cfg::STAGES * Cfg::STAGE;   // int8: bf16 K, V tiles
  float* ksf = reinterpret_cast<float*>(conv + 2 * Cfg::TILE);
  float* vsf = ksf + KT;
  int* sblk = reinterpret_cast<int*>(smem + Cfg::SMEM);   // past block ids

  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH, qt = blockIdx.y;
  const int CG = C * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int p0 = pos[b], nt = n_tok[b];
  const float qk = LOG2E / sqrtf((float)D);   // scores in log2 units
  const int* trow = tables + (size_t)b * W;

  // Warp w owns the 16 query rows of row group w % 4 (chunk-major: row =
  // c * G + g; the thread holds rows gid and gid + 8 of the m16n8
  // fragments) against key half w / 4 of every tile; the two halves are
  // merged at the end.
  const int row0 = qt * TC_ROWS + (warp & 3) * 16;
  const int khalf = warp >> 2, kbase = khalf * KH;
  const bool warp_live = row0 < CG;
  const int qi[2] = {min(row0 + gid, CG - 1) / G,
                     min(row0 + gid + 8, CG - 1) / G};
  const int warp_last_q = min(row0 + 15, CG - 1) / G;

  uint32_t qf[NKS][4];
  {
    const __nv_bfloat16* qb = q + ((size_t)b * KVH + h) * CG * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + gid + 8 * hr;
      const uint32_t* qr = reinterpret_cast<const uint32_t*>(
          qb + (size_t)min(r, CG - 1) * D);
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        qf[ks][hr] = r < CG ? qr[ks * 8 + tig] : 0u;
        qf[ks][hr + 2] = r < CG ? qr[ks * 8 + 4 + tig] : 0u;
      }
    }
  }
  float o[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float mrow[2] = {NINF, NINF}, lrow[2] = {0.f, 0.f};

  // Online-softmax update of the warp's rows against one 64-key tile:
  // S = Q.K^T on the tensor cores (exact bf16 operands: codes or bf16
  // values), the K scale and 1/sqrt(D) on the f32 scores, then O += P.V
  // with the V scale folded into P and P split into bf16 hi + lo parts.
  // `past`: keys key0.. are past positions, valid below npk; otherwise
  // chunk tokens, valid up to the row's own token and below n_tok.
  auto attend = [&](const __nv_bfloat16* kt, const __nv_bfloat16* vt,
                    bool scaled, bool past, int key0, int npk) {
    float sc[NST][4];
#pragma unroll
    for (int j = 0; j < NST; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
#pragma unroll
      for (int np = 0; np < NST / 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, kt + (kbase + np * 16 + ((lane >> 4) << 3) + (lane & 7)) *
                            PITCH + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qf[ks], r[0], r[1]);
        mma_bf16(sc[2 * np + 1], qf[ks], r[2], r[3]);
      }
    }
    float mx[2] = {NINF, NINF};
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kbase + j * 8 + 2 * tig + (e & 1);
        const int hr = e >> 1;
        const bool ok = past ? key0 + key < npk
                             : key0 + key < nt && key0 + key <= qi[hr];
        const float v = sc[j][e] * (scaled ? ksf[key] : qk);
        sc[j][e] = ok ? v : NINF;
        mx[hr] = fmaxf(mx[hr], sc[j][e]);
      }
    }
    float mu[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(mrow[hr], mx[hr]);
      mu[hr] = m_new == NINF ? 0.f : m_new;
      alpha[hr] = exp2f(mrow[hr] - mu[hr]);
      mrow[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[j][e] - mu[e >> 1]);
        rs[e >> 1] += p;
        sc[j][e] = scaled ? p * vsf[kbase + j * 8 + 2 * tig + (e & 1)] : p;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) lrow[hr] = lrow[hr] * alpha[hr] + rs[hr];
#pragma unroll
    for (int i = 0; i < NDT; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < KH / 16; ++kk) {
      // A fragments of P (rows gid / gid+8, keys 16kk + 2tig (+1) and + 8).
      const float p4[4][2] = {{sc[2 * kk][0], sc[2 * kk][1]},
                              {sc[2 * kk][2], sc[2 * kk][3]},
                              {sc[2 * kk + 1][0], sc[2 * kk + 1][1]},
                              {sc[2 * kk + 1][2], sc[2 * kk + 1][3]}};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = pack_bf16(p4[i][0], p4[i][1]);
        al[i] = pack_bf16(p4[i][0] - bf16_lo(ah[i]),
                          p4[i][1] - bf16_hi(ah[i]));
      }
#pragma unroll
      for (int dp = 0; dp < NDT / 2; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(r, vt + (kbase + kk * 16 + ((lane >> 3) & 1) * 8 +
                               (lane & 7)) * PITCH + dp * 16 +
                              ((lane >> 4) << 3));
        mma_bf16(o[2 * dp], ah, r[0], r[1]);
        mma_bf16(o[2 * dp], al, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], ah, r[2], r[3]);
        mma_bf16(o[2 * dp + 1], al, r[2], r[3]);
      }
    }
  };

  // ---- past keys: 64-key tiles through a cp.async ring ---------------
  const int npk = min(p0, W * BS);
  const int n_past = (npk + KT - 1) / KT;
  // The row's past block ids, read once: the tile loads then never wait
  // on a table read.
  for (int i = threadIdx.x; i * BS < npk; i += blockDim.x) sblk[i] = trow[i];
  __syncthreads();
  auto page_row = [&](int key) {   // (block, token) of past key `key`
    return (size_t)sblk[key / BS] * BS + key % BS;
  };
  auto load_past = [&](int j) {
    uint8_t* st = smem + (j % Cfg::STAGES) * Cfg::STAGE;
    constexpr int CPR = D * (int)sizeof(PT) / 16;
    for (int c = threadIdx.x; c < 2 * KT * CPR; c += blockDim.x) {
      const int kv = c / (KT * CPR), r = (c / CPR) % KT, cc = c % CPR;
      const int key = j * KT + r;
      const bool ok = key < npk;
      const PT* src = (kv ? v_pages : k_pages) +
                      ((ok ? page_row(key) : 0) * KVH + h) * D;
      repro::cp_async16(st + (kv * KT + r) * Cfg::RAW_ROW + cc * 16,
                        reinterpret_cast<const uint8_t*>(src) + cc * 16, ok);
    }
    if constexpr (I8) {
      for (int c = threadIdx.x; c < 2 * KT; c += blockDim.x) {
        const int kv = c / KT, key = j * KT + c % KT;
        const bool ok = key < npk;
        const __nv_bfloat16* sp = (kv ? v_scale : k_scale) +
                                  (ok ? page_row(key) : 0) * KVH + h;
        repro::cp_async4(st + 2 * KT * Cfg::RAW_ROW + c * 4,
                         repro::scale_word(sp), ok);
      }
    }
  };
  // int8 codes -> bf16 tiles (exact) and the scales -> f32, once a tile.
  auto convert = [&](const uint8_t* st, int j) {
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(conv);
    for (int c = threadIdx.x; c < 2 * KT * (D / 16); c += blockDim.x) {
      const int kv = c / (KT * (D / 16)), r = (c / (D / 16)) % KT,
                cc = c % (D / 16);
      const uint4 w = *reinterpret_cast<const uint4*>(
          st + (kv * KT + r) * D + cc * 16);
      float f[16];
      repro::i8x4_to_f32(w.x, f);
      repro::i8x4_to_f32(w.y, f + 4);
      repro::i8x4_to_f32(w.z, f + 8);
      repro::i8x4_to_f32(w.w, f + 12);
      uint32_t pk[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)   // small integers: the top 16 bits are exact
        pk[i] = __byte_perm(__float_as_uint(f[2 * i]),
                            __float_as_uint(f[2 * i + 1]), 0x7632);
      uint4* d4 = reinterpret_cast<uint4*>(dst + (kv * KT + r) * PITCH +
                                           cc * 16);
      d4[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      d4[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
    }
    const uint32_t* words =
        reinterpret_cast<const uint32_t*>(st + 2 * KT * Cfg::RAW_ROW);
    for (int c = threadIdx.x; c < 2 * KT; c += blockDim.x) {
      const int kv = c / KT, key = j * KT + c % KT;
      float f = 0.f;
      if (key < npk)
        f = repro::scale_from_word(
            words[c], (kv ? v_scale : k_scale) + page_row(key) * KVH + h);
      if (kv) vsf[c % KT] = f;
      else ksf[c % KT] = f * qk;
    }
  };

#pragma unroll
  for (int i = 0; i < Cfg::STAGES - 1; ++i) {
    if (i < n_past) load_past(i);
    repro::cp_async_commit();
  }
  for (int j = 0; j < n_past; ++j) {
    repro::cp_async_wait<Cfg::STAGES - 2>();
    __syncthreads();   // tile j landed; the previous tile's readers are done
    if (j + Cfg::STAGES - 1 < n_past) load_past(j + Cfg::STAGES - 1);
    repro::cp_async_commit();
    const uint8_t* st = smem + (j % Cfg::STAGES) * Cfg::STAGE;
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(st);
    if constexpr (I8) {
      convert(st, j);
      __syncthreads();
      kt = reinterpret_cast<const __nv_bfloat16*>(conv);
    }
    if (warp_live && j * KT + kbase < npk)
      attend(kt, kt + KT * PITCH, I8, true, j * KT, npk);
  }
  repro::cp_async_wait<0>();

  // ---- in-hand chunk: causal 64-key tiles up to the block's last query --
  const int last_q = min(qt * TC_ROWS + TC_ROWS - 1, CG - 1) / G;
  const int self_end = min(last_q + 1, nt);
  uint8_t* sbuf = I8 ? conv : smem;
  for (int t = 0; t * KT < self_end; ++t) {
    __syncthreads();   // the buffer's previous readers are done
    for (int c = threadIdx.x; c < 2 * KT * (D / 8); c += blockDim.x) {
      const int kv = c / (KT * (D / 8)), r = (c / (D / 8)) % KT,
                cc = c % (D / 8);
      const int kc = t * KT + r;
      const bool ok = kc < C;
      const __nv_bfloat16* src = (kv ? v_new : k_new) +
                                 (((size_t)b * C + (ok ? kc : 0)) * KVH + h) * D;
      repro::cp_async16(sbuf + kv * Cfg::TILE + r * PITCH * 2 + cc * 16,
                        src + cc * 8, ok);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(sbuf);
    // Key halves wholly above the warp's diagonal are skipped.
    if (warp_live && t * KT + kbase <= warp_last_q && t * KT + kbase < nt)
      attend(kt, kt + KT * PITCH, false, false, t * KT, 0);
  }

  // Merge the two key halves of each row group: the second half's warps
  // leave (o, m, l) in shared memory (the tile buffers are free now), the
  // first half's combine and write.  The partner lane holds the same
  // fragment positions, so each lane reads back its own slot.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lrow[hr] += __shfl_xor_sync(0xffffffffu, lrow[hr], 1);
    lrow[hr] += __shfl_xor_sync(0xffffffffu, lrow[hr], 2);
  }
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem) +
                ((warp & 3) * 32 + lane) * (NDT * 4 + 4);
  if (khalf == 1) {
#pragma unroll
    for (int i = 0; i < NDT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i * 4 + e] = o[i][e];
    part[NDT * 4] = mrow[0];
    part[NDT * 4 + 1] = mrow[1];
    part[NDT * 4 + 2] = lrow[0];
    part[NDT * 4 + 3] = lrow[1];
  }
  __syncthreads();
  if (khalf == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + gid + 8 * hr;
      if (r >= CG) continue;
      const float m2 = part[NDT * 4 + hr];
      float mm = fmaxf(mrow[hr], m2);
      if (mm == NINF) mm = 0.f;
      const float f1 = exp2f(mrow[hr] - mm), f2 = exp2f(m2 - mm);
      const float denom =
          fmaxf(lrow[hr] * f1 + part[NDT * 4 + 2 + hr] * f2, 1e-30f);
      uint32_t* op = reinterpret_cast<uint32_t*>(
          out + (((size_t)b * KVH + h) * CG + r) * D);
#pragma unroll
      for (int i = 0; i < NDT; ++i)
        op[i * 4 + tig] = pack_bf16(
            (o[i][2 * hr] * f1 + part[i * 4 + 2 * hr] * f2) / denom,
            (o[i][2 * hr + 1] * f1 + part[i * 4 + 2 * hr + 1] * f2) / denom);
    }
  }

  if (wmask[b] != 0)
    write_chunk_pages<__nv_bfloat16, PT, D / 32>(
        k_new, v_new, k_pages, v_pages, k_scale, v_scale, tables, b, h, KVH,
        C, BS, W, p0, nt, qt, gridDim.y);
}

template <typename PT, int D>
cudaError_t launch_tc(const void* q, const void* kn, const void* vn, void* kp,
                      void* vp, void* ks, void* vs, const int* tables,
                      const int* pos, const int* n_tok, const int* wm,
                      void* out, int B, int KVH, int C, int G, int BS, int W,
                      cudaStream_t stream) {
  const size_t smem = TcCfg<PT, D>::SMEM + (size_t)W * sizeof(int);
  auto kern = prefill_tensor_core_kernel<PT, D>;
  cudaError_t e = repro::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * KVH, (C * G + TC_ROWS - 1) / TC_ROWS);
  using bf = __nv_bfloat16;
  kern<<<grid, TC_WARPS * 32, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(kn),
      static_cast<const bf*>(vn), static_cast<PT*>(kp), static_cast<PT*>(vp),
      static_cast<bf*>(ks), static_cast<bf*>(vs), tables, pos, n_tok, wm,
      static_cast<bf*>(out), KVH, C, G, BS, W);
  return cudaGetLastError();
}

template <typename QT, typename PT, int DPL>
cudaError_t launch(const void* q, const void* kn, const void* vn, void* kp,
                   void* vp, void* ks, void* vs, const int* tables,
                   const int* pos, const int* n_tok, const int* wm, void* out,
                   int B, int KVH, int C, int G, int BS, int W,
                   cudaStream_t stream) {
  constexpr int D = 32 * DPL;
  const int TK = BS > KTILE ? BS : KTILE;
  const size_t smem = (size_t)(2 * TK * D + WARPS * TK) * sizeof(float);
  auto kern = prefill_cuda_core_kernel<QT, PT, DPL>;
  cudaError_t e = repro::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int CG = C * G;
  dim3 grid(B * KVH, (CG + QTILE - 1) / QTILE);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(kn),
      static_cast<const QT*>(vn), static_cast<PT*>(kp), static_cast<PT*>(vp),
      static_cast<__nv_bfloat16*>(ks), static_cast<__nv_bfloat16*>(vs),
      tables, pos, n_tok, wm, static_cast<QT*>(out), KVH, C, G, BS, W);
  return cudaGetLastError();
}

#define REPRO_PREFILL_ARGS \
  q, kn, vn, kp, vp, ks, vs, tables, pos, n_tok, wm, out, B, KVH, C, G, BS, W, st

template <typename QT, typename PT>
cudaError_t by_dpl(int dpl, const void* q, const void* kn, const void* vn,
                   void* kp, void* vp, void* ks, void* vs, const int* tables,
                   const int* pos, const int* n_tok, const int* wm, void* out,
                   int B, int KVH, int C, int G, int BS, int W,
                   cudaStream_t st) {
  switch (dpl) {
    case 1: return launch<QT, PT, 1>(REPRO_PREFILL_ARGS);
    case 2: return launch<QT, PT, 2>(REPRO_PREFILL_ARGS);
    case 4: return launch<QT, PT, 4>(REPRO_PREFILL_ARGS);
    case 5: return launch<QT, PT, 5>(REPRO_PREFILL_ARGS);   // stablelm-12b
    case 8: return launch<QT, PT, 8>(REPRO_PREFILL_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t by_page(int page_dtype, int dpl, const void* q, const void* kn,
                    const void* vn, void* kp, void* vp, void* ks, void* vs,
                    const int* tables, const int* pos, const int* n_tok,
                    const int* wm, void* out, int B, int KVH, int C, int G,
                    int BS, int W, cudaStream_t st) {
  switch (page_dtype) {
    case repro::kF32: return by_dpl<QT, float>(dpl, REPRO_PREFILL_ARGS);
    case repro::kBF16: return by_dpl<QT, __nv_bfloat16>(dpl, REPRO_PREFILL_ARGS);
    case repro::kI8: return by_dpl<QT, int8_t>(dpl, REPRO_PREFILL_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_prefill_launch(
    const void* q, int q_dtype, const void* k_new, const void* v_new,
    void* k_pages, void* v_pages, int page_dtype, void* k_scale,
    void* v_scale, const void* tables, const void* pos, const void* n_tok,
    const void* write_mask, void* out, int B, int KVH, int C, int G, int D,
    int BS, int W, void* stream) {
  if (D % 32 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dpl = D / 32;
  const void* kn = k_new;
  const void* vn = v_new;
  void* kp = k_pages;
  void* vp = v_pages;
  void* ks = k_scale;
  void* vs = v_scale;
  const int* tbl = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  const int* nt = static_cast<const int*>(n_tok);
  const int* wm = static_cast<const int*>(write_mask);
  cudaError_t e;
  if (q_dtype == repro::kBF16 && page_dtype != repro::kF32 &&
      (D == 64 || D == 128)) {
    // The serving instantiation: bf16 activations over an int8 (or bf16)
    // pool, on the tensor cores.
    const bool i8 = page_dtype == repro::kI8;
    if (D == 64)
      e = i8 ? launch_tc<int8_t, 64>(q, kn, vn, kp, vp, ks, vs, tbl, ps, nt, wm, out, B, KVH, C, G, BS, W, st)
             : launch_tc<__nv_bfloat16, 64>(q, kn, vn, kp, vp, ks, vs, tbl, ps, nt, wm, out, B, KVH, C, G, BS, W, st);
    else
      e = i8 ? launch_tc<int8_t, 128>(q, kn, vn, kp, vp, ks, vs, tbl, ps, nt, wm, out, B, KVH, C, G, BS, W, st)
             : launch_tc<__nv_bfloat16, 128>(q, kn, vn, kp, vp, ks, vs, tbl, ps, nt, wm, out, B, KVH, C, G, BS, W, st);
  } else if (q_dtype == repro::kF32)
    e = by_page<float>(page_dtype, dpl, q, kn, vn, kp, vp, ks, vs, tbl, ps, nt, wm, out, B, KVH, C, G, BS, W, st);
  else if (q_dtype == repro::kBF16)
    e = by_page<__nv_bfloat16>(page_dtype, dpl, q, kn, vn, kp, vp, ks, vs, tbl, ps, nt, wm, out, B, KVH, C, G, BS, W, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
