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
// arithmetic; the self tile is C x C per kv-head.  This simple version does
// its dot products on the CUDA cores in f32 (no tensor cores), so it is
// bound by those operations, not by bytes.
//
// Design (simple first): one thread block (4 warps) per (row, kv-head,
// tile of 16 query rows), so the batch axis stays parallel -- the TPU ran
// it sequentially only because masked rows aliased the null block.  Each
// block walks the row's past pages, staging one dequantized K/V page in
// shared memory, then the in-hand chunk in 16-token tiles up to its last
// causal key; each warp owns 4 query rows with their (m, l, acc) in
// registers.  The causal self block is tiled instead of the TPU's single
// [C*G, C] tile.  Page writes skip masked rows and dead tail pages instead
// of sending them to null block 0, and exactly one block per (row,
// kv-head, chunk page) -- the one whose query-tile index equals the chunk
// page -- writes each page, so no two blocks race.  A chunk's pages are
// disjoint from the past pages any block reads, so attention and writes
// need no ordering between blocks.

#include "common.cuh"

using repro::from_f32;
using repro::to_f32;
using repro::warp_max;
using repro::warp_sum;

namespace {

constexpr float NEG_INF = -1e30f;
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
__global__ void __launch_bounds__(WARPS * 32) flash_prefill_kernel(
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

  // ---- write phase: block qt writes chunk page qt of this kv-head -----
  const int slot = p0 / BS + qt;
  if (qt * BS >= C || wmask[b] == 0 || qt * BS >= nt || slot >= W) return;
  const int blk = tables[(size_t)b * W + slot];
  for (int tk = warp; tk < BS; tk += WARPS) {
    const size_t src = (((size_t)b * C + qt * BS + tk) * KVH + h) * D;
    const size_t tok = ((size_t)blk * BS + tk) * KVH + h;
    float xk[DPL], xv[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      xk[j] = to_f32(k_new[src + lane + 32 * j]);
      xv[j] = to_f32(v_new[src + lane + 32 * j]);
    }
    PageWriter<PT>::template write<DPL>(xk, k_pages + tok * D,
                                        k_scale + (k_scale ? tok : 0), lane);
    PageWriter<PT>::template write<DPL>(xv, v_pages + tok * D,
                                        v_scale + (v_scale ? tok : 0), lane);
  }
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
  auto kern = flash_prefill_kernel<QT, PT, DPL>;
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
  if (q_dtype == repro::kF32)
    e = by_page<float>(page_dtype, dpl, q, kn, vn, kp, vp, ks, vs, tbl, ps, nt, wm, out, B, KVH, C, G, BS, W, st);
  else if (q_dtype == repro::kBF16)
    e = by_page<__nv_bfloat16>(page_dtype, dpl, q, kn, vn, kp, vp, ks, vs, tbl, ps, nt, wm, out, B, KVH, C, G, BS, W, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
