// Split-KV flash decoding over the paged KV pool for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention_kernel`
// (src/repro/kernels/paged_attention/kernel.py, body `_kernel`): one query
// token per row attends its block-table pages up to n_valid; int8 pages
// are dequantized with their per-token-head bf16 scales; the GQA group of
// G query heads shares each page; the softmax runs online in f32.  Each
// (row, kv-head, split) emits partials (acc, m, l) that the wrapper's
// merge_splits combines (rows with n_valid = 0 merge to zeros).
//
// What bounds it on this card: device-memory bytes.  Every live K/V page
// byte (plus its scale) is read once per (row, kv-head) and used for G
// dot products of length D, about G*2 flops a byte for bf16 pages and
// G*4 for int8: far below the ~295 flops a byte where the tensor cores
// become the limit.  So the design is about keeping bytes in flight and
// every SM busy; the arithmetic stays f32 on the CUDA cores.
//
// Design:
// * Grid (row x kv-head, split, head tile).  The wrapper picks the split
//   count from the card's SM count (autotune.heuristic_paged_splits_cuda),
//   so the grid covers every SM about twice even at small batch; a block
//   walks only its split's pps pages (a split past the table's width is
//   empty).  A serving engine passes a pps fixed for its widest table
//   (autotune.paged_split_pages), so a row's partials do not depend on
//   the table width.  The GQA group is cut into tiles of at
//   most 8 heads (GT) to bound registers; G <= 8 is one tile.
// * Page loads: a ring of STAGES page slots in shared memory filled with
//   16-byte cp.async copies (codes as raw bytes, one copy per 16 bytes of
//   a token row) plus one 4-byte copy per token for each scale, so page
//   p+1 and p+2 are in flight while page p is scored.  One __syncthreads
//   per page.
// * Scoring: 4 warps; a token row is spread over D/8 lanes, each lane
//   owning 8 elements (one 8-byte int8 / 16-byte bf16 read from shared
//   memory), so a warp scores 256/D tokens per step and the block 4x that.
//   Where D/8 is not a power of two (D = 160: stablelm-12b's heads) a row
//   takes the next power of two of lanes and the lanes past D hold zeros,
//   so the shuffle reductions stay butterflies (20 of 32 lanes work).
//   A warp scores two such steps before one online-softmax update, so
//   their shuffle and exp2 chains overlap.  Partial dot products reduce
//   over the D/8 lanes of the row; int8 codes
//   become f32 with a byte-permute and one add (no I2F), and the token's
//   K scale and 1/sqrt(D) multiply the finished dot product once.  Each
//   warp keeps its own online softmax (m, l, acc in registers); the four
//   warps' partials are combined in shared memory at the end.
// * The split's block-table entries are read into shared memory once, so
//   no page load waits on a table read.
//
// merge_splits_kernel is the wrapper's logsumexp combine of the splits'
// partials as one launch (the plain version is ops.merge_splits, several
// PyTorch operators, whose host cost showed over a serving run).

#include <type_traits>

#include "common.cuh"

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::scale_from_word;
using repro::scale_word;
using repro::to_f32;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int NW = 4;              // warps per block
constexpr int THREADS = NW * 32;
constexpr int EPL = 8;             // elements of a token row per lane
constexpr int STAGES = 3;          // pages in the cp.async ring

// Eight staged elements of a row -> f32.
__device__ __forceinline__ void row8(const uint8_t* s, int8_t,
                                     float (&x)[EPL]) {
  const uint2 w = *reinterpret_cast<const uint2*>(s);
  repro::i8x4_to_f32(w.x, x);
  repro::i8x4_to_f32(w.y, x + 4);
}

__device__ __forceinline__ void row8(const uint8_t* s, __nv_bfloat16,
                                     float (&x)[EPL]) {
  const uint4 w = *reinterpret_cast<const uint4*>(s);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(u[j] << 16);
    x[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void row8(const uint8_t* s, float,
                                     float (&x)[EPL]) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 16);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__host__ __device__ constexpr int pow2_ceil(int x) {
  return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2);
}

inline __host__ __device__ int stage_bytes(int BS, int D, int esz,
                                           bool scales) {
  const int bytes = 2 * BS * D * esz + (scales ? 2 * BS * 4 : 0);
  return (bytes + 15) & ~15;
}

template <typename QT, typename PT, int D, int GT>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const QT* __restrict__ q,                 // [B, KVH, G, D]
    const PT* __restrict__ k_pages,           // [NB, BS, KVH, D]
    const PT* __restrict__ v_pages,
    const __nv_bfloat16* __restrict__ k_scale,  // [NB, BS, KVH] or null
    const __nv_bfloat16* __restrict__ v_scale,
    const int* __restrict__ tables,           // [B, W]
    const int* __restrict__ n_valid,          // [B]
    float* __restrict__ acc_out,              // [B, KVH, S, G, D]
    float* __restrict__ m_out,                // [B, KVH, S, G]
    float* __restrict__ l_out,
    int KVH, int G, int BS, int W, int pps) {
  constexpr bool I8 = std::is_same<PT, int8_t>::value;
  constexpr int ESZ = sizeof(PT);
  constexpr int LPT = pow2_ceil(D / EPL);   // lanes per token row
  constexpr int TPW = 32 / LPT;             // tokens per warp step
  constexpr int CPR = D * ESZ / 16;   // 16-byte chunks per token row
  extern __shared__ __align__(16) uint8_t smem[];
  const int page_bytes = BS * D * ESZ;
  const int sbytes = stage_bytes(BS, D, ESZ, I8);
  float* merge = reinterpret_cast<float*>(smem + STAGES * sbytes);
  int* sblk = reinterpret_cast<int*>(merge + NW * GT * (D + 2));  // [pps]

  const int S = gridDim.y;
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH, s = blockIdx.y;
  const int g0 = blockIdx.z * GT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane / LPT;            // token slot within a warp step
  const int d0 = (lane % LPT) * EPL;      // this lane's 8 elements
  const bool lane_live = d0 < D;          // false only on padded lanes

  const float qk = LOG2E / sqrtf((float)D);   // scores in log2 units
  float qr[GT][EPL], acc[GT][EPL], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const bool live = g0 + g < G;
    const QT* qp = q + (((size_t)b * KVH + h) * G + (live ? g0 + g : 0)) * D;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] = live && lane_live ? to_f32(qp[d0 + e]) : 0.f;
      acc[g][e] = 0.f;
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  const int nv = n_valid[b];
  const int* trow = tables + (size_t)b * W;
  const int p_begin = s * pps;
  const int p_stop = min(min(p_begin + pps, W), (nv + BS - 1) / BS);
  const int n_pages = max(p_stop - p_begin, 0);
  // The split's block ids, read once: the page loads then never wait on a
  // table read.
  for (int i = threadIdx.x; i < n_pages; i += THREADS)
    sblk[i] = trow[p_begin + i];
  __syncthreads();

  auto scale_ptr = [&](const __nv_bfloat16* base, int blk, int tk) {
    return base + ((size_t)blk * BS + tk) * KVH + h;
  };
  auto load_page = [&](int i) {     // page p_begin + i into ring slot i % STAGES
    uint8_t* st = smem + (i % STAGES) * sbytes;
    const int blk = sblk[i];
    for (int c = threadIdx.x; c < 2 * BS * CPR; c += THREADS) {
      const bool kv = c / CPR >= BS;
      const int r = c / CPR - (kv ? BS : 0), cc = c % CPR;
      const PT* src = (kv ? v_pages : k_pages) +
                      (((size_t)blk * BS + r) * KVH + h) * D;
      cp_async16(st + (kv ? page_bytes : 0) + r * D * ESZ + cc * 16,
                 reinterpret_cast<const uint8_t*>(src) + cc * 16, true);
    }
    if constexpr (I8) {
      for (int c = threadIdx.x; c < 2 * BS; c += THREADS) {
        const bool kv = c >= BS;
        cp_async4(st + 2 * page_bytes + c * 4,
                  scale_word(scale_ptr(kv ? v_scale : k_scale, blk,
                                       c - (kv ? BS : 0))),
                  true);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_pages) load_page(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_pages; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // page i landed for all; slot (i-1) % STAGES is free
    if (i + STAGES - 1 < n_pages) load_page(i + STAGES - 1);
    cp_async_commit();

    const uint8_t* st = smem + (i % STAGES) * sbytes;
    const int p = p_begin + i;
    const int blk = sblk[i];
    // Two token slots a step, scored before one softmax update, so the
    // shuffle and exp2 chains of both overlap.
    for (int t0 = warp * TPW; t0 < BS; t0 += 2 * NW * TPW) {
      int tk[2];
      bool valid[2];
      float x[2][EPL], ksc[2], vsc[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        tk[u] = t0 + u * NW * TPW + slot;
        valid[u] = tk[u] < BS && p * BS + tk[u] < nv;
        ksc[u] = qk;
        vsc[u] = 1.f;
        if (valid[u] && lane_live) {
          row8(st + (tk[u] * D + d0) * ESZ, PT(), x[u]);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) x[u][e] = 0.f;
        }
        if (valid[u]) {
          if constexpr (I8) {
            const uint32_t* words =
                reinterpret_cast<const uint32_t*>(st + 2 * page_bytes);
            ksc[u] *= scale_from_word(words[tk[u]],
                                      scale_ptr(k_scale, blk, tk[u]));
            vsc[u] = scale_from_word(words[BS + tk[u]],
                                     scale_ptr(v_scale, blk, tk[u]));
          }
        }
      }
      float pr[2][GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float sc[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot += qr[g][e] * x[u][e];
          sc[u] = dot;
        }
#pragma unroll
        for (int o = LPT / 2; o > 0; o >>= 1) {
          sc[0] += __shfl_xor_sync(0xffffffffu, sc[0], o);
          sc[1] += __shfl_xor_sync(0xffffffffu, sc[1], o);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) sc[u] = valid[u] ? sc[u] * ksc[u] : NEG_INF;
        float mx = fmaxf(sc[0], sc[1]);
#pragma unroll
        for (int o = LPT; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = exp2f(m[g] - m_new);
#pragma unroll
        for (int u = 0; u < 2; ++u)
          pr[u][g] = valid[u] ? exp2f(sc[u] - m_new) : 0.f;
        l[g] = l[g] * alpha + pr[0][g] + pr[1][g];
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (!valid[u] || !lane_live) continue;
        row8(st + page_bytes + (tk[u] * D + d0) * ESZ, PT(), x[u]);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float pv = pr[u][g] * vsc[u];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] += pv * x[u][e];
        }
      }
    }
  }
  cp_async_wait<0>();

  // Sum the warp's token slots (they share the warp's running max), then
  // combine the four warps' partials in shared memory.
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int o = LPT; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
    float* mw = merge + (warp * GT + g) * (D + 2);
    if (slot == 0 && lane_live) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) mw[d0 + e] = acc[g][e];
    }
    if (lane == 0) {
      mw[D] = m[g];
      mw[D + 1] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GT * D; i += THREADS) {
    const int g = i / D, d = i % D;
    if (g0 + g >= G) continue;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      mm = fmaxf(mm, merge[(w * GT + g) * (D + 2) + D]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* mw = merge + (w * GT + g) * (D + 2);
      const float f = exp2f(mw[D] - mm);
      a += mw[d] * f;
      ll += mw[D + 1] * f;
    }
    const size_t row = (((size_t)b * KVH + h) * S + s) * G + g0 + g;
    acc_out[row * D + d] = a;
    if (d == 0) {
      // merge_splits combines splits with natural exponents.
      m_out[row] = mm <= 0.5f * NEG_INF ? NEG_INF : mm * LN2;
      l_out[row] = ll;
    }
  }
}

template <typename QT, typename PT, int D, int GT>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const int* tables,
                   const int* n_valid, float* acc, float* m, float* l, int B,
                   int KVH, int G, int BS, int W, int S, int pps,
                   cudaStream_t stream) {
  const size_t smem =
      (size_t)STAGES * stage_bytes(BS, D, sizeof(PT),
                                   std::is_same<PT, int8_t>::value) +
      (size_t)NW * GT * (D + 2) * sizeof(float) + (size_t)pps * sizeof(int);
  auto kern = paged_decode_kernel<QT, PT, D, GT>;
  cudaError_t e = repro::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * KVH, S, (G + GT - 1) / GT);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), tables, n_valid, acc, m, l, KVH,
      G, BS, W, pps);
  return cudaGetLastError();
}

// The logsumexp combine of the split partials (ops.merge_splits on the
// card): one block per (row, kv-head, query head), one thread per output
// element.  Dead splits carry (acc 0, m NEG_INF, l 0); a row with no live
// position merges to zeros.
__global__ void merge_splits_kernel(const float* __restrict__ acc,  // [BH, S, G, D]
                                    const float* __restrict__ m,    // [BH, S, G]
                                    const float* __restrict__ l,
                                    float* __restrict__ out,        // [BH, G, D]
                                    int S, int G, int D) {
  const int bh = blockIdx.x / G, g = blockIdx.x % G;
  const size_t base = (size_t)bh * S * G + g;   // split s at base + s * G
  float mm = NEG_INF;
  for (int s = 0; s < S; ++s) mm = fmaxf(mm, m[base + (size_t)s * G]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f, ll = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t i = base + (size_t)s * G;
      const float f = expf(m[i] - mm);
      ll += l[i] * f;
      a += acc[i * D + d] * f;
    }
    out[(size_t)blockIdx.x * D + d] = a / fmaxf(ll, 1e-30f);
  }
}

#define REPRO_DECODE_ARGS \
  q, kp, vp, ks, vs, tables, n_valid, acc, m, l, B, KVH, G, BS, W, S, pps, st

template <typename QT, typename PT, int D>
cudaError_t by_gt(const void* q, const void* kp, const void* vp,
                  const void* ks, const void* vs, const int* tables,
                  const int* n_valid, float* acc, float* m, float* l, int B,
                  int KVH, int G, int BS, int W, int S, int pps,
                  cudaStream_t st) {
  if (G <= 1) return launch<QT, PT, D, 1>(REPRO_DECODE_ARGS);
  if (G <= 2) return launch<QT, PT, D, 2>(REPRO_DECODE_ARGS);
  if (G <= 4) return launch<QT, PT, D, 4>(REPRO_DECODE_ARGS);
  return launch<QT, PT, D, 8>(REPRO_DECODE_ARGS);
}

template <typename QT, typename PT>
cudaError_t by_d(int D, const void* q, const void* kp, const void* vp,
                 const void* ks, const void* vs, const int* tables,
                 const int* n_valid, float* acc, float* m, float* l, int B,
                 int KVH, int G, int BS, int W, int S, int pps,
                 cudaStream_t st) {
  switch (D) {
    case 32: return by_gt<QT, PT, 32>(REPRO_DECODE_ARGS);
    case 64: return by_gt<QT, PT, 64>(REPRO_DECODE_ARGS);
    case 128: return by_gt<QT, PT, 128>(REPRO_DECODE_ARGS);
    case 160: return by_gt<QT, PT, 160>(REPRO_DECODE_ARGS);
    case 256: return by_gt<QT, PT, 256>(REPRO_DECODE_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t by_page(int page_dtype, int D, const void* q, const void* kp,
                    const void* vp, const void* ks, const void* vs,
                    const int* tables, const int* n_valid, float* acc,
                    float* m, float* l, int B, int KVH, int G, int BS, int W,
                    int S, int pps, cudaStream_t st) {
  switch (page_dtype) {
    case repro::kF32: return by_d<QT, float>(D, REPRO_DECODE_ARGS);
    case repro::kBF16: return by_d<QT, __nv_bfloat16>(D, REPRO_DECODE_ARGS);
    case repro::kI8: return by_d<QT, int8_t>(D, REPRO_DECODE_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_attention_launch(
    const void* q, int q_dtype, const void* k_pages, const void* v_pages,
    int page_dtype, const void* k_scale, const void* v_scale,
    const void* tables, const void* n_valid, void* acc, void* m, void* l,
    int B, int KVH, int G, int D, int BS, int W, int S, int pps,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* nv = static_cast<const int*>(n_valid);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  cudaError_t e;
  if (q_dtype == repro::kF32)
    e = by_page<float>(page_dtype, D, q, k_pages, v_pages, k_scale, v_scale, t, nv, a, mm, ll, B, KVH, G, BS, W, S, pps, st);
  else if (q_dtype == repro::kBF16)
    e = by_page<__nv_bfloat16>(page_dtype, D, q, k_pages, v_pages, k_scale, v_scale, t, nv, a, mm, ll, B, KVH, G, BS, W, S, pps, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

extern "C" int merge_splits_launch(const void* acc, const void* m,
                                   const void* l, void* out, int BH, int S,
                                   int G, int D, void* stream) {
  merge_splits_kernel<<<BH * G, D < 128 ? D : 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<float*>(out), S, G, D);
  return (int)cudaGetLastError();
}
