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
// become the limit.
//
// Design (simple first): one thread block per (row, kv-head, split) with
// one warp per query head of the GQA group (G*32 threads).  The TPU
// grid's sequential page axis becomes a loop inside the block: the block
// stages one page of K and V for its kv-head in shared memory (dequantized
// to f32 on the load, so a page is read from device memory once and never
// exists in fp outside the SM), then each warp scores its head against the
// page's tokens (lane-partial dot products + a butterfly sum) and updates
// its running (m, l, acc) in registers, each lane owning D/32 output
// elements.  Pages past the row's live length are never read.  The number
// of splits comes from the wrapper; no cp.async/TMA double buffering yet.

#include "common.cuh"

using repro::to_f32;
using repro::warp_sum;

namespace {

constexpr float NEG_INF = -1e30f;

template <typename QT, typename PT, int DPL>
__global__ void paged_decode_kernel(
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
  constexpr int D = 32 * DPL;
  extern __shared__ float smem[];
  float* sk = smem;                // [BS, D]
  float* sv = smem + BS * D;       // [BS, D]
  float* ss = smem + 2 * BS * D;   // [G, BS] scores

  const int S = gridDim.y;
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH, s = blockIdx.y;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;

  float qr[DPL], acc[DPL];
  const QT* qp = q + (((size_t)b * KVH + h) * G + g) * D;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    qr[j] = to_f32(qp[lane + 32 * j]);
    acc[j] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  const float sqrt_d = sqrtf((float)D);
  const int nv = n_valid[b];
  const int p_end = min((s + 1) * pps, W);

  for (int p = s * pps; p < p_end && p * BS < nv; ++p) {
    const int blk = tables[(size_t)b * W + p];
    __syncthreads();   // the previous page's readers are done
    for (int i = threadIdx.x; i < BS * D; i += nthreads) {
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

    float mx = NEG_INF;
    for (int tk = 0; tk < BS; ++tk) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) part += qr[j] * sk[tk * D + lane + 32 * j];
      float sc = warp_sum(part) / sqrt_d;
      if (p * BS + tk >= nv) sc = NEG_INF;
      mx = fmaxf(mx, sc);
      if (lane == 0) ss[g * BS + tk] = sc;
    }
    __syncwarp();
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= alpha;
    for (int tk = 0; tk < BS; ++tk) {
      const float pr = (p * BS + tk < nv) ? expf(ss[g * BS + tk] - m_new) : 0.f;
      psum += pr;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[j] += pr * sv[tk * D + lane + 32 * j];
    }
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();   // ss is rewritten by this warp on the next page
  }

  const size_t row = (((size_t)b * KVH + h) * S + s) * G + g;
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc_out[row * D + lane + 32 * j] = acc[j];
  if (lane == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
}

template <typename QT, typename PT, int DPL>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const int* tables,
                   const int* n_valid, float* acc, float* m, float* l, int B,
                   int KVH, int G, int BS, int W, int S, cudaStream_t stream) {
  constexpr int D = 32 * DPL;
  const size_t smem = (size_t)(2 * BS * D + G * BS) * sizeof(float);
  auto kern = paged_decode_kernel<QT, PT, DPL>;
  cudaError_t e = repro::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int pps = (W + S - 1) / S;
  dim3 grid(B * KVH, S);
  kern<<<grid, G * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), tables, n_valid, acc, m, l, KVH,
      G, BS, W, pps);
  return cudaGetLastError();
}

template <typename QT, typename PT>
cudaError_t by_dpl(int dpl, const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const int* tables,
                   const int* n_valid, float* acc, float* m, float* l, int B,
                   int KVH, int G, int BS, int W, int S, cudaStream_t st) {
  switch (dpl) {
    case 1: return launch<QT, PT, 1>(q, kp, vp, ks, vs, tables, n_valid, acc, m, l, B, KVH, G, BS, W, S, st);
    case 2: return launch<QT, PT, 2>(q, kp, vp, ks, vs, tables, n_valid, acc, m, l, B, KVH, G, BS, W, S, st);
    case 4: return launch<QT, PT, 4>(q, kp, vp, ks, vs, tables, n_valid, acc, m, l, B, KVH, G, BS, W, S, st);
    case 8: return launch<QT, PT, 8>(q, kp, vp, ks, vs, tables, n_valid, acc, m, l, B, KVH, G, BS, W, S, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t by_page(int page_dtype, int dpl, const void* q, const void* kp,
                    const void* vp, const void* ks, const void* vs,
                    const int* tables, const int* n_valid, float* acc,
                    float* m, float* l, int B, int KVH, int G, int BS, int W,
                    int S, cudaStream_t st) {
  switch (page_dtype) {
    case repro::kF32: return by_dpl<QT, float>(dpl, q, kp, vp, ks, vs, tables, n_valid, acc, m, l, B, KVH, G, BS, W, S, st);
    case repro::kBF16: return by_dpl<QT, __nv_bfloat16>(dpl, q, kp, vp, ks, vs, tables, n_valid, acc, m, l, B, KVH, G, BS, W, S, st);
    case repro::kI8: return by_dpl<QT, int8_t>(dpl, q, kp, vp, ks, vs, tables, n_valid, acc, m, l, B, KVH, G, BS, W, S, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_attention_launch(
    const void* q, int q_dtype, const void* k_pages, const void* v_pages,
    int page_dtype, const void* k_scale, const void* v_scale,
    const void* tables, const void* n_valid, void* acc, void* m, void* l,
    int B, int KVH, int G, int D, int BS, int W, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dpl = D / 32;
  if (D % 32 != 0) return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* nv = static_cast<const int*>(n_valid);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  cudaError_t e;
  if (q_dtype == repro::kF32)
    e = by_page<float>(page_dtype, dpl, q, k_pages, v_pages, k_scale, v_scale, t, nv, a, mm, ll, B, KVH, G, BS, W, S, st);
  else if (q_dtype == repro::kBF16)
    e = by_page<__nv_bfloat16>(page_dtype, dpl, q, k_pages, v_pages, k_scale, v_scale, t, nv, a, mm, ll, B, KVH, G, BS, W, S, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
