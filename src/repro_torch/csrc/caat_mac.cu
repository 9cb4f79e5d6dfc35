// Behavioural CAAT macro tile for Hopper (sm_90a): the analog MAC of one
// macro invocation (R rows) with the chip's sampled capacitor mismatch,
// then its single ideal ADC conversion and fused ReLU.
//
// Replaces the Pallas TPU kernel `caat_mac_kernel`
// (src/repro/kernels/caat_mac/kernel.py, body `_kernel`) together with its
// wrapper's W_eff fold, taken exactly (kernels/caat_mac/ops.py):
//   count[k,i] = sum_{r<R} a_k[r] * w_i[r]              (exact, int32)
//   acc        = sum_{k<9} sum_{i<9} W_eff[k,i] * count[k,i]   (float64)
//   code       = clip(rint((f32(acc) * inv_m + off) * fs_ratio * 128),
//                     -128, 127), ReLU'd when scalars[3] > 0, as int32,
// with a_k the +/-1 planes of the int8 activations (offset binary: with
// u = a + 128, plane k < 7 is bit 7 - k of u, plane 7 bit 0, plane 8 -1)
// and w_i the weights' +/-1 planes, packed by the wrapper.  The constant
// plane 8 leaves 64 real products: count[k,8] = R - 2 * popcount of plane
// k's bits, count[8,i] = -w_sum[i] (the wrapper's column sums), count[8,8]
// = R.  The 81 terms are added k outer, i inner, each multiply and add
// rounded on its own (__dmul_rn / __dadd_rn), as the plain version does,
// so the two give equal codes.
//
// What bounds it on this card: 2 * 64 * B * R * N int8 operations on
// B * R + 8 * R * N bytes; at conv2 (B = 32768, R = 1152, N = 128) 6.2e11
// operations (0.31 ms at the 1979 TOP/s int8 tensor-core rate) against 56
// MB moved (0.017 ms at 3.35 TB/s): the tensor cores bound it.
//
// Design.  Tokens are wgmma's M: a block is two warpgroups of 64 tokens
// each, whose 128 x R activation bytes stay resident in shared memory
// (rows padded to an odd multiple of 16 bytes, so the fragment loads are
// bank-conflict free).  The +/-1 activation plane is wgmma's register A
// operand, made from each 32-bit word of raw bytes in registers, two
// planes per pass over R from the same loads; the plane row sums are
// popcounts of the resident rows, made once per block.  wgmma's N is 8
// weight planes x 16 columns = 128: one packed weight group streams through
// a 4-stage ring of 16-byte cp.async copies tracked by mbarriers
// (int8_wgmma.cuh's), once per pass, and both warpgroups multiply each
// landed stage.  The planes of the next stage are made while the current
// stage's wgmma runs.  Each thread's accumulator then holds, for its two
// tokens and four columns, the counts of every weight plane i, so the
// float64 combine runs in registers without any exchange: after each pass
// for planes k, k+1, and for k = 8 before the conversion of a 16-column
// group.  Column groups are spread over blocks (grid y) until the grid
// holds about two blocks per SM, so small batches still fill the card.
// Rows past R in the last k32 step meet zero weight bytes (the copies
// zero-fill them) and so count nothing.
//
// Tiling, in the order it was measured (PERF.md): one warpgroup of
// 64 tokens looping over every group was held by small batches; two
// warpgroups sharing each weight stage and groups spread over the grid
// fixed that; overlapping plane making with wgmma, and a copy schedule of
// two 16-byte copies per thread with no divisions, made it faster again.
// What holds it now is a fixed stall in each pass, independent of its
// stage count, not yet understood.

#include "int8_wgmma.cuh"

namespace {

namespace wg = repro::wg;

constexpr int WGS = 2;             // warpgroups per block
constexpr int THREADS = WGS * wg::THREADS;
constexpr int BM = 64 * WGS;       // tokens per block (one m64 tile each)
constexpr int COLS = 16;           // weight columns per packed group
constexpr int BN = 8 * COLS;       // wgmma N: 8 weight planes x 16 columns
constexpr int BK = wg::BK;         // R bytes per ring stage
constexpr int KP = 2;              // activation planes per pass over R
constexpr int PASSES = 8 / KP;
constexpr int STAGES = 4;
constexpr int STAGE = BN * BK;     // 8 KB of packed weight planes
constexpr int SLACK = 64;          // the last k32 step may read past R
// The largest R (a multiple of 64) whose resident rows fit beside the ring.
constexpr int MAX_R = 1472;

// Activation row stride: an odd multiple of 16 bytes, so the 8 rows of a
// fragment load fall in distinct banks.
__host__ __device__ constexpr int row_stride(int R) { return R | 16; }

__host__ __device__ constexpr int smem_bytes(int R) {
  return STAGES * STAGE + BM * row_stride(R) + SLACK + BM * 8 * 4 +
         81 * 8 + STAGES * 8;
}

// Bit position of activation plane k in u = a + 128.
__device__ __forceinline__ int plane_shift(int k) { return k < 7 ? 7 - k : 0; }

__global__ void __launch_bounds__(THREADS, 1)
caat_mac_kernel(const int8_t* __restrict__ a, long long lda,
                const int8_t* __restrict__ w, const int* __restrict__ w_sum,
                const double* __restrict__ w_eff,
                const float* __restrict__ scalars, int32_t* __restrict__ out,
                int B, int R, int N, int group_chunk) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int S = row_stride(R);
  uint8_t* sa = smem + STAGES * STAGE;
  int* spop = reinterpret_cast<int*>(sa + BM * S + SLACK);   // [BM][8]
  double* weff = reinterpret_cast<double*>(spop + BM * 8);
  uint64_t* bars = reinterpret_cast<uint64_t*>(weff + 81);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int all_groups = (N + COLS - 1) / COLS;
  const int grp0 = blockIdx.y * group_chunk;
  const int groups = min(group_chunk, all_groups - grp0);
  const int nr = (R + BK - 1) / BK;   // ring steps per pass
  const int steps = groups * PASSES * nr;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) wg::mbar_init(&bars[s], THREADS);
    wg::fence_barrier_init();
  }
  for (int i = tid; i < 81; i += THREADS) weff[i] = w_eff[i];
  const int chunks = R / 16;
  for (int i = tid; i < BM * chunks; i += THREADS) {
    const int r = i / chunks, c = i % chunks;
    const bool ok = m0 + r < B;
    repro::cp_async16(sa + r * S + c * 16,
                      ok ? a + (size_t)(m0 + r) * lda + c * 16 : a, ok);
  }
  repro::cp_async_commit();
  __syncthreads();   // the barriers are initialised

  // The ring.  Blocks start their walk over groups and over R at different
  // places (the counts do not depend on that order), so that the blocks
  // running together read different weight lines.  Every thread copies
  // CPT of a stage's 512 16-byte chunks: rows tid / 4 + c * THREADS / 4.
  const int rot = blockIdx.x % nr, grot = blockIdx.x % groups;
  const int crow = tid >> 2, cbyte = (tid & 3) * 16;
  const int cdst = (crow >> 3) * (BK / 16 * 128) + (tid & 3) * 128 +
                   (crow & 7) * 16;
  const int8_t* csrc = w + (size_t)crow * R + cbyte;
  constexpr int CPT = BN * BK / 16 / THREADS;
  int ld_step = 0, ld_grp = grp0 + grot, ld_pass = 0, ld_rs = 0, ld_rr = rot;
  auto load_next = [&]() {   // stage ld_step: r-step ld_rr of group ld_grp
    uint8_t* st = smem + (ld_step % STAGES) * STAGE;
    const bool ok = ld_rr * BK + cbyte < R;
    const int8_t* src = csrc + (size_t)ld_grp * BN * R + ld_rr * BK;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      repro::cp_async16(st + cdst + c * (THREADS / 32) * (BK / 16 * 128),
                        ok ? src + (size_t)c * (THREADS / 4) * R : w, ok);
    wg::mbar_arrive_cp_async(&bars[ld_step % STAGES]);
    ++ld_step;
    if (++ld_rr == nr) ld_rr = 0;
    if (++ld_rs == nr) {
      ld_rs = 0;
      ld_rr = rot;
      if (++ld_pass == PASSES) {
        ld_pass = 0;
        if (++ld_grp == grp0 + groups) ld_grp = grp0;
      }
    }
  };
  auto wait = [&](int s) {
    wg::mbar_wait(&bars[s % STAGES], (uint32_t)(s / STAGES) & 1u);
    wg::fence_proxy_async();
  };
  while (ld_step < STAGES && ld_step < steps) load_next();
  repro::cp_async_wait<0>();   // the resident rows (not the ring's copies)
  __syncthreads();

  // Each row's count of set bits in each plane (its +/-1 row sum is
  // 2 * count - R), once for all groups: two threads per row.
  {
    const int r = tid >> 1;
    int pc[8] = {};
    for (int c = (tid & 1) * 4; c < R; c += 8) {
      const uint32_t u =
          *reinterpret_cast<const uint32_t*>(sa + r * S + c) ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        pc[k] += __popc((u >> plane_shift(k)) & 0x01010101u);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      pc[k] += __shfl_xor_sync(0xffffffffu, pc[k], 1);
      if (!(tid & 1)) spop[r * 8 + k] = pc[k];
    }
  }
  __syncthreads();

  const int row = warp * 16 + g;   // this thread's tokens: row, row + 8
                                   // (warps 4-7: warpgroup 1's 64 tokens)
  const uint8_t* arow = sa + row * S + 4 * t;
  const float inv_m = scalars[0], off = scalars[1], fs_ratio = scalars[2];
  const bool relu = scalars[3] > 0.f;

  int step = 0, grp = grp0 + grot;
  for (int j = 0; j < groups; ++j) {
    double acc64[2][2][2];   // [token row + 8?][column half][column pair]
#pragma unroll
    for (int q = 0; q < 8; ++q) (&acc64[0][0][0])[q] = 0.0;

    for (int pass = 0; pass < PASSES; ++pass) {
      int acc[KP][64];
#pragma unroll
      for (int p = 0; p < KP; ++p)
#pragma unroll
        for (int q = 0; q < 64; ++q) acc[p][q] = 0;
      int shift[KP];
#pragma unroll
      for (int p = 0; p < KP; ++p) shift[p] = plane_shift(pass * KP + p);

      // The +/-1 planes of the R bytes at r0 .. r0 + 63, into f.
      auto build = [&](int r0, uint32_t (&f)[2][KP][4]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kb = r0 + 32 * h;
          uint32_t u[4];
          u[0] = *reinterpret_cast<const uint32_t*>(arow + kb);
          u[1] = *reinterpret_cast<const uint32_t*>(arow + 8 * S + kb);
          u[2] = *reinterpret_cast<const uint32_t*>(arow + kb + 16);
          u[3] = *reinterpret_cast<const uint32_t*>(arow + 8 * S + kb + 16);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            u[q] ^= 0x80808080u;
#pragma unroll
            for (int p = 0; p < KP; ++p) {
              const uint32_t y = (u[q] >> shift[p]) & 0x01010101u;
              f[h][p][q] = ((y ^ 0x01010101u) * 0xFFu) | 0x01010101u;
            }
          }
        }
      };
      // Multiply the stage of `step` (planes in fc) while the planes of
      // the next r-step are made into fn, then refill the stage.
      int rr = rot;
      auto body = [&](int rs, uint32_t (&fc)[2][KP][4],
                      uint32_t (&fn)[2][KP][4]) {
        const uint32_t sw = repro::smem_u32(smem + step % STAGES * STAGE);
#pragma unroll
        for (int p = 0; p < KP; ++p)
#pragma unroll
          for (int q = 0; q < 64; ++q) wg::fence_operand(acc[p][q]);
        wg::wgmma_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int p = 0; p < KP; ++p)
            wg::Wgmma<BN>::mma(acc[p], fc[h][p], wg::b_desc(sw + h * 256));
        wg::wgmma_commit();
        if (++rr == nr) rr = 0;
        if (rs + 1 < nr) {
          wait(step + 1);
          build(rr * BK, fn);
        }
        wg::wgmma_wait_all();
#pragma unroll
        for (int p = 0; p < KP; ++p)
#pragma unroll
          for (int q = 0; q < 64; ++q) wg::fence_operand(acc[p][q]);
        __syncthreads();   // every thread is done with this stage
        if (ld_step < steps) load_next();
        ++step;
      };
      uint32_t fa[2][KP][4], fb[2][KP][4];
      wait(step);
      build(rr * BK, fa);
      for (int rs = 0; rs < nr; rs += 2) {
        body(rs, fa, fb);
        if (rs + 1 < nr) body(rs + 1, fb, fa);
      }

      // The combine of planes k = pass * KP + p, i = 0 .. 8 in order.
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        const int k = pass * KP + p;
        const double* wk = weff + k * 9;
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row_sum = R - 2 * spop[(row + 8 * rh) * 8 + k];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              double v = acc64[rh][h][b];
#pragma unroll
              for (int i = 0; i < 8; ++i)
                v = __dadd_rn(v, __dmul_rn(wk[i],
                                           (double)acc[p][4 * (2 * i + h) +
                                                          2 * rh + b]));
              v = __dadd_rn(v, __dmul_rn(wk[8], (double)row_sum));
              acc64[rh][h][b] = v;
            }
        }
      }
    }

    // Plane k = 8 (constant -1), then the single conversion.
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int n = grp * COLS + 8 * h + 2 * t + b;
        int cs[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cs[i] = n < N ? w_sum[i * N + n] : 0;
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          double v = acc64[rh][h][b];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v = __dadd_rn(v, __dmul_rn(weff[72 + i], (double)(-cs[i])));
          v = __dadd_rn(v, __dmul_rn(weff[80], (double)R));
          const int token = m0 + row + 8 * rh;
          if (token >= B || n >= N) continue;
          const float sum = __double2float_rn(v);
          const float u =
              __fmul_rn(__fadd_rn(__fmul_rn(sum, inv_m), off), fs_ratio);
          float code = rintf(__fmul_rn(u, 128.f));
          code = fminf(fmaxf(code, -128.f), 127.f);
          if (relu) code = fmaxf(code, 0.f);
          out[(size_t)token * N + n] = (int32_t)code;
        }
      }
    if (++grp == grp0 + groups) grp = grp0;
  }
}

}  // namespace

// a: int8 [B, R] rows `lda` bytes apart (16-byte aligned); w: the packed
// planes [ceil(N / 16), 8, 16, R] int8; w_sum [8, N] int32; w_eff [9, 9]
// float64; scalars [4] f32; out [B, N] int32.  R a multiple of 16, at most
// MAX_R.
extern "C" int caat_mac_launch(const void* a, long long lda, const void* w,
                               const void* w_sum, const void* w_eff,
                               const void* scalars, void* out, int B, int R,
                               int N, void* stream) {
  if (R % 16 || R <= 0 || R > MAX_R) return (int)cudaErrorInvalidValue;
  cudaError_t e = wg::opt_in(caat_mac_kernel, smem_bytes(MAX_R));
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // Column groups are split over blocks until about two blocks per SM.
  const int tiles = (B + BM - 1) / BM, groups = (N + COLS - 1) / COLS;
  const int want = min(groups, max(1, (2 * sms + tiles - 1) / tiles));
  const int chunk = (groups + want - 1) / want;
  const dim3 grid(tiles, (groups + chunk - 1) / chunk);
  caat_mac_kernel<<<grid, THREADS, smem_bytes(R),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), lda, static_cast<const int8_t*>(w),
      static_cast<const int*>(w_sum), static_cast<const double*>(w_eff),
      static_cast<const float*>(scalars), static_cast<int32_t*>(out), B, R,
      N, chunk);
  return (int)cudaGetLastError();
}
