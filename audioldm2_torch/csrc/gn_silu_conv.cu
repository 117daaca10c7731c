// K1: GroupNorm + SiLU + 3x3 SAME conv, the UNet and VAE ResBlock body,
// and K1q, its int8-weight variant.
//
// K1 replaces audioldm2_tpu/ops/resblock_pallas.py: gn_silu_conv3x3 (:130),
// gn_silu_conv3x3_cat (:282), gn_silu_conv3x3_tiled (:426) and
// gn_silu_conv3x3_cat_tiled (:520). K1q replaces gn_silu_conv3x3_q (:157,
// kernel _kernel_q :62): int8 taps [3, 3, Cin, Cout] with a per-output-
// channel f32 scale applied once to the f32 accumulator, and the activation
// rounded to bf16 whatever x's dtype (:73-74). The four Pallas K1 variants
// exist only because of the TPU's 16 MB scoped VMEM; here they are one
// design of two launches, and the concat [x1 ; x2] of the decoder stays two
// pointers (a GroupNorm group may straddle the split).
//
// 1. a2k_gn_stats (also K1q's and K6's): a split, coalesced reduction. A
//    grid of (row chunks, batch), a chunk being eight rows for each thread
//    (ops/_build.py: gn_stats_chunks); each block reads whole rows of
//    [x1 ; x2] (16-byte loads, eight consecutive channels a thread, its
//    eight rows in flight at once and held in registers) and forms, per
//    group, the chunk's mean and centred sum of squares M2 (two passes over
//    the registers; group sums by whole warps in a fixed order). The
//    last block of a sample to finish (a ticket from one atomic per sample
//    on a counter that it resets, behind one release fence a block)
//    combines the chunks by Chan's formula in double in a fixed tree (8
//    lanes per group, all groups at once, loads in batches), so the result
//    does not depend on which block finishes last, and writes the folded
//    per-(B, C) affine
//    a = rstd * gamma, c = beta - mean * a. Two-pass per chunk, centred
//    combination: no E[x^2] - mean^2 cancellation at the VAE's S = 65536.
//    gamma and beta are read as stored (f32 or bf16).
// 2. a2k_gn_silu_conv3x3_bf16: an NHWC implicit GEMM on K3's main loop
//    (lnmm.cu). A block owns a tile of tt x ft output positions of one
//    sample (BM rows of the product) and a strip of Cout tiles of width BN.
//    For each chunk of 64 input channels the halo'd patch, (tt + 2) x
//    (ft + 2) positions, comes into shared memory by cp.async with the
//    chunk's a and c, and is activated once, in place: silu(x * a + c) in
//    f32, rounded once to bf16, and zero outside [0, T) x [0, F), which is
//    SAME padding of the activated tensor. The nine taps are nine shifted
//    views of the patch: every ldmatrix lane gives the address of its own
//    output row's patch position plus the tap's offset, so a tap's A
//    fragment is a gather of patch rows with no copy. The weight [9 Cin,
//    Cout] streams as [64, BN] tiles through a cp.async ring that runs over
//    the strip's (N tile, chunk, tap) sequence; the next chunk's patch goes
//    into the other of two buffers at this chunk's first tap, so it is in
//    flight during this chunk's nine tiles of products. Products by mma.sync
//    m16n8k16 (f32 accumulation), epilogue from registers: + bias (read as
//    stored) in f32, one rounding, 16-byte stores.
//    Small M (the UNet's deep levels: 128 rows at 32 x 2 and CFG batch 2)
//    splits the input channels over the blocks of a thread-block cluster of
//    up to 8 (gridDim.z): each block leaves its f32 tile in its own shared
//    memory, and after a cluster barrier every block sums its share of rows
//    over the cluster's tiles through distributed shared memory, in rank
//    order (deterministic), with no workspace in device memory and no
//    second launch.
//    The launch plan (tile geometry, stages, strip, split) is chosen in
//    Python, ops/_build.py: gn_silu_conv_plan.
//
// Bounds on the H100: at the UNet's shapes the conv does 9 Cin MACs per
// output element and is bound by the tensor cores (the deep levels by the
// weight bytes and the latency of few blocks); at the VAE decoder's
// 1024 x 64 levels the activation adds one expf per patch element per
// N tile, 1.2 to 1.6 times the tile's positions, where the shared core
// (below) evaluated it for every tap and every 64-wide N tile.
//
// K1q in bf16 runs the same statistics pass and the same conv kernel with
// TW = int8_t: the weight [9 Cin, Cout] streams as int8 [64, BN] tiles (half
// K1's bytes: the stream every block re-reads), each converted once, a step
// ahead of its products, into one of two bf16 staging tiles that the
// unchanged ldmatrix.trans path reads (exact: |q| <= 127). A slot is free
// once its tile is converted, so the ring keeps one tile more in flight; the
// staging tiles need no barrier beyond the ring's one a tile. The epilogue
// (or, split over a cluster, the cluster sum) forms acc * wscale + bias in
// f32 and rounds once, the rounding points of _kernel_q. It replaces the
// shared core's K1q, which evaluated silu(x * a + c) of a shifted tap for
// every tap and every 64-wide N tile and split K through a workspace.
//
// The shared GEMM core (common.cuh) keeps K1 and K1q in f32 (the sr path's
// VAE encode, on the FMA units), and the shapes the plans decline (channels
// no multiple of 8, K1q's Cout no multiple of 16, unaligned pointers): its A
// prologue computes silu(x * a + c) of a shifted tap as the tile loads.
#include <cooperative_groups.h>

#include "common.cuh"

namespace a2k {

// ---------------------------------------------------------------------------
// GroupNorm statistics, split over row chunks
// ---------------------------------------------------------------------------

constexpr int ST_THREADS = 256;
constexpr int ST_ROWS = 8;  // rows of a chunk each thread holds in registers

// Channels 8j..8j+7 of row `row` of [x1 ; x2] as f32 (zeros past Cin). VEC:
// C1 and C2 multiples of 8 and the pointers 16-byte aligned.
template <typename T, bool VEC>
__device__ __forceinline__ void gn_piece(const T* x1, const T* x2, size_t row, int j, int C1,
                                         int C2, float v[8]) {
  const int ch = 8 * j;
  if (VEC) {
    load8(ch < C1 ? x1 + row * C1 + ch : x2 + row * C2 + (ch - C1), v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = ch + i;
      v[i] = c < C1 ? to_f(x1[row * C1 + c]) : c < C1 + C2 ? to_f(x2[row * C2 + (c - C1)]) : 0.f;
    }
  }
}

// (n, mean, m2) of one part combined with (nb, mb, m2b) of another, by
// Chan's formula; a part with nb = 0 leaves it as it is.
__device__ __forceinline__ void chan_combine(double& n, double& mean, double& m2, double nb,
                                             double mb, double m2b) {
  if (nb == 0.0) return;
  const double tot = n + nb, w = nb / tot, d = mb - mean;
  mean += d * w;
  m2 += m2b + d * d * n * w;
  n = tot;
}

// Each group's sum over the block's per-thread partials psum [RP][8 * CPR]
// (its cg channels of every row lane), by a warp per group in a fixed order
// (lane-strided sums, then a butterfly): into out[g].
__device__ __forceinline__ void gn_group_sums(const float* psum, int RP, int CPR, int cg, int G,
                                              float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < G; g += ST_THREADS / 32) {
    float s = 0.f;
    for (int e = lane; e < cg * RP; e += 32)
      s += psum[(e / cg) * 8 * CPR + g * cg + e % cg];
    s = warp_sum(s);
    if (lane == 0) out[g] = s;
  }
}

// Grid (chunks, B): block (k, b) reduces rows [k * rows, min(S, (k + 1) *
// rows)) of sample b, rows <= ST_ROWS row lanes (a row lane: CPR threads of
// eight channels each, RP = ST_THREADS / CPR lanes, or one lane walking the
// pieces of a wider row). part: f32 [B, chunks, G, 2] (mean, M2 of each
// group over the chunk); counter: one zeroed unsigned per sample, left zeroed.
template <typename T, bool VEC>
__global__ void __launch_bounds__(ST_THREADS)
gn_stats_kernel(const T* __restrict__ x1, const T* __restrict__ x2, int S, int C1, int C2, int G,
                int rows, float eps, const void* __restrict__ gamma,
                const void* __restrict__ beta, bool p16, float* __restrict__ a_out,
                float* __restrict__ c_out, float* __restrict__ part,
                unsigned* __restrict__ counter) {
  extern __shared__ float st_sm[];
  __shared__ unsigned ticket;
  const int tid = threadIdx.x;
  const int b = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int Cin = C1 + C2, cg = Cin / G, CPR = (Cin + 7) / 8;
  const int r0 = chunk * rows, nr = min(S, r0 + rows) - r0;
  const bool wide = CPR > ST_THREADS;
  const int RP = wide ? 1 : ST_THREADS / CPR;
  const int rl = wide ? 0 : tid / CPR;
  const int j0 = wide ? tid : tid % CPR;
  float* psum = st_sm;                  // [RP][8 * CPR] per-thread partials
  float* gmean = st_sm + RP * 8 * CPR;  // [G]
  float* gm2 = gmean + G;               // [G]
  const size_t base = (size_t)b * S + r0;

  // The thread's rows rl, rl + RP, ... of the chunk for channels 8j..8j+7,
  // all loads in flight at once (rows past the chunk read its last row and
  // count as zeros). A thread has one piece j, held in registers for both
  // passes, unless a row has more pieces than the block has threads.
  auto load_rows = [&](int j, float v[ST_ROWS][8]) {
#pragma unroll
    for (int u = 0; u < ST_ROWS; ++u)
      gn_piece<T, VEC>(x1, x2, base + min(rl + u * RP, nr - 1), j, C1, C2, v[u]);
  };
  float v[ST_ROWS][8];
  for (int j = j0; rl < RP && j < CPR; j += ST_THREADS) {
    load_rows(j, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < ST_ROWS; ++u) s += rl + u * RP < nr ? v[u][i] : 0.f;
      psum[rl * 8 * CPR + 8 * j + i] = s;
    }
  }
  __syncthreads();
  gn_group_sums(psum, RP, CPR, cg, G, gmean);
  __syncthreads();
  for (int g = tid; g < G; g += ST_THREADS) gmean[g] /= (float)(nr * cg);
  __syncthreads();
  // centred squares about the chunk's group mean
  for (int j = j0; rl < RP && j < CPR; j += ST_THREADS) {
    if (wide) load_rows(j, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float m = 8 * j + i < Cin ? gmean[(8 * j + i) / cg] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < ST_ROWS; ++u) {
        const float d = rl + u * RP < nr && 8 * j + i < Cin ? v[u][i] - m : 0.f;
        s = fmaf(d, d, s);
      }
      psum[rl * 8 * CPR + 8 * j + i] = s;
    }
  }
  __syncthreads();
  gn_group_sums(psum, RP, CPR, cg, G, gm2);
  __syncthreads();
  for (int g = tid; g < G; g += ST_THREADS) {
    float* pp = part + (((size_t)b * chunks + chunk) * G + g) * 2;
    pp[0] = gmean[g];
    pp[1] = gm2[g];
  }
  __syncthreads();
  // one release by thread 0 covers the block's writes (the barrier orders
  // them before it, and PTX fences are cumulative); the last block's acquire
  // covers every block's
  if (tid == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    ticket = atomicAdd(counter + b, 1u);
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  if (ticket != (unsigned)(chunks - 1)) return;

  // The last block of sample b combines the chunks by Chan's formula in a
  // fixed tree: ST_THREADS / G lanes per group (8 for 32 groups, all groups
  // at once), lane l taking chunks l, l + lanes, ... in order, its loads in
  // batches, then the lanes by a butterfly; the group's first lane's result
  // does not depend on which block came last.
  const int lanes = ST_THREADS / G >= 32 ? 32 : ST_THREADS / G >= 16 ? 16 : ST_THREADS / G >= 8 ? 8
                    : ST_THREADS / G >= 4 ? 4 : ST_THREADS / G >= 2 ? 2 : 1;
  for (int g0 = 0; g0 < G; g0 += ST_THREADS / lanes) {
    const int g = g0 + tid / lanes, l = tid % lanes;
    double n = 0.0, mean = 0.0, m2 = 0.0;
    if (g < G) {
      for (int k0 = l; k0 < chunks; k0 += lanes * ST_ROWS) {
        float2 pm[ST_ROWS];  // ST_ROWS chunks' (mean, M2), loaded together, combined in order
#pragma unroll
        for (int u = 0; u < ST_ROWS; ++u) {
          const int k = min(k0 + lanes * u, chunks - 1);
          pm[u] = __ldcg(reinterpret_cast<const float2*>(
              part + (((size_t)b * chunks + k) * G + g) * 2));
        }
#pragma unroll
        for (int u = 0; u < ST_ROWS; ++u) {
          const int k = k0 + lanes * u;
          if (k < chunks)
            chan_combine(n, mean, m2, (double)(min(S, (k + 1) * rows) - k * rows) * cg,
                         (double)pm[u].x, (double)pm[u].y);
        }
      }
    }
    for (int o = lanes / 2; o > 0; o >>= 1) {  // within aligned groups of `lanes` lanes
      const double no = __shfl_xor_sync(0xffffffffu, n, o);
      const double mo = __shfl_xor_sync(0xffffffffu, mean, o);
      const double m2o = __shfl_xor_sync(0xffffffffu, m2, o);
      chan_combine(n, mean, m2, no, mo, m2o);
    }
    if (g < G && l == 0) {
      gmean[g] = (float)mean;
      gm2[g] = rsqrtf((float)(m2 / n) + eps);
    }
  }
  __syncthreads();
  for (int ch = tid; ch < Cin; ch += ST_THREADS) {
    const int g = ch / cg;
    const float gm = p16 ? to_f(static_cast<const bf16*>(gamma)[ch])
                         : static_cast<const float*>(gamma)[ch];
    const float bt = p16 ? to_f(static_cast<const bf16*>(beta)[ch])
                         : static_cast<const float*>(beta)[ch];
    const float av = gm2[g] * gm;  // rstd * gamma
    a_out[(size_t)b * Cin + ch] = av;
    c_out[(size_t)b * Cin + ch] = bt - gmean[g] * av;
  }
  if (tid == 0) counter[b] = 0u;
}

template <typename T>
static int gn_stats_impl(const void* x1, const void* x2, int B, int S, int C1, int C2, int G,
                         float eps, const void* gamma, const void* beta, bool p16, void* a_out,
                         void* c_out, void* part, int chunks, void* counter,
                         cudaStream_t stream) {
  const int Cin = C1 + C2, CPR = (Cin + 7) / 8;
  const int rows = (S + chunks - 1) / chunks;
  if ((chunks - 1) * rows >= S) return (int)cudaErrorInvalidValue;  // an empty chunk
  const int RP = CPR > ST_THREADS ? 1 : ST_THREADS / CPR;
  if (rows > ST_ROWS * RP) return (int)cudaErrorInvalidValue;  // more rows than the threads hold
  const size_t smem = ((size_t)RP * 8 * CPR + 2 * G) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const bool vec = C1 % 8 == 0 && C2 % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(x2)) & 15) == 0;
  dim3 grid(chunks, B);
  auto args = [&](auto kern) {
    kern<<<grid, ST_THREADS, smem, stream>>>(
        static_cast<const T*>(x1), static_cast<const T*>(x2), S, C1, C2, G, rows, eps, gamma,
        beta, p16, static_cast<float*>(a_out), static_cast<float*>(c_out),
        static_cast<float*>(part), static_cast<unsigned*>(counter));
  };
  if (vec)
    args(gn_stats_kernel<T, true>);
  else
    args(gn_stats_kernel<T, false>);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 conv: halo'd patch activated once per chunk, nine shifted views
// ---------------------------------------------------------------------------

constexpr int CV_CK = 64;         // input channels per chunk: the K depth of one tap's W tile
constexpr int CV_LD = CV_CK + 8;  // patch row stride, 144 bytes: ldmatrix rows on 8 bank groups
constexpr int CV_THREADS = 256;   // 8 warps
constexpr int CV_PAD = 8;         // elements of padding per W tile row
constexpr int CV_MAX_STAGES = 8;  // at most 10: a patch must land before its chunk's first tap
constexpr int CV_MAX_SPLITS = 8;  // the portable cluster size
constexpr int CV_MAX_SMEM = 232448;

// Shared memory of one block: two patch buffers, the chunk's a and c (two
// buffers), the W ring (K1q: two bf16 staging tiles and an int8 ring of rows
// padded by 16 bytes); the split epilogue's f32 tile reuses it.
__host__ __device__ inline size_t conv_smem_bytes(int BM, int BN, int tt, int ft, int stages,
                                                  int w_bytes = 2) {
  const size_t ring = w_bytes == 1
                          ? (size_t)2 * CV_CK * (BN + CV_PAD) * sizeof(bf16) +
                                (size_t)stages * CV_CK * (BN + 16)
                          : (size_t)stages * CV_CK * (BN + CV_PAD) * sizeof(bf16);
  const size_t main = (size_t)2 * (tt + 2) * (ft + 2) * CV_LD * sizeof(bf16) +
                      (size_t)4 * CV_CK * sizeof(float) + ring;
  const size_t epi = (size_t)BM * (BN + 4) * sizeof(float);
  return main > epi ? main : epi;
}

// TW: the weight's type, bf16 (K1) or int8 (K1q: the ring holds int8 tiles,
// each converted once into one of two bf16 staging tiles that the products
// read, and the per-output-channel scale wscale multiplies the f32 sums in
// the epilogue).
template <int BM, int BN, typename TW = bf16>
__global__ void __launch_bounds__(CV_THREADS)
gn_silu_conv_bf16_kernel(const bf16* __restrict__ x1, const bf16* __restrict__ x2,
                         const float* __restrict__ a, const float* __restrict__ c,
                         const TW* __restrict__ w, const float* __restrict__ wscale,
                         const void* __restrict__ bias, bool p16,
                         bf16* __restrict__ out, int T, int F, int C1, int C2, int Cout, int tt,
                         int ft, int strip_tiles, int stages, int chunks_per_split) {
  constexpr bool Q = std::is_same<TW, int8_t>::value;
  constexpr int WARPS_N = BN / 32, WARPS_M = (CV_THREADS / 32) / WARPS_N;
  constexpr int WM = BM / WARPS_M;  // rows per warp: 64, 32 or 16
  constexpr int MT = WM / 16;       // m16 tiles per warp; its 32 columns are 4 n8 tiles
  constexpr int B_LD = BN + CV_PAD;
  constexpr int W_STAGE = CV_CK * B_LD;
  constexpr int R_LD = Q ? BN + 16 : B_LD;  // a ring row, in TW elements (int8: 16 bytes of pad)
  constexpr int R_STAGE = CV_CK * R_LD;
  constexpr int CPR = BN * (int)sizeof(TW) / 16;  // 16-byte chunks per W tile row
  constexpr int W_ROWS = CV_THREADS / CPR;     // W tile rows one pass of the block copies

  extern __shared__ __align__(128) unsigned char cv_smem[];
  const int Cin = C1 + C2, n_chunks = (Cin + CV_CK - 1) / CV_CK;
  const int PW = ft + 2, P = (tt + 2) * PW;  // patch width and positions
  const int t_tiles = (T + tt - 1) / tt, f_tiles = (F + ft - 1) / ft;
  const int b = blockIdx.y / (t_tiles * f_tiles);
  const int tile = blockIdx.y % (t_tiles * f_tiles);
  const int t0 = (tile / f_tiles) * tt, f0 = (tile % f_tiles) * ft;
  const int kc0 = blockIdx.z * chunks_per_split;
  const int nk = min(n_chunks, kc0 + chunks_per_split) - kc0;  // this block's chunks
  const int n_tiles = (Cout + BN - 1) / BN;
  const int tile0 = blockIdx.x * strip_tiles;
  const int my_tiles = min(strip_tiles, n_tiles - tile0);
  const int per_nt = 9 * nk;           // W tiles of one N tile
  const int total = my_tiles * per_nt;  // ... of the strip

  bf16* patch = reinterpret_cast<bf16*>(cv_smem);               // [2][P][CV_LD]
  float* ac = reinterpret_cast<float*>(patch + 2 * P * CV_LD);  // [2][a, c][CV_CK]
  // the ring, stages x [CV_CK][B_LD]; K1q: two staging tiles, then the ring
  bf16* Ws = reinterpret_cast<bf16*>(ac + 4 * CV_CK);
  TW* Wr;  // the ring: stages x [CV_CK][R_LD]
  if constexpr (Q)
    Wr = reinterpret_cast<TW*>(Ws + 2 * W_STAGE);
  else
    Wr = Ws;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  // The raw patch of the strip's chunk number `seq` (chunk seq % nk) and its
  // a, c into buffer seq & 1, without a commit: chunk 0's before the ring
  // starts, chunk s + 1's with the W tile issued at chunk s's first tap, so
  // a patch is in flight for nine tiles before its activation.
  auto load_patch = [&](int seq) {
    const int ch0 = (kc0 + seq % nk) * CV_CK;
    bf16* dst = patch + (size_t)(seq & 1) * P * CV_LD;
    for (int idx = tid; idx < P * (CV_CK / 8); idx += CV_THREADS) {
      const int p = idx >> 3, q = idx & 7;
      const int tq = t0 - 1 + p / PW, fq = f0 - 1 + p % PW, ch = ch0 + q * 8;
      const bool ok = tq >= 0 && tq < T && fq >= 0 && fq < F && ch < Cin;
      const size_t row = ((size_t)b * T + tq) * F + fq;
      const bf16* src = !ok ? x1 : ch < C1 ? x1 + row * C1 + ch : x2 + row * C2 + (ch - C1);
      cp_async16(dst + p * CV_LD + q * 8, src, ok);
    }
    if (tid < CV_CK / 2) {  // 16 copies of four floats of a, then 16 of c
      const int which = tid / (CV_CK / 4), ch = ch0 + (tid % (CV_CK / 4)) * 4;
      const bool ok = ch < Cin;
      const float* src = (which ? c : a) + (size_t)b * Cin + ch;
      cp_async16(ac + (seq & 1) * 2 * CV_CK + which * CV_CK + (tid % (CV_CK / 4)) * 4,
                 ok ? src : a, ok);
    }
  };

  // The strip's W tiles, N tile by N tile, chunk by chunk, tap by tap, go
  // round the ring; load_next() starts the next one (or nothing past the
  // last) and commits a group either way.
  const int w_r = tid / CPR, w_c = (tid % CPR) * (16 / (int)sizeof(TW));
  int ld = 0, ld_nt = 0, ld_kc = 0, ld_tap = 0, ld_slot = 0;
  auto load_next = [&]() {
    if (ld < total) {
      const int ch0 = (kc0 + ld_kc) * CV_CK;
      const int n0 = (tile0 + ld_nt) * BN;
      const bool n_ok = n0 + w_c < Cout;
      const TW* src = w + ((size_t)ld_tap * Cin + ch0 + w_r) * Cout + n0 + w_c;
      TW* dst = Wr + (size_t)ld_slot * R_STAGE + w_r * R_LD + w_c;
#pragma unroll
      for (int j = 0; j < CV_CK / W_ROWS; ++j) {
        const bool ok = n_ok && ch0 + j * W_ROWS + w_r < Cin;
        cp_async16(dst + j * W_ROWS * R_LD, ok ? src + (size_t)j * W_ROWS * Cout : w, ok);
      }
      if (++ld_tap == 9) {
        ld_tap = 0;
        if (++ld_kc == nk) {
          ld_kc = 0;
          ++ld_nt;
        }
      }
      if (++ld_slot == stages) ld_slot = 0;
      ++ld;
    }
    cp_async_commit();
  };

  // silu(x * a + c) of the patch of the strip's chunk number `seq` (buffer
  // seq & 1), in place, in f32 with one rounding to bf16; zero outside the
  // image and past Cin.
  auto activate = [&](int seq) {
    const int buf = seq & 1, ch0 = (kc0 + seq % nk) * CV_CK;
    bf16* pb = patch + (size_t)buf * P * CV_LD;
    const float* as = ac + buf * 2 * CV_CK;
    const float* cs = as + CV_CK;
    for (int idx = tid; idx < P * (CV_CK / 8); idx += CV_THREADS) {
      const int p = idx >> 3, q = idx & 7;
      const int tq = t0 - 1 + p / PW, fq = f0 - 1 + p % PW;
      bf16* e = pb + p * CV_LD + q * 8;
      float y[8];
      if (tq >= 0 && tq < T && fq >= 0 && fq < F && ch0 + q * 8 < Cin) {
        float v[8];
        unpack8(*reinterpret_cast<const uint4*>(e), v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float z = v[i] * as[q * 8 + i] + cs[q * 8 + i];
          y[i] = __fdividef(z, 1.f + __expf(-z));
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = 0.f;
      }
      store8(e, y);
    }
  };

  // Per lane: the patch position of the output row its ldmatrix address
  // names in each m16 tile, at tap (0, 0); rows past the tile read position
  // 0 and are never stored.
  int apos[MT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int r = wm * WM + mi * 16 + (lane & 15);
    apos[mi] = (r < tt * ft ? (r / ft) * PW + r % ft : 0) * CV_LD + (lane >> 4) * 8;
  }
  const int b_off = ((((lane >> 3) & 1) << 3) + (lane & 7)) * B_LD + wn * 32 + (lane >> 4) * 8;

  // K1q: the int8 W tile in ring slot `rs` into bf16 staging tile `sb`, 16
  // values a thread a step (zero-filled rows and columns stay zero)
  auto convert = [&](int rs, int sb) {
    const TW* src = Wr + (size_t)rs * R_STAGE;
    bf16* dst = Ws + (size_t)sb * W_STAGE;
#pragma unroll
    for (int u = 0; u < CV_CK * (BN / 16) / CV_THREADS; ++u) {
      const int q = tid + u * CV_THREADS, r = q / (BN / 16), col = (q % (BN / 16)) * 16;
      uint4 lo, hi;
      int8x16_to_bf16(*reinterpret_cast<const uint4*>(src + r * R_LD + col), lo, hi);
      *reinterpret_cast<uint4*>(dst + r * B_LD + col) = lo;
      *reinterpret_cast<uint4*>(dst + r * B_LD + col + 8) = hi;
    }
  };

  load_patch(0);
  cp_async_commit();
  // K1q's ring keeps one tile more in flight: a slot is free once its tile
  // is converted, a step ahead of its products
  for (int s = 0; s < stages - (Q ? 0 : 1); ++s) load_next();
  if constexpr (Q) {  // W tile 0 into staging tile 0
    cp_async_wait_dyn(stages - 1);  // patch 0 and W tile 0 have landed
    __syncthreads();
    convert(0, 0);
  }

  float acc[MT][4][4];
  int kt = 0, nt = 0, slot = 0, tap = 0, seq = 0;
  for (int i = 0; i < total; ++i) {
    // W tile i (K1q: i + 1), and every patch up to its chunk's, has landed
    cp_async_wait_dyn(stages - 2);
    // ... for all; tile i - 1's slot (K1q: tile i's, and staging tile i + 1's), and at tap 0 the
    // last chunk's buffer, free
    __syncthreads();
    if (tap == 0 && seq + 1 < my_tiles * nk) load_patch(seq + 1);
    load_next();  // tile i + stages - 1 (K1q: i + stages; with the next chunk's patch, at tap 0)
    if (tap == 0) {  // this chunk's patch has landed: activate it, whole
      activate(seq);
      __syncthreads();
    }
    if (kt == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    }
    const bf16* Wt = Ws + (size_t)(Q ? i & 1 : slot) * W_STAGE + b_off;
    if (++slot == stages) slot = 0;
    const bf16* At = patch + (size_t)(seq & 1) * P * CV_LD + ((tap / 3) * PW + tap % 3) * CV_LD;
    uint32_t af[2][MT][4], bfr[2][2][4];
    auto fetch = [&](int set, int kk) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) ldmatrix_x4(af[set][mi], At + apos[mi] + kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) ldmatrix_x4_trans(bfr[set][np], Wt + kk * B_LD + np * 16);
    };
    fetch(0, 0);
#pragma unroll
    for (int ks = 0; ks < CV_CK / 16; ++ks) {
      if (ks + 1 < CV_CK / 16) fetch((ks + 1) & 1, (ks + 1) * 16);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16_16816(acc[mi][2 * np], af[ks & 1][mi], bfr[ks & 1][np][0],
                         bfr[ks & 1][np][1]);
          mma_bf16_16816(acc[mi][2 * np + 1], af[ks & 1][mi], bfr[ks & 1][np][2],
                         bfr[ks & 1][np][3]);
        }
      }
    }
    // K1q: tile i + 1 into the other staging tile, behind this tile's
    // products, whose tensor-core work its loads and integer work overlap
    if constexpr (Q) {
      if (i + 1 < total) convert((i + 1) % stages, (i + 1) & 1);
    }
    if (++tap == 9) {
      tap = 0;
      ++seq;
    }

    if (++kt == per_nt && gridDim.z == 1) {  // N tile complete: + bias, one rounding, stores
      const int nb = (tile0 + nt) * BN + wn * 32;
      float bv[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nb + j * 8 + 2 * t;  // Cout is even: col and col + 1 in or out together
        bv[j][0] = bv[j][1] = 0.f;
        if (col < Cout) {
          if (p16) {
            const float2 b2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(bias) + col));
            bv[j][0] = b2.x;
            bv[j][1] = b2.y;
          } else {
            bv[j][0] = static_cast<const float*>(bias)[col];
            bv[j][1] = static_cast<const float*>(bias)[col + 1];
          }
        }
      }
      if constexpr (Q) {  // * wscale + bias in f32, one rounding
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sc = nb + j * 8 + 2 * t;
          const float2 s2 = sc < Cout ? *reinterpret_cast<const float2*>(wscale + sc)
                                      : make_float2(0.f, 0.f);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            acc[mi][j][0] *= s2.x;
            acc[mi][j][1] *= s2.y;
            acc[mi][j][2] *= s2.x;
            acc[mi][j][3] *= s2.y;
          }
        }
      }
      const int col = nb + t * 8;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = pack_bf16(acc[mi][j][2 * half] + bv[j][0], acc[mi][j][2 * half + 1] + bv[j][1]);
          quad_transpose(v, t);
          const int r = wm * WM + mi * 16 + half * 8 + g;
          const int tq = t0 + r / ft, fq = f0 + r % ft;
          if (r < tt * ft && tq < T && fq < F && col < Cout)
            *reinterpret_cast<uint4*>(out + (((size_t)b * T + tq) * F + fq) * Cout + col) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    if (kt == per_nt) {
      kt = 0;
      ++nt;
    }
  }

  if (gridDim.z > 1) {
    // Split over a cluster (one N tile a block): each block's f32 tile in its
    // own shared memory, then every block sums its rows (r = rank mod splits)
    // over the cluster's tiles in rank order, + bias, one rounding, stores.
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    constexpr int C_LD = BN + 4;
    float* Cs = reinterpret_cast<float*>(cv_smem);
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the patch and the ring
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(Cs + (wm * WM + mi * 16 + half * 8 + g) * C_LD + wn * 32 +
                                     j * 8 + 2 * t) =
              make_float2(acc[mi][j][2 * half], acc[mi][j][2 * half + 1]);
    cluster.sync();
    const int splits = gridDim.z, rank = blockIdx.z;
    const int my_rows = (BM - rank + splits - 1) / splits;
    const int n0 = tile0 * BN;
    for (int it = tid; it < my_rows * (BN / 8); it += CV_THREADS) {
      const int r = rank + (it / (BN / 8)) * splits, col = n0 + (it % (BN / 8)) * 8;
      const int tq = t0 + r / ft, fq = f0 + r % ft;
      if (!(r < tt * ft && tq < T && fq < F && col < Cout)) continue;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < splits; ++s) {
        const float* src = cluster.map_shared_rank(Cs, s) + r * C_LD + (col - n0);
        const float4 lo = *reinterpret_cast<const float4*>(src);
        const float4 hi = *reinterpret_cast<const float4*>(src + 4);
        v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
        v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
      }
      float bv[8];
      load8_param(bias, col, p16, bv);
      if constexpr (Q) {  // * wscale after the cluster sum
        float sv[8];
        load8(wscale + col, sv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= sv[e];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += bv[e];
      store8(out + (((size_t)b * T + tq) * F + fq) * Cout + col, v);
    }
    cluster.sync();  // no block leaves while another still reads its tile
  }
}

template <int BM, int BN, typename TW = bf16>
static int conv_bf16_launch(const void* x1, const void* x2, const void* a, const void* c,
                            const void* w, const void* bias, bool p16, void* out, int B, int T,
                            int F, int C1, int C2, int Cout, int tt, int ft, int strip_tiles,
                            int stages, int splits, cudaStream_t stream,
                            const void* wscale = nullptr) {
  auto kern = gn_silu_conv_bf16_kernel<BM, BN, TW>;
  static bool configured = false;  // per instantiation: above 48 KB needs the attribute
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, CV_MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const size_t smem = conv_smem_bytes(BM, BN, tt, ft, stages, (int)sizeof(TW));
  if (smem > (size_t)CV_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int n_chunks = (C1 + C2 + CV_CK - 1) / CV_CK;
  const int cps = (n_chunks + splits - 1) / splits;
  if ((splits - 1) * cps >= n_chunks) return (int)cudaErrorInvalidValue;  // an empty split
  const int n_tiles = (Cout + BN - 1) / BN;
  dim3 grid((n_tiles + strip_tiles - 1) / strip_tiles,
            B * ((T + tt - 1) / tt) * ((F + ft - 1) / ft), splits);
  const bf16 *px1 = static_cast<const bf16*>(x1), *px2 = static_cast<const bf16*>(x2);
  const TW* pw = static_cast<const TW*>(w);
  const float *pa = static_cast<const float*>(a), *pc = static_cast<const float*>(c),
              *ps = static_cast<const float*>(wscale);
  bf16* po = static_cast<bf16*>(out);
  if (splits == 1) {
    kern<<<grid, CV_THREADS, smem, stream>>>(px1, px2, pa, pc, pw, ps, bias, p16, po, T, F, C1,
                                             C2, Cout, tt, ft, strip_tiles, stages, cps);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(CV_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kern, px1, px2, pa, pc, pw, ps, bias, p16, po, T,
                                         F, C1, C2, Cout, tt, ft, strip_tiles, stages, cps);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The shared GEMM core's prologue: K1 in f32, K1q, and declined bf16 shapes
// ---------------------------------------------------------------------------

template <typename T>
struct ConvPrologue {
  const T* x1;
  const T* x2;
  const float* a;
  const float* c;
  int T_, F, C1, C2, Cin;

  __device__ void block_init(int, int, float*) const {}

  __device__ float operator()(int m, int k, const float*) const {
    const int tap = k / Cin;
    const int ch = k - tap * Cin;
    const int f = m % F;
    const int bt = m / F;
    const int t = bt % T_;
    const int b = bt / T_;
    const int tt = t + tap / 3 - 1;
    const int ff = f + tap % 3 - 1;
    if (tt < 0 || tt >= T_ || ff < 0 || ff >= F) return 0.f;
    const size_t row = ((size_t)b * T_ + tt) * F + ff;
    const float xv = ch < C1 ? to_f(x1[row * C1 + ch]) : to_f(x2[row * C2 + (ch - C1)]);
    const float y = xv * a[(size_t)b * Cin + ch] + c[(size_t)b * Cin + ch];
    return y / (1.f + expf(-y));
  }

  // Channels k..k+7 of one tap (C1 and C2 are multiples of 8, so the eight
  // never straddle a tap or the concat split).
  __device__ void eight(int m, int k, const float*, float v[8]) const {
    const int tap = k / Cin;
    const int ch = k - tap * Cin;
    const int f = m % F;
    const int bt = m / F;
    const int t = bt % T_;
    const int b = bt / T_;
    const int tt = t + tap / 3 - 1;
    const int ff = f + tap % 3 - 1;
    if (tt < 0 || tt >= T_ || ff < 0 || ff >= F) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      return;
    }
    const size_t row = ((size_t)b * T_ + tt) * F + ff;
    float xv[8], av[8], cv[8];
    load8(ch < C1 ? x1 + row * C1 + ch : x2 + row * C2 + (ch - C1), xv);
    load8(a + (size_t)b * Cin + ch, av);
    load8(c + (size_t)b * Cin + ch, cv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y = xv[j] * av[j] + cv[j];
      v[j] = y / (1.f + expf(-y));
    }
  }
};

// wscale null: K1 (w in T); else K1q (w int8, bf16 tiles, output in T).
template <typename T>
static int conv_impl(const void* x1, const void* x2, const void* a, const void* c,
                     const void* w, const void* wscale, const void* bias, void* out, int B,
                     int T_, int F, int C1, int C2, int Cout, void* ws, int k_split, int vec,
                     cudaStream_t stream) {
  ConvPrologue<T> pro;
  pro.x1 = static_cast<const T*>(x1);
  pro.x2 = static_cast<const T*>(x2);
  pro.a = static_cast<const float*>(a);
  pro.c = static_cast<const float*>(c);
  pro.T_ = T_;
  pro.F = F;
  pro.C1 = C1;
  pro.C2 = C2;
  pro.Cin = C1 + C2;
  const int M = B * T_ * F;
  const int K = 9 * (C1 + C2);
  if (wscale == nullptr)
    return launch_gemm<T, T, T>(pro, w, nullptr, bias, nullptr, out, static_cast<float*>(ws), M,
                                Cout, K, k_split, vec, stream);
  return launch_gemm<bf16, int8_t, T>(pro, w, wscale, bias, nullptr, out,
                                      static_cast<float*>(ws), M, Cout, K, k_split, vec, stream);
}

}  // namespace a2k

extern "C" {

// x2 may be null (C2 = 0). gamma, beta: [C1+C2], f32 (param_dtype 0) or bf16
// (1), read as stored; a_out, c_out: f32 [B, C1+C2]; part: f32 [B, chunks, G,
// 2]; counter: B unsigned, zero, left zero; chunks: row chunks of S per
// sample, none empty.
int a2k_gn_stats(const void* x1, const void* x2, int B, int S, int C1, int C2, int G, float eps,
                 const void* gamma, const void* beta, int param_dtype, void* a_out, void* c_out,
                 void* part, int chunks, void* counter, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || G <= 0 || (C1 + C2) % G || chunks < 1 ||
      (param_dtype != 0 && param_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool p16 = param_dtype == 1;
  if (dtype == 1)
    return a2k::gn_stats_impl<a2k::bf16>(x1, x2, B, S, C1, C2, G, eps, gamma, beta, p16, a_out,
                                         c_out, part, chunks, counter, s);
  return a2k::gn_stats_impl<float>(x1, x2, B, S, C1, C2, G, eps, gamma, beta, p16, a_out, c_out,
                                   part, chunks, counter, s);
}

// K1 in bf16 with its launch plan. x1: bf16 [B, T, F, C1], x2: bf16 [B, T,
// F, C2] or null (C2 = 0); a, c: f32 [B, C1+C2] from a2k_gn_stats; w: bf16
// [3, 3, C1+C2, Cout]; bias: [Cout], f32 (param_dtype 0) or bf16 (1), read
// as stored; out: bf16 [B, T, F, Cout]. C1, C2 and Cout multiples of 8, all
// pointers 16-byte aligned. (bm, bn) in {(256, 64), (128, 128), (64, 128),
// (64, 64)};
// tt x ft <= bm output positions a block; strip_tiles N tiles a block;
// stages 2 to 8; splits 1 to 8 (a cluster; strip_tiles 1 then).
int a2k_gn_silu_conv3x3_bf16(const void* x1, const void* x2, const void* a, const void* c,
                             const void* w, const void* bias, int param_dtype, void* out, int B,
                             int T, int F, int C1, int C2, int Cout, int bm, int bn, int tt,
                             int ft, int strip_tiles, int stages, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || F <= 0 || C1 <= 0 || C2 < 0 || Cout <= 0 || (C1 & 7) || (C2 & 7) ||
      (Cout & 7) || (C2 > 0 && x2 == nullptr) || tt < 1 || ft < 1 || tt * ft > bm ||
      strip_tiles < 1 || stages < 2 || stages > a2k::CV_MAX_STAGES || splits < 1 ||
      splits > a2k::CV_MAX_SPLITS || (splits > 1 && strip_tiles != 1) ||
      (param_dtype != 0 && param_dtype != 1) || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool p16 = param_dtype == 1;
  if ((reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(x2) |
       reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(c) |
       reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(bias) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (bm == 256 && bn == 64)
    return a2k::conv_bf16_launch<256, 64>(x1, x2, a, c, w, bias, p16, out, B, T, F, C1, C2, Cout,
                                          tt, ft, strip_tiles, stages, splits, s);
  if (bm == 128 && bn == 128)
    return a2k::conv_bf16_launch<128, 128>(x1, x2, a, c, w, bias, p16, out, B, T, F, C1, C2, Cout,
                                           tt, ft, strip_tiles, stages, splits, s);
  if (bm == 64 && bn == 128)
    return a2k::conv_bf16_launch<64, 128>(x1, x2, a, c, w, bias, p16, out, B, T, F, C1, C2, Cout,
                                          tt, ft, strip_tiles, stages, splits, s);
  if (bm == 64 && bn == 64)
    return a2k::conv_bf16_launch<64, 64>(x1, x2, a, c, w, bias, p16, out, B, T, F, C1, C2, Cout,
                                         tt, ft, strip_tiles, stages, splits, s);
  return (int)cudaErrorInvalidValue;
}

// K1q in bf16 with its launch plan: as a2k_gn_silu_conv3x3_bf16 with wq:
// int8 [3, 3, C1+C2, Cout] (Cout a multiple of 16) and wscale: f32 [Cout],
// out = conv(silu(x * a + c), wq) * wscale + bias; stages: 2 to 8 int8 W
// tiles in the ring (besides two bf16 staging tiles).
int a2k_gn_silu_conv3x3_q_bf16(const void* x1, const void* x2, const void* a, const void* c,
                               const void* wq, const void* wscale, const void* bias,
                               int param_dtype, void* out, int B, int T, int F, int C1, int C2,
                               int Cout, int bm, int bn, int tt, int ft, int strip_tiles,
                               int stages, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || F <= 0 || C1 <= 0 || C2 < 0 || Cout <= 0 || (C1 & 7) || (C2 & 7) ||
      (Cout & 15) || (C2 > 0 && x2 == nullptr) || tt < 1 || ft < 1 || tt * ft > bm ||
      strip_tiles < 1 || stages < 2 || stages > a2k::CV_MAX_STAGES || splits < 1 ||
      splits > a2k::CV_MAX_SPLITS || (splits > 1 && strip_tiles != 1) ||
      (param_dtype != 0 && param_dtype != 1) || bias == nullptr || wscale == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool p16 = param_dtype == 1;
  if ((reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(x2) |
       reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(c) |
       reinterpret_cast<uintptr_t>(wq) | reinterpret_cast<uintptr_t>(wscale) |
       reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (bm == 256 && bn == 64)
    return a2k::conv_bf16_launch<256, 64, int8_t>(x1, x2, a, c, wq, bias, p16, out, B, T, F, C1,
                                                  C2, Cout, tt, ft, strip_tiles, stages, splits,
                                                  s, wscale);
  if (bm == 128 && bn == 128)
    return a2k::conv_bf16_launch<128, 128, int8_t>(x1, x2, a, c, wq, bias, p16, out, B, T, F, C1,
                                                   C2, Cout, tt, ft, strip_tiles, stages, splits,
                                                   s, wscale);
  if (bm == 64 && bn == 128)
    return a2k::conv_bf16_launch<64, 128, int8_t>(x1, x2, a, c, wq, bias, p16, out, B, T, F, C1,
                                                  C2, Cout, tt, ft, strip_tiles, stages, splits,
                                                  s, wscale);
  if (bm == 64 && bn == 64)
    return a2k::conv_bf16_launch<64, 64, int8_t>(x1, x2, a, c, wq, bias, p16, out, B, T, F, C1,
                                                 C2, Cout, tt, ft, strip_tiles, stages, splits,
                                                 s, wscale);
  return (int)cudaErrorInvalidValue;
}

// The shared core: w: [3, 3, C1+C2, Cout] in the activation dtype; bias: f32
// [Cout]; out: [B, T, F, Cout] in the activation dtype; ws: null or the
// split-K workspace (f32, ceil(9*(C1+C2) / k_split) * B*T*F * Cout); vec:
// GEMM_VEC_* bits.
int a2k_gn_silu_conv3x3(const void* x1, const void* x2, const void* a, const void* c,
                        const void* w, const void* bias, void* out, int B, int T, int F,
                        int C1, int C2, int Cout, void* ws, int k_split, int vec, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return a2k::conv_impl<a2k::bf16>(x1, x2, a, c, w, nullptr, bias, out, B, T, F, C1, C2, Cout,
                                     ws, k_split, vec, s);
  return a2k::conv_impl<float>(x1, x2, a, c, w, nullptr, bias, out, B, T, F, C1, C2, Cout, ws,
                               k_split, vec, s);
}

// As a2k_gn_silu_conv3x3 with wq: int8 [3, 3, C1+C2, Cout] and wscale: f32
// [Cout]; dtype is the activation's (and the output's).
int a2k_gn_silu_conv3x3_q(const void* x1, const void* x2, const void* a, const void* c,
                          const void* wq, const void* wscale, const void* bias, void* out, int B,
                          int T, int F, int C1, int C2, int Cout, void* ws, int k_split, int vec,
                          int dtype, void* stream) {
  if (wscale == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return a2k::conv_impl<a2k::bf16>(x1, x2, a, c, wq, wscale, bias, out, B, T, F, C1, C2,
                                     Cout, ws, k_split, vec, s);
  return a2k::conv_impl<float>(x1, x2, a, c, wq, wscale, bias, out, B, T, F, C1, C2, Cout, ws,
                               k_split, vec, s);
}

const char* a2k_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
