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
// 1. a2k_gn_stats (also K1q's): a split, coalesced reduction. A
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
// The plain conv (a2k_conv2d_bf16) replaces no Pallas kernel: it is every
// bf16 conv2d of the UNet and the VAE decoder outside the ResBlock bodies,
// which the JAX package leaves to XLA and cuDNN ran on f32 copies of the bf16
// operands (FFMA or FFT, not the tensor cores). It is K1's bf16 kernel with
// its geometry read at run time (GEN, ConvGeo): 1x1 or 3x3 taps (a 1x1 patch
// has no halo, a tap a chunk), stride 1 or 2 (a tile of tt x ft outputs reads
// a patch of ((tt - 1) s + k) x ((ft - 1) s + k) positions, each ldmatrix
// lane's row address stepping s positions), the input read through a
// nearest-2x upsample in the patch load (the 2x tensor is never written), two
// concat parts in place, and a prologue of nothing (the patch is used as it
// lands, zero-filled outside) or the GroupNorm alone (the statistics pass,
// then x * a + c rounded once to bf16: the spatial transformer's norm before
// its proj_in). The sums and the epilogue are K1's: bf16 products, f32
// accumulation, + bias, one rounding, channels-last bf16 stores. Bound at
// the UNet's shapes by latency (its 1x1 convs are 3-100 us) and at the
// upsample convs by the tensor cores.
//
// K1 in f32 (the sr path's VAE encode) runs the same statistics pass and
// a2k_gn_silu_conv3x3_f32: the same conv kernel with TX = float, 32-channel
// chunks and the products in 3xTF32 on the tensor cores (below); bound by
// those products at the TF32 rate, three a multiply-add.
//
// The shared GEMM core (common.cuh) keeps K1q in f32 and the shapes the
// plans decline (channels no multiple of 8, K1q's Cout no multiple of 16,
// unaligned pointers): its A prologue computes silu(x * a + c) of a shifted
// tap as the tile loads.
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
// The conv: halo'd patch activated once per chunk, nine shifted views; bf16
// (K1, K1q) and f32 (K1 in 3xTF32) on one kernel
// ---------------------------------------------------------------------------

constexpr int CV_CK = 64;         // input channels per chunk: the K depth of one tap's W tile
constexpr int CV_LD = CV_CK + 8;  // patch row stride, 144 bytes: ldmatrix rows on 8 bank groups
constexpr int CV_THREADS = 256;   // 8 warps
constexpr int CV_PAD = 8;         // elements of padding per W tile row
constexpr int CV_MAX_STAGES = 8;  // at most 10: a patch must land before its chunk's first tap
constexpr int CV_MAX_SPLITS = 8;  // the portable cluster size
constexpr int CV_MAX_SMEM = 232448;
// W tiles (64 input channels of one tap each) that a partial of the plain
// conv sums on the tensor cores before it joins the f32 sum: mma.sync's f32
// accumulation truncates, so a running sum over all of K drifts (on an H100,
// 0.52% of bf16 outputs off the exact sum's one rounding at K = 9216, where
// cuDNN's f32 FFMA left 0.06%); partials of 1, 2, 4 and 8 tiles left 0.017%,
// 0.015%, 0.020% and 0.035% there, and took 2.1%, 0.6%, 0.4% and 0.1% more
// time a UNet forward than one partial an N tile.
constexpr int CV_PART_TILES = 4;

// K1 in f32 (the sr path's VAE encode) is the same kernel with TX = float:
// the halo'd patch of a channel chunk comes in by cp.async, is activated
// once (silu(x * a + c) in f32 with expf, zero outside the image: SAME
// padding of the activated tensor) and read by the nine taps as shifted
// ldmatrix views; the weight streams through a cp.async ring; + bias in f32
// after the whole K; small M splits the chunks over a cluster. The products
// are 3xTF32 on mma.sync m16n8k8: each f32 operand v is split once into
// hi = tf32(v) and lo = tf32(v - hi) (round to nearest, away on ties), and
// every k8 step accumulates lo.hi + hi.lo + hi.hi in f32, the small terms
// first. One TF32 product keeps 11 significant bits of each operand and
// misses the f32 bar (1e-4 relative) at K = 9 x 512; three keep about 22.
//
// Layouts (f32 words; a tf32 value is an f32 with its low 13 bits zero):
//   the raw patch [P][32], cp.async's landing place, one buffer;
//   the activated patch in two planes, hi and lo, [P][CV32_LD], split as
//     it is activated: a row stride of 144 bytes puts the eight rows of an
//     ldmatrix phase on eight bank groups, and one ldmatrix.x4 of 8 x 4
//     tf32 gives the A fragment (rows g and g + 8, k t and t + 4) as for
//     bf16;
//   the ring of raw W tiles [CV32_CK][BN + 4]: a row stride of 4 mod 32
//     words lets the split read a float4 a lane, a lane a row, with no bank
//     conflict;
//   two staging tiles, each two planes [BN][CV32_LD], the split weight
//     written transposed (n rows, k contiguous), so that ldmatrix without
//     .trans gives the B fragment (k t and t + 4, n g): ldmatrix has no
//     32-bit transpose. Each ring tile is split once, a quarter after each
//     k8 step of the previous tile's products (K1q's int8 ring and staging),
//     and its slot frees at once; no second copy of the weight lives in
//     device memory.
// The chunk is 32 channels: the patch's two planes are four times the bf16
// patch's bytes at the same chunk. One tile, (256, 64), the fastest at every
// shape of the encode, with 16 warps, each two m16 tiles by four n8 tiles.
// Measured against this design on an H100 (PERF.md): 8 warps a block, B
// read from the raw ring and split in registers by every warp (no staging
// tiles), and A split in registers from one activated plane were each
// slower, the last by 17%.
constexpr int CV32_CK = 32;           // input channels per chunk
constexpr int CV32_LD = CV32_CK + 4;  // plane and staging row stride (floats)
constexpr int CV32_THREADS = 512;     // 16 warps
constexpr int CV32_BM = 256, CV32_BN = 64;

// Shared memory of one bf16 block: two patch buffers, the chunk's a and c
// (two buffers), the W ring (K1q: two bf16 staging tiles and an int8 ring of
// rows padded by 16 bytes); the split epilogue's f32 tile reuses it.
// P: the patch's positions, (tt + 2) x (ft + 2) for K1 (ConvGeo::patch).
__host__ __device__ inline size_t conv_smem_bytes(int BM, int BN, int P, int stages,
                                                  int w_bytes = 2) {
  const size_t ring = w_bytes == 1
                          ? (size_t)2 * CV_CK * (BN + CV_PAD) * sizeof(bf16) +
                                (size_t)stages * CV_CK * (BN + 16)
                          : (size_t)stages * CV_CK * (BN + CV_PAD) * sizeof(bf16);
  const size_t main = (size_t)2 * P * CV_LD * sizeof(bf16) +
                      (size_t)4 * CV_CK * sizeof(float) + ring;
  const size_t epi = (size_t)BM * (BN + 4) * sizeof(float);
  return main > epi ? main : epi;
}

// ... of one f32 block: the raw patch, the two planes, the chunk's a and c,
// the ring, two staging tiles of two planes; the split epilogue's f32 tile
// reuses it.
__host__ __device__ inline size_t conv32_smem_bytes(int BM, int BN, int tt, int ft, int stages) {
  const size_t P = (size_t)(tt + 2) * (ft + 2);
  const size_t main = P * CV32_CK * 4 + 2 * P * CV32_LD * 4 + (size_t)2 * CV32_CK * 4 +
                      (size_t)stages * CV32_CK * (BN + 4) * 4 + (size_t)4 * BN * CV32_LD * 4;
  const size_t epi = (size_t)BM * (BN + 4) * sizeof(float);
  return main > epi ? main : epi;
}

// The conv's geometry for an activation type: channels a chunk, patch row
// stride (elements), threads a block.
template <typename TX>
struct ConvGeom {
  static constexpr int CK = CV_CK, LD = CV_LD, THREADS = CV_THREADS;
};
template <>
struct ConvGeom<float> {
  static constexpr int CK = CV32_CK, LD = CV32_LD, THREADS = CV32_THREADS;
};

// The plain conv's geometry and prologue (the GEN instantiations, entry
// a2k_conv2d_bf16); K1, K1q and the f32 K1 fix it at k1_geo: 3x3, stride 1,
// SAME, GroupNorm + SiLU. The output [B, T, F, Cout] is given beside it; the
// padding after the input is what the output's size implies (zeros past the
// input).
struct ConvGeo {
  int Ti, Fi;  // the input's T and F as stored
  int up;      // 1: the input read through a nearest-2x upsample (2 Ti x 2 Fi)
  int k;       // taps a side: 1 or 3
  int s;       // stride: 1 or 2
  int pt, pf;  // padding before T and before F
  int act;     // prologue: 0 none, 1 silu(x a + c), 2 x a + c (GroupNorm alone)

  // positions of the patch that a tile of tt x ft outputs reads
  __host__ __device__ int patch(int tt, int ft) const {
    return ((tt - 1) * s + k) * ((ft - 1) * s + k);
  }
};

__host__ __device__ inline ConvGeo k1_geo(int T, int F) {
  return ConvGeo{T, F, 0, 3, 1, 1, 1, 1};
}

// f32 -> tf32, round to nearest with ties away from zero (cvt.rna): the
// result is an f32 whose 13 low mantissa bits are zero.
__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// d += a . b for one 16 x 8 x 8 tf32 product, f32 accumulation. Fragments
// (g = lane / 4, t = lane % 4): a0 (row g, k t), a1 (row g + 8, k t), a2
// (row g, k t + 4), a3 (row g + 8, k t + 4); b0 (k t, n g), b1 (k t + 4,
// n g); d as in m16n8k16.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// TX: the activation's (and output's) type: bf16, or f32 (3xTF32 products,
// TW float). TW: the weight's type, TX or int8 (K1q, bf16 only: the ring
// holds int8 tiles, each converted once into one of two bf16 staging tiles
// that the products read, and the per-output-channel scale wscale
// multiplies the f32 sums in the epilogue). GEN: the plain conv (bf16 only),
// its geometry and prologue from `geo` at run time; otherwise k1_geo, as
// constants. T, F: the output's extent.
template <int BM, int BN, typename TW = bf16, typename TX = bf16, bool GEN = false>
__global__ void __launch_bounds__(ConvGeom<TX>::THREADS)
gn_silu_conv_kernel(const TX* __restrict__ x1, const TX* __restrict__ x2,
                    const float* __restrict__ a, const float* __restrict__ c,
                    const TW* __restrict__ w, const float* __restrict__ wscale,
                    const void* __restrict__ bias, bool p16, TX* __restrict__ out, int T, int F,
                    int C1, int C2, int Cout, int tt, int ft, int strip_tiles, int stages,
                    int chunks_per_split, ConvGeo geo) {
  constexpr bool Q = std::is_same<TW, int8_t>::value;
  constexpr bool F32 = std::is_same<TX, float>::value;
  static_assert(!GEN || (!Q && !F32), "the plain conv is bf16 only");
  // the geometry: taps a side, stride, the nearest-2x read, the prologue,
  // the input as stored and as read, the padding before it
  const int KS = GEN ? geo.k : 3, NTAP = KS * KS, STR = GEN ? geo.s : 1;
  const int UP = GEN ? geo.up : 0, ACT = GEN ? geo.act : 1;
  const int TI = GEN ? geo.Ti : T, FI = GEN ? geo.Fi : F;
  const int TV = TI << UP, FV = FI << UP;
  const int PT = GEN ? geo.pt : 1, PF = GEN ? geo.pf : 1;
  constexpr int CK = ConvGeom<TX>::CK, LD = ConvGeom<TX>::LD, THREADS = ConvGeom<TX>::THREADS;
  constexpr int EPP = 16 / (int)sizeof(TX);  // elements of a 16-byte piece: CK / EPP = 8 a row
  constexpr int WARPS_N = BN / 32, WARPS_M = (THREADS / 32) / WARPS_N;
  constexpr int WM = BM / WARPS_M;  // rows per warp: 64, 32 or 16
  constexpr int MT = WM / 16;       // m16 tiles per warp; its 32 columns are 4 n8 tiles
  constexpr int B_LD = BN + CV_PAD;
  constexpr int W_STAGE = CK * B_LD;
  // a ring row, in TW elements (int8: 16 bytes of pad; f32: 4 words)
  constexpr int R_LD = F32 ? BN + 4 : Q ? BN + 16 : B_LD;
  constexpr int R_STAGE = CK * R_LD;
  constexpr int S_PLANE = BN * LD;                // f32: one plane of a staging tile
  constexpr int CPR = BN * (int)sizeof(TW) / 16;  // 16-byte chunks per W tile row
  constexpr int W_ROWS = THREADS / CPR;           // W tile rows one pass of the block copies
  static_assert(CK / EPP == 8, "a patch row is eight 16-byte pieces");

  extern __shared__ __align__(128) unsigned char cv_smem[];
  const int Cin = C1 + C2, n_chunks = (Cin + CK - 1) / CK;
  const int PW = (ft - 1) * STR + KS, P = ((tt - 1) * STR + KS) * PW;  // patch width, positions
  const int t_tiles = (T + tt - 1) / tt, f_tiles = (F + ft - 1) / ft;
  const int b = blockIdx.y / (t_tiles * f_tiles);
  const int tile = blockIdx.y % (t_tiles * f_tiles);
  const int t0 = (tile / f_tiles) * tt, f0 = (tile % f_tiles) * ft;
  const int pt0 = t0 * STR - PT, pf0 = f0 * STR - PF;  // the patch's origin in the input as read
  const int kc0 = blockIdx.z * chunks_per_split;
  const int nk = min(n_chunks, kc0 + chunks_per_split) - kc0;  // this block's chunks
  const int n_tiles = (Cout + BN - 1) / BN;
  const int tile0 = blockIdx.x * strip_tiles;
  const int my_tiles = min(strip_tiles, n_tiles - tile0);
  const int per_nt = NTAP * nk;        // W tiles of one N tile
  const int total = my_tiles * per_nt;  // ... of the strip

  // bf16: two patch buffers [2][P][LD], activated in place, then the a, c
  // of two chunks [2][a, c][CK], the ring (K1q: two staging tiles, then the
  // ring). f32: the raw patch [P][CK], its two planes hi, lo [P][LD], the
  // chunk's [a, c][CK], the ring, two staging tiles [2][hi, lo][BN][LD].
  using TS = typename std::conditional<F32, float, bf16>::type;  // staging tiles
  TX* patch = reinterpret_cast<TX*>(cv_smem);
  float* hi = reinterpret_cast<float*>(cv_smem) + (size_t)P * CK;
  float* lo = hi + (size_t)P * LD;
  float* ac = F32 ? lo + (size_t)P * LD : reinterpret_cast<float*>(patch + 2 * P * LD);
  TS* Ws;
  TW* Wr;  // the ring: stages x [CK][R_LD]
  if constexpr (F32) {
    Wr = ac + 2 * CK;
    Ws = Wr + (size_t)stages * R_STAGE;
  } else {
    Ws = reinterpret_cast<bf16*>(ac + 4 * CK);
    if constexpr (Q)
      Wr = reinterpret_cast<TW*>(Ws + 2 * W_STAGE);
    else
      Wr = Ws;
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  // The raw patch of the strip's chunk number `seq` (chunk seq % nk) and its
  // a, c, without a commit: chunk 0's before the ring starts; bf16: into
  // buffer seq & 1, chunk s + 1's with the W tile issued at chunk s's first
  // tap; f32: into the one raw buffer, right after chunk s is activated; so
  // a patch is in flight for nine tiles before its activation.
  auto load_patch = [&](int seq) {
    constexpr int P_LD = F32 ? CK : LD;
    const int ch0 = (kc0 + seq % nk) * CK;
    TX* dst = F32 ? patch : patch + (size_t)(seq & 1) * P * LD;
    for (int idx = tid; idx < P * (CK / EPP); idx += THREADS) {
      const int p = idx >> 3, q = idx & 7;
      const int tq = pt0 + p / PW, fq = pf0 + p % PW, ch = ch0 + q * EPP;
      const bool ok = tq >= 0 && tq < TV && fq >= 0 && fq < FV && ch < Cin;
      const size_t row = ((size_t)b * TI + (tq >> UP)) * FI + (fq >> UP);
      const TX* src = !ok ? x1 : ch < C1 ? x1 + row * C1 + ch : x2 + row * C2 + (ch - C1);
      cp_async16(dst + p * P_LD + q * EPP, src, ok);
    }
    if (ACT && tid < CK / 2) {  // copies of four floats of a, then as many of c
      const int which = tid / (CK / 4), ch = ch0 + (tid % (CK / 4)) * 4;
      const bool ok = ch < Cin;
      const float* src = (which ? c : a) + (size_t)b * Cin + ch;
      cp_async16(ac + (F32 ? 0 : (seq & 1) * 2 * CK) + which * CK + (tid % (CK / 4)) * 4,
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
      const int ch0 = (kc0 + ld_kc) * CK;
      const int n0 = (tile0 + ld_nt) * BN;
      const bool n_ok = n0 + w_c < Cout;
      const TW* src = w + ((size_t)ld_tap * Cin + ch0 + w_r) * Cout + n0 + w_c;
      TW* dst = Wr + (size_t)ld_slot * R_STAGE + w_r * R_LD + w_c;
#pragma unroll
      for (int j = 0; j < CK / W_ROWS; ++j) {
        const bool ok = n_ok && ch0 + j * W_ROWS + w_r < Cin;
        cp_async16(dst + j * W_ROWS * R_LD, ok ? src + (size_t)j * W_ROWS * Cout : w, ok);
      }
      if (++ld_tap == NTAP) {
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

  // silu(x * a + c) of the patch of the strip's chunk number `seq` (GEN's
  // act 2: x * a + c), zero outside the image and past Cin. bf16: buffer
  // seq & 1, in place, in f32 with one rounding to bf16. f32: from the raw
  // patch, with expf and IEEE division, split once into the hi and lo planes.
  // Act 0 activates nothing: cp.async zero-filled the patch outside.
  auto activate = [&](int seq) {
    const int ch0 = (kc0 + seq % nk) * CK;
    if constexpr (F32) {
      for (int idx = tid; idx < P * (CK / 4); idx += THREADS) {
        const int p = idx >> 3, q = idx & 7;
        const int tq = pt0 + p / PW, fq = pf0 + p % PW;
        float4 h = make_float4(0.f, 0.f, 0.f, 0.f), l = h;
        if (tq >= 0 && tq < TV && fq >= 0 && fq < FV && ch0 + q * 4 < Cin) {
          const float4 v = *reinterpret_cast<const float4*>(patch + p * CK + q * 4);
          const float4 av = *reinterpret_cast<const float4*>(ac + q * 4);
          const float4 cv = *reinterpret_cast<const float4*>(ac + CK + q * 4);
          const float xs[4] = {v.x, v.y, v.z, v.w}, as[4] = {av.x, av.y, av.z, av.w},
                      cs[4] = {cv.x, cv.y, cv.z, cv.w};
          float hs[4], ls[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float z = xs[i] * as[i] + cs[i];
            const float y = z / (1.f + expf(-z));
            hs[i] = to_tf32(y);
            ls[i] = to_tf32(y - hs[i]);
          }
          h = make_float4(hs[0], hs[1], hs[2], hs[3]);
          l = make_float4(ls[0], ls[1], ls[2], ls[3]);
        }
        *reinterpret_cast<float4*>(hi + p * LD + q * 4) = h;
        *reinterpret_cast<float4*>(lo + p * LD + q * 4) = l;
      }
    } else {
      const int buf = seq & 1;
      bf16* pb = patch + (size_t)buf * P * LD;
      const float* as = ac + buf * 2 * CK;
      const float* cs = as + CK;
      for (int idx = tid; idx < P * (CK / 8); idx += THREADS) {
        const int p = idx >> 3, q = idx & 7;
        const int tq = pt0 + p / PW, fq = pf0 + p % PW;
        bf16* e = pb + p * LD + q * 8;
        float y[8];
        if (tq >= 0 && tq < TV && fq >= 0 && fq < FV && ch0 + q * 8 < Cin) {
          float v[8];
          unpack8(*reinterpret_cast<const uint4*>(e), v);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float z = v[i] * as[q * 8 + i] + cs[q * 8 + i];
            y[i] = ACT == 1 ? __fdividef(z, 1.f + __expf(-z)) : z;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) y[i] = 0.f;
        }
        store8(e, y);
      }
    }
  };

  // Per lane: the patch position of the output row its ldmatrix address
  // names in each m16 tile, at tap (0, 0); rows past the tile read position
  // 0 and are never stored. f32 (8 x 4 tf32 matrices): matrix lane / 8, rows
  // + 8 for odd, k + 4 for the upper two. B: bf16, the ring or staging tile
  // read by ldmatrix.trans; f32, staging row n = wn 32 + (lane / 16) 8 +
  // lane % 8, k + 4 for odd matrices.
  int apos[MT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int r = F32 ? wm * WM + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8
                      : wm * WM + mi * 16 + (lane & 15);
    apos[mi] = (r < tt * ft ? (r / ft) * STR * PW + (r % ft) * STR : 0) * LD +
               (lane >> 4) * (F32 ? 4 : 8);
  }
  const int b_off =
      F32 ? (wn * 32 + (lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 4
          : ((((lane >> 3) & 1) << 3) + (lane & 7)) * B_LD + wn * 32 + (lane >> 4) * 8;

  // K1q: the int8 W tile in ring slot `rs` into bf16 staging tile `sb`, 16
  // values a thread a step (zero-filled rows and columns stay zero)
  auto convert = [&](int rs, int sb) {
    const TW* src = Wr + (size_t)rs * R_STAGE;
    bf16* dst = reinterpret_cast<bf16*>(Ws) + (size_t)sb * W_STAGE;
#pragma unroll
    for (int u = 0; u < CK * (BN / 16) / THREADS; ++u) {
      const int q = tid + u * THREADS, r = q / (BN / 16), col = (q % (BN / 16)) * 16;
      uint4 lo8, hi8;
      int8x16_to_bf16(*reinterpret_cast<const uint4*>(src + r * R_LD + col), lo8, hi8);
      *reinterpret_cast<uint4*>(dst + r * B_LD + col) = lo8;
      *reinterpret_cast<uint4*>(dst + r * B_LD + col + 8) = hi8;
    }
  };

  // f32: ring slot `rs` split into staging tile `sb`, transposed: lane k of
  // warp w reads row k's columns n0..n0+3 (a float4) for n0 = 4 (w + warps
  // i) and writes hi and lo at [n][k]; `step` of four takes the column
  // groups i with 4 i / NI == step, so that the split interleaves with the
  // products of the k8 steps
  constexpr int NI = BN * 8 / THREADS;  // column groups of four a warp splits
  auto split = [&](int rs, int sb, int step) {
    const float* src = reinterpret_cast<const float*>(Wr) + (size_t)rs * R_STAGE + lane * R_LD;
    float* dh = reinterpret_cast<float*>(Ws) + (size_t)sb * 2 * S_PLANE + lane;
    float* dl = dh + S_PLANE;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (i * 4 / NI != step) continue;
      const int n0 = 4 * (warp + THREADS / 32 * i);
      const float4 v = *reinterpret_cast<const float4*>(src + n0);
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const float h = to_tf32(vs[jn]);
        dh[(n0 + jn) * LD] = h;
        dl[(n0 + jn) * LD] = to_tf32(vs[jn] - h);
      }
    }
  };

  load_patch(0);
  cp_async_commit();
  // K1q's and f32's rings keep one tile more in flight: a slot is free once
  // its tile is converted or split into staging, a step ahead of its products
  constexpr bool STAGED = Q || F32;
  for (int s = 0; s < stages - (STAGED ? 0 : 1); ++s) load_next();
  if constexpr (STAGED) {  // W tile 0 into staging tile 0
    cp_async_wait_dyn(stages - 1);  // patch 0 and W tile 0 have landed
    __syncthreads();
    if constexpr (F32) {
#pragma unroll
      for (int step = 0; step < 4; ++step) split(0, 0, step);
    } else {
      convert(0, 0);
    }
  }

  float acc[MT][4][4];
  // GEN: the partial of up to CV_PART_TILES W tiles, summed from zero on the
  // tensor cores and added to acc in f32
  float part[MT][4][4];
  int kt = 0, nt = 0, slot = 0, tap = 0, seq = 0, pk = 0;
  for (int i = 0; i < total; ++i) {
    // W tile i (staged: i + 1), and every patch up to its chunk's, has landed
    cp_async_wait_dyn(stages - 2);
    // ... for all; tile i - 1's slot (staged: tile i's, and staging tile i +
    // 1's), and at tap 0 the last chunk's buffer (f32: the planes), free
    __syncthreads();
    if constexpr (F32) {
      if (tap == 0) {  // this chunk's raw patch has landed: activate it, whole
        activate(seq);
        __syncthreads();
        if (seq + 1 < my_tiles * nk) load_patch(seq + 1);
      }
      load_next();  // tile i + stages (with the next chunk's patch, at tap 0)
    } else {
      if (tap == 0 && seq + 1 < my_tiles * nk) load_patch(seq + 1);
      load_next();  // tile i + stages - 1 (K1q: i + stages; with the next chunk's patch, at tap 0)
      if (tap == 0 && ACT) {  // this chunk's patch has landed: activate it, whole
        activate(seq);
        __syncthreads();
      }
    }
    if (kt == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    }
    if constexpr (F32) {
      const float* Bh = reinterpret_cast<const float*>(Ws) + (size_t)(i & 1) * 2 * S_PLANE + b_off;
      const float* Bl = Bh + S_PLANE;
      const int shift = ((tap / KS) * PW + tap % KS) * LD;
#pragma unroll
      for (int kk = 0; kk < CK; kk += 8) {
        uint32_t bh[2][4], bl[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          ldmatrix_x4(bh[np], Bh + np * 16 * LD + kk);
          ldmatrix_x4(bl[np], Bl + np * 16 * LD + kk);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          uint32_t ah[4], al[4];
          ldmatrix_x4(ah, hi + shift + apos[mi] + kk);
          ldmatrix_x4(al, lo + shift + apos[mi] + kk);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              float(&d)[4] = acc[mi][2 * np + h2];
              mma_tf32_1688(d, al, bh[np][2 * h2], bh[np][2 * h2 + 1]);
              mma_tf32_1688(d, ah, bl[np][2 * h2], bl[np][2 * h2 + 1]);
              mma_tf32_1688(d, ah, bh[np][2 * h2], bh[np][2 * h2 + 1]);
            }
          }
        }
        // a quarter of tile i + 1 into the other staging tile, behind this k8
        // step's products
        if (i + 1 < total) split((i + 1) % stages, (i + 1) & 1, kk / 8);
      }
    } else {
      const bf16* Wt = Ws + (size_t)(Q ? i & 1 : slot) * W_STAGE + b_off;
      if (++slot == stages) slot = 0;
      const bf16* At = patch + (size_t)(seq & 1) * P * LD + ((tap / KS) * PW + tap % KS) * LD;
      uint32_t af[2][MT][4], bfr[2][2][4];
      auto fetch = [&](int set, int kk) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) ldmatrix_x4(af[set][mi], At + apos[mi] + kk);
#pragma unroll
        for (int np = 0; np < 2; ++np) ldmatrix_x4_trans(bfr[set][np], Wt + kk * B_LD + np * 16);
      };
      auto products = [&](float(&d)[MT][4][4]) {  // d += this W tile's products
        fetch(0, 0);
#pragma unroll
        for (int ks = 0; ks < CK / 16; ++ks) {
          if (ks + 1 < CK / 16) fetch((ks + 1) & 1, (ks + 1) * 16);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              mma_bf16_16816(d[mi][2 * np], af[ks & 1][mi], bfr[ks & 1][np][0],
                             bfr[ks & 1][np][1]);
              mma_bf16_16816(d[mi][2 * np + 1], af[ks & 1][mi], bfr[ks & 1][np][2],
                             bfr[ks & 1][np][3]);
            }
          }
        }
      };
      if constexpr (GEN) {
        if (pk == 0) {
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[mi][j][e] = 0.f;
        }
        products(part);
        if (++pk == CV_PART_TILES || kt + 1 == per_nt) {
          pk = 0;
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[mi][j][e];
        }
      } else {
        products(acc);
      }
      // K1q: tile i + 1 into the other staging tile, behind this tile's
      // products, whose tensor-core work its loads and integer work overlap
      if constexpr (Q) {
        if (i + 1 < total) convert((i + 1) % stages, (i + 1) & 1);
      }
    }
    if (++tap == NTAP) {
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
      if constexpr (F32) {  // f32 pairs from registers
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = nb + j * 8 + 2 * t;
          if (col >= Cout) continue;
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = wm * WM + mi * 16 + half * 8 + g;
              const int tq = t0 + r / ft, fq = f0 + r % ft;
              if (r < tt * ft && tq < T && fq < F)
                *reinterpret_cast<float2*>(out + (((size_t)b * T + tq) * F + fq) * Cout + col) =
                    make_float2(acc[mi][j][2 * half] + bv[j][0],
                                acc[mi][j][2 * half + 1] + bv[j][1]);
            }
          }
        }
      } else {
        const int col = nb + t * 8;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = pack_bf16(acc[mi][j][2 * half] + bv[j][0],
                               acc[mi][j][2 * half + 1] + bv[j][1]);
            quad_transpose(v, t);
            const int r = wm * WM + mi * 16 + half * 8 + g;
            const int tq = t0 + r / ft, fq = f0 + r % ft;
            if (r < tt * ft && tq < T && fq < F && col < Cout)
              *reinterpret_cast<uint4*>(out + (((size_t)b * T + tq) * F + fq) * Cout + col) =
                  make_uint4(v[0], v[1], v[2], v[3]);
          }
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
    __syncthreads();  // every warp is done with the patch, the ring and the staging
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
    for (int it = tid; it < my_rows * (BN / 8); it += THREADS) {
      const int r = rank + (it / (BN / 8)) * splits, col = n0 + (it % (BN / 8)) * 8;
      const int tq = t0 + r / ft, fq = f0 + r % ft;
      if (!(r < tt * ft && tq < T && fq < F && col < Cout)) continue;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < splits; ++s) {
        const float* src = cluster.map_shared_rank(Cs, s) + r * C_LD + (col - n0);
        const float4 lo4 = *reinterpret_cast<const float4*>(src);
        const float4 hi4 = *reinterpret_cast<const float4*>(src + 4);
        v[0] += lo4.x; v[1] += lo4.y; v[2] += lo4.z; v[3] += lo4.w;
        v[4] += hi4.x; v[5] += hi4.y; v[6] += hi4.z; v[7] += hi4.w;
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

// GEN: the plain conv under `geo`; otherwise K1's geometry (k1_geo).
template <int BM, int BN, typename TW = bf16, typename TX = bf16, bool GEN = false>
static int conv_launch(const void* x1, const void* x2, const void* a, const void* c,
                       const void* w, const void* bias, bool p16, void* out, int B, int T, int F,
                       int C1, int C2, int Cout, int tt, int ft, int strip_tiles, int stages,
                       int splits, cudaStream_t stream, const void* wscale = nullptr,
                       ConvGeo geo = ConvGeo{}) {
  constexpr bool F32 = std::is_same<TX, float>::value;
  constexpr int CK = ConvGeom<TX>::CK, THREADS = ConvGeom<TX>::THREADS;
  if (!GEN) geo = k1_geo(T, F);
  auto kern = gn_silu_conv_kernel<BM, BN, TW, TX, GEN>;
  static bool configured = false;  // per instantiation: above 48 KB needs the attribute
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, CV_MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const size_t smem = F32 ? conv32_smem_bytes(BM, BN, tt, ft, stages)
                          : conv_smem_bytes(BM, BN, geo.patch(tt, ft), stages, (int)sizeof(TW));
  if (smem > (size_t)CV_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int n_chunks = (C1 + C2 + CK - 1) / CK;
  const int cps = (n_chunks + splits - 1) / splits;
  if ((splits - 1) * cps >= n_chunks) return (int)cudaErrorInvalidValue;  // an empty split
  const int n_tiles = (Cout + BN - 1) / BN;
  dim3 grid((n_tiles + strip_tiles - 1) / strip_tiles,
            B * ((T + tt - 1) / tt) * ((F + ft - 1) / ft), splits);
  const TX *px1 = static_cast<const TX*>(x1), *px2 = static_cast<const TX*>(x2);
  const TW* pw = static_cast<const TW*>(w);
  const float *pa = static_cast<const float*>(a), *pc = static_cast<const float*>(c),
              *ps = static_cast<const float*>(wscale);
  TX* po = static_cast<TX*>(out);
  if (splits == 1) {
    kern<<<grid, THREADS, smem, stream>>>(px1, px2, pa, pc, pw, ps, bias, p16, po, T, F, C1, C2,
                                          Cout, tt, ft, strip_tiles, stages, cps, geo);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
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
                                         F, C1, C2, Cout, tt, ft, strip_tiles, stages, cps, geo);
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
    return a2k::conv_launch<256, 64>(x1, x2, a, c, w, bias, p16, out, B, T, F, C1, C2, Cout,
                                          tt, ft, strip_tiles, stages, splits, s);
  if (bm == 128 && bn == 128)
    return a2k::conv_launch<128, 128>(x1, x2, a, c, w, bias, p16, out, B, T, F, C1, C2, Cout,
                                           tt, ft, strip_tiles, stages, splits, s);
  if (bm == 64 && bn == 128)
    return a2k::conv_launch<64, 128>(x1, x2, a, c, w, bias, p16, out, B, T, F, C1, C2, Cout,
                                          tt, ft, strip_tiles, stages, splits, s);
  if (bm == 64 && bn == 64)
    return a2k::conv_launch<64, 64>(x1, x2, a, c, w, bias, p16, out, B, T, F, C1, C2, Cout,
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
    return a2k::conv_launch<256, 64, int8_t>(x1, x2, a, c, wq, bias, p16, out, B, T, F, C1,
                                                  C2, Cout, tt, ft, strip_tiles, stages, splits,
                                                  s, wscale);
  if (bm == 128 && bn == 128)
    return a2k::conv_launch<128, 128, int8_t>(x1, x2, a, c, wq, bias, p16, out, B, T, F, C1,
                                                   C2, Cout, tt, ft, strip_tiles, stages, splits,
                                                   s, wscale);
  if (bm == 64 && bn == 128)
    return a2k::conv_launch<64, 128, int8_t>(x1, x2, a, c, wq, bias, p16, out, B, T, F, C1,
                                                  C2, Cout, tt, ft, strip_tiles, stages, splits,
                                                  s, wscale);
  if (bm == 64 && bn == 64)
    return a2k::conv_launch<64, 64, int8_t>(x1, x2, a, c, wq, bias, p16, out, B, T, F, C1,
                                                 C2, Cout, tt, ft, strip_tiles, stages, splits,
                                                 s, wscale);
  return (int)cudaErrorInvalidValue;
}

// K1 in f32 with its launch plan (3xTF32 on the tensor cores): as
// a2k_gn_silu_conv3x3_bf16 with x1, x2, w and out f32 (bias f32 or bf16, read
// as stored), (bm, bn) = (256, 64) only; stages 2 to 8 raw W tiles in the
// ring.
int a2k_gn_silu_conv3x3_f32(const void* x1, const void* x2, const void* a, const void* c,
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
  if (bm != a2k::CV32_BM || bn != a2k::CV32_BN) return (int)cudaErrorInvalidValue;
  return a2k::conv_launch<a2k::CV32_BM, a2k::CV32_BN, float, float>(
      x1, x2, a, c, w, bias, p16, out, B, T, F, C1, C2, Cout, tt, ft, strip_tiles, stages,
      splits, s);
}

// The plain conv on K1's bf16 kernel (the UNet's and the VAE decoder's
// convs outside the ResBlock bodies): out [B, T, F, Cout] = conv(pro([x1 ;
// x2]), w) + bias with one rounding, where pro is act 0: nothing, 2: x * a + c
// (a, c: f32 [B, C1+C2] from a2k_gn_stats, the GroupNorm folded), 1: silu of
// it; [x1 ; x2] bf16 [B, Ti, Fi, C1 (+C2)] read through a nearest-2x upsample
// where up is 1; w: bf16 [k, k, C1+C2, Cout] (HWIO), k 1 or 3, stride s 1 or
// 2, padding pt, pf before T and F (the output's extent gives the rest); bias
// as a2k_gn_silu_conv3x3_bf16's. The plan's arguments as K1's, stages at most
// k * k + 1 (the next chunk's patch lands with the W tile issued at its
// chunk's first tap and must be in before the chunk's last tap is done).
int a2k_conv2d_bf16(const void* x1, const void* x2, const void* a, const void* c, const void* w,
                    const void* bias, int param_dtype, void* out, int B, int T, int F, int Ti,
                    int Fi, int C1, int C2, int Cout, int k, int s, int up, int pt, int pf,
                    int act, int bm, int bn, int tt, int ft, int strip_tiles, int stages,
                    int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const a2k::ConvGeo geo{Ti, Fi, up, k, s, pt, pf, act};
  if (B <= 0 || T <= 0 || F <= 0 || Ti <= 0 || Fi <= 0 || C1 <= 0 || C2 < 0 || Cout <= 0 ||
      (C1 & 7) || (C2 & 7) || (Cout & 7) || (C2 > 0 && x2 == nullptr) || (k != 1 && k != 3) ||
      (s != 1 && s != 2) || (up != 0 && up != 1) || pt < 0 || pf < 0 || act < 0 || act > 2 ||
      (act && (a == nullptr || c == nullptr)) || tt < 1 || ft < 1 || tt * ft > bm ||
      strip_tiles < 1 || stages < 2 || stages > a2k::CV_MAX_STAGES || stages > k * k + 1 ||
      splits < 1 || splits > a2k::CV_MAX_SPLITS || (splits > 1 && strip_tiles != 1) ||
      (param_dtype != 0 && param_dtype != 1) || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool p16 = param_dtype == 1;
  if ((reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(x2) |
       reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(c) |
       reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(bias) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
#define A2K_CONV2D(BM_, BN_)                                                                   \
  if (bm == BM_ && bn == BN_)                                                                  \
    return a2k::conv_launch<BM_, BN_, a2k::bf16, a2k::bf16, true>(                             \
        x1, x2, a, c, w, bias, p16, out, B, T, F, C1, C2, Cout, tt, ft, strip_tiles, stages,   \
        splits, st, nullptr, geo);
  A2K_CONV2D(256, 64)
  A2K_CONV2D(128, 128)
  A2K_CONV2D(64, 128)
  A2K_CONV2D(64, 64)
#undef A2K_CONV2D
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
