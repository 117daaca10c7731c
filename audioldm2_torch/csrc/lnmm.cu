// K3: LayerNorm + matmul and K4: GEGLU gate + matmul + residual, the
// spatial-transformer blocks' fused matmuls; K3q/K4q, their int8-weight
// variants; K5: matmul with an int8 weight.
//
// K3 replaces audioldm2_tpu/ops/lnmm_pallas.py: ln_matmul (:101, kernel
// _ln_matmul_kernel :83): out = LN(x) . W[C, N] + bias, LN stats in f32
// (eps given), the normalized row rounded to the weight dtype.
// K4 replaces lnmm_pallas.py: geglu_matmul (:221, kernel
// _geglu_matmul_kernel :202): out = residual + (a * gelu(g)) . W[F, N] +
// bias for h = [a | g], f32 accumulation, written in the residual dtype.
// The gelu is the exact erf form (erff); the Pallas kernel's rational erf
// exists only because Mosaic has no erf lowering.
//
// Neither the LN output nor the [M, F] gate product is written to device
// memory.
//
// Bounds on the H100: M = B*T from 128 to 6144 rows, C in {256, 384, 640},
// N from C to 8C (GEGLU proj_in); K4's K = F = 4C. At CFG batch 2 and in the deep levels
// (M = 128 to 512) a call must read more weight bytes than it has
// activation bytes and is bound by bytes and by latency (a few dozen
// blocks); at CFG batch 6 on the T = 1024 level (M = 6144) it does up to
// 6.4 GFLOP and is bound by the tensor cores.
//
// K3 and K4 in bf16 share one kernel (row_block_matmul_bf16_kernel below),
// templated on the pass that fills the row block's A tile (RowPass::LN,
// RowPass::GEGLU); everything a pass changes sits under if constexpr, so
// K3's instantiations compile as they did before K4 joined them. The launch
// plans (rows per block, N-tile width, strip length, stages) are chosen in
// Python, ops/_build.py: ln_matmul_plan and geglu_matmul_plan.
//  - One block owns a row block (64 or 128 rows) and a strip of N tiles. It
//    copies its rows of x to shared memory (cp.async, all rows in flight at
//    once), computes the LN statistics once from that copy (one warp per
//    row, four rows at a time, the row held in registers as f32; mean and
//    two-pass variance in f32) and overwrites it with the normalized row rounded once to bf16:
//    A[rows, C] sits in shared memory
//    (64 x 640 x 2 = 80 KB, 128 rows 160 KB, dynamic) in the layout the
//    products read, for the whole strip. The old path recomputed the
//    statistics and normalized the rows again for every 64 output columns.
//  - W tiles [64, BN] (BN 64 or 128) stream through a ring of 2 to 12 stages
//    by 16-byte cp.async, zero-filled past C and N. The ring runs over the
//    strip's (N tile, K tile) sequence without a break, so the next N
//    tile's first loads are in flight during this one's last products and
//    its epilogue; the first stages are started before the LN pass and land
//    behind it. One __syncthreads() per W tile; where the ring holds the
//    whole strip (small M: one N tile), one for all of them.
//  - Products by mma.sync m16n8k16 with ldmatrix (.trans for W, which is
//    [K, N] row-major), f32 accumulators in registers; 8 warps, each a
//    [BM / warps_m, 32] slice of the output tile. Rows of A and W are
//    padded by 16 bytes, which spreads the eight rows of an ldmatrix phase
//    over eight bank groups (C and BN are multiples of 64).
//  - Epilogue from registers: + bias in f32, one rounding, and a 4 x 4
//    transpose inside each quad (four shuffles) so that every thread stores
//    16 contiguous bytes. No staging tile in shared memory.
//  - No split-K and no workspace: the whole K = C lies in the block's A.
//    What fills the card is the strip length: short strips for small M.
//    A strip recomputes the LN of its row block, [rows, C] read once per
//    strip.
//  - The LN scale and bias and the linear bias are read as they are stored,
//    f32 or bf16 (the cast parameter tree's leaves; exact in f32 either
//    way), so no conversion kernels run before the launch.
//  - Ragged M and N are masked (zero rows, skipped stores); C and N must be
//    multiples of 8, C at most 768 for K3 (the main path has 256, 384 and
//    640) and the pointers 16-byte aligned. Other shapes, and f32, go to the
//    shared core, which still computes the same function.
// The rounding points are those of the shared core's K3; only the order of
// the f32 sums differs.
//
// K4 in bf16 on the same kernel (RowPass::GEGLU): the block forms
// u = a * gelu(g) of its rows once, in f32 with erff and one rounding to
// bf16, into the resident A tile [bm, F] (F = 1024, 1536, 2560; at 2560 a
// block of 64 rows would need 329 KB, so the plan takes 32 or 16 rows
// there, whose products need only four or two of the eight warps: the others
// copy and form the gate product with them); the epilogue adds the bias (read as
// stored) and the residual in f32 from registers and rounds once. No
// split-K, no workspace, one launch. h's row block is not staged in shared
// memory (it is twice A): each thread keeps four pairs of 16-byte loads in
// flight (eight pairs a thread). It replaces the shared core's K4, which evaluated erff for every
// A element once per 64-wide N tile and split K through a workspace.
//
// K3q in bf16 on the same kernel (TW = int8_t, RowPass::LN): the ring
// streams int8 [64, BN] tiles (half K3's bytes, so up to twelve fit where
// K3 holds fewer), each converted once, a step ahead of its products, into
// one of two bf16 staging tiles that the unchanged ldmatrix.trans path reads
// (exact: |q| <= 127; a byte-permute trick, no conversion instruction). A
// slot is free once its tile is converted, so the ring keeps one tile more
// in flight than K3's; the staging tiles cost one barrier a W tile. The
// epilogue forms acc * wscale + bias in f32 after the whole K is summed and
// rounds once. No split-K (the plan fills the card without one at every
// main-path shape), no workspace, one launch. It replaces the shared core's
// K3q, which normalized the rows again for every 64 output columns and split
// K through a workspace and a second launch.
//
// K4q and K5 in bf16 on the same kernel with K3q's int8 ring and staging
// tiles: K4q is RowPass::GEGLU with TW = int8_t (the gate product rounded
// once to bf16 into A, as the Pallas kernel does whatever h's dtype); K5 is
// RowPass::COPY: the block copies its rows of x into A by cp.async as they
// are (no statistics, no rounding) and the products start once they land.
// Both take K4's tiles, down to 16 rows, and its K split over a cluster; the
// epilogue forms acc * wscale + bias (+ residual) in f32 after the whole K
// (split: after the cluster sum) and rounds once. On the (32, 64) tile the
// four warps without products convert the next int8 tile beside the
// products instead of every warp after them (4-10% faster there, measured;
// not on the 16-row tiles, where it was 1-5% slower). No workspace, one
// launch. They replace the shared core's K4q and K5, which
// split K through a workspace and a second launch. Under tensor parallelism
// (parallel/collectives.py) K4q takes K4's f32-residual mode and K5 an
// f32-output mode: the same kernel with TR = float, which writes the f32 sum
// (* wscale, + bias and residual where given) unrounded, so that the ranks'
// sums are added in f32 and rounded once.
//
// K3 in f32, K3q, K4q and K5 in f32 (and at shapes their plans decline), and
// K4 in f32 are the shared GEMM core (common.cuh) with a prologue: K3's block
// first computes mean and rstd of its 64 rows (one warp per row, two-pass)
// into shared memory, then normalizes each A element as it loads; K4 forms
// a * gelu(g) from the two halves of each h row as it loads; K5 loads x as
// it is; small-M products split K (common.cuh).
//
// The int8 serving mode (ops/quant.py): K3q and K4q are the w_scale paths
// of the same Pallas kernels (ln_matmul :83-91 and geglu_matmul :202-209
// with an int8 weight): the LN output or the gate product is rounded to
// bf16 whatever the input dtype, the int8 weight tile is converted to bf16
// before the products (exact for |q| <= 127), and the
// per-column scale multiplies the f32 accumulator. K5 replaces
// lnmm_pallas.py: int8_matmul (:143, kernel _matmul_kernel :132), the
// attention to_out projections: the same GEMM core with the input as its
// own prologue, which is NOT rounded (the Pallas dot runs in x's dtype; an
// f32 input takes the FMA path with the exact int8 values, a bf16 one the
// row-block kernel above). They halve the weight bytes the GEMM streams,
// the larger share of these small-M products; int8 tensor-core MMA is later
// work.
#include <cooperative_groups.h>

#include "common.cuh"

namespace a2k {

template <typename T>
struct LnPrologue {
  const T* x;
  const float* gamma;
  const float* beta;
  int C;
  float eps;

  __device__ void block_init(int m0, int M, float* sm) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarps = GEMM_THREADS / 32;
    for (int r = warp; r < BM; r += nwarps) {
      const int m = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (m < M) {
        const T* row = x + (size_t)m * C;
        float s = 0.f;
        for (int i = lane; i < C; i += 32) s += to_f(row[i]);
        mean = warp_sum(s) / (float)C;
        float v = 0.f;
        for (int i = lane; i < C; i += 32) {
          const float d = to_f(row[i]) - mean;
          v += d * d;
        }
        rstd = rsqrtf(warp_sum(v) / (float)C + eps);
      }
      if (lane == 0) {
        sm[r] = mean;
        sm[BM + r] = rstd;
      }
    }
  }

  __device__ float operator()(int m, int k, const float* sm) const {
    const int r = m % BM;
    return (to_f(x[(size_t)m * C + k]) - sm[r]) * sm[BM + r] * gamma[k] + beta[k];
  }

  __device__ void eight(int m, int k, const float* sm, float v[8]) const {
    const int r = m % BM;
    float xv[8], gv[8], bv[8];
    load8(x + (size_t)m * C + k, xv);
    load8(gamma + k, gv);
    load8(beta + k, bv);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (xv[j] - sm[r]) * sm[BM + r] * gv[j] + bv[j];
  }
};

template <typename T>
struct GegluPrologue {
  const T* h;
  int F;

  __device__ void block_init(int, int, float*) const {}

  __device__ float operator()(int m, int k, const float*) const {
    const size_t row = (size_t)m * 2 * F;
    const float a = to_f(h[row + k]);
    const float g = to_f(h[row + F + k]);
    return a * (0.5f * g * (1.f + erff(g * 0.70710678118654752f)));
  }

  __device__ void eight(int m, int k, const float*, float v[8]) const {
    const size_t row = (size_t)m * 2 * F;
    float av[8], gv[8];
    load8(h + row + k, av);
    load8(h + row + F + k, gv);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = av[j] * (0.5f * gv[j] * (1.f + erff(gv[j] * 0.70710678118654752f)));
  }
};

// The input itself as the A operand (K5), in its own dtype.
template <typename T>
struct IdentityPrologue {
  const T* x;
  int K;

  __device__ void block_init(int, int, float*) const {}

  __device__ float operator()(int m, int k, const float*) const {
    return to_f(x[(size_t)m * K + k]);
  }

  __device__ void eight(int m, int k, const float*, float v[8]) const {
    load8(x + (size_t)m * K + k, v);
  }
};

// wscale null: w in T and T tiles; else w int8 with bf16 tiles (the int8
// w_scale paths round A to bf16); the output is in T either way.
template <typename T, typename Prologue>
static int lnmm_gemm(const Prologue& pro, const void* w, const void* wscale, const void* bias,
                     const void* residual, void* out, int M, int N, int K, void* ws,
                     int k_split, int vec, cudaStream_t stream) {
  if (wscale == nullptr)
    return launch_gemm<T, T, T>(pro, w, nullptr, bias, residual, out, static_cast<float*>(ws),
                                M, N, K, k_split, vec, stream);
  return launch_gemm<bf16, int8_t, T>(pro, w, wscale, bias, residual, out,
                                      static_cast<float*>(ws), M, N, K, k_split, vec, stream);
}

template <typename T>
static int ln_impl(const void* x, const void* gamma, const void* beta, const void* w,
                   const void* wscale, const void* bias, void* out, int M, int C, int N,
                   float eps, void* ws, int k_split, int vec, cudaStream_t stream) {
  LnPrologue<T> pro;
  pro.x = static_cast<const T*>(x);
  pro.gamma = static_cast<const float*>(gamma);
  pro.beta = static_cast<const float*>(beta);
  pro.C = C;
  pro.eps = eps;
  return lnmm_gemm<T>(pro, w, wscale, bias, nullptr, out, M, N, C, ws, k_split, vec, stream);
}

template <typename T>
static int geglu_impl(const void* h, const void* w, const void* wscale, const void* bias,
                      const void* residual, void* out, int M, int F, int N, void* ws,
                      int k_split, int vec, cudaStream_t stream) {
  GegluPrologue<T> pro;
  pro.h = static_cast<const T*>(h);
  pro.F = F;
  return lnmm_gemm<T>(pro, w, wscale, bias, residual, out, M, N, F, ws, k_split, vec, stream);
}

template <typename T>
static int int8_impl(const void* x, const void* wq, const void* wscale, const void* bias,
                     void* out, int M, int K, int N, void* ws, int k_split, int vec,
                     cudaStream_t stream) {
  IdentityPrologue<T> pro;
  pro.x = static_cast<const T*>(x);
  pro.K = K;
  return launch_gemm<T, int8_t, T>(pro, wq, wscale, bias, nullptr, out, static_cast<float*>(ws),
                                   M, N, K, k_split, vec, stream);
}

// ---------------------------------------------------------------------------
// K3 in bf16: LN once per row block into shared memory, W through a
// cp.async ring, mma.sync products, epilogue from registers
// ---------------------------------------------------------------------------

constexpr int LT_BK = 64;        // K rows per W tile
constexpr int LT_THREADS = 256;  // 8 warps
constexpr int LT_PAD = 8;        // elements (16 bytes) of padding per shared-memory row
constexpr int LT_MAX_SMEM = 232448;
constexpr int LT_LN_CH = 3;      // 16-byte chunks of a row a lane holds in registers
constexpr int LT_MAX_C = 32 * LT_LN_CH * 8;  // 768: the widest row the kernel takes

// The pass that fills a row block's A tile: K3's LayerNorm of x [M, C],
// K4's gate product u = a * gelu(g) of h = [a | g], [M, 2C] (C = F), or K5's
// copy of x [M, C] as it is (C = K).
enum class RowPass { LN, GEGLU, COPY };

// TW: the weight's type. bf16 (K3, K4), or int8 (K3q, K4q, K5; COPY takes
// only int8): then the ring holds int8 tiles, each converted once into one
// of two bf16 staging tiles that the products read, and the per-column
// scale wscale multiplies the f32 sums in the epilogue.
//
// TR: the residual's and the output's type. bf16, or float for the
// tensor-parallel modes, whose per-rank sums are added over the ranks in f32
// and rounded once after that: K4's and K4q's f32-residual mode (bf16 h, the
// residual read and the sum written in f32, no rounding) and K5's f32-output
// mode (the product * wscale (+ bias) written in f32, no rounding).
template <RowPass PASS, int BM, int BN, typename TW = bf16, typename TR = bf16>
__global__ void __launch_bounds__(LT_THREADS)
row_block_matmul_bf16_kernel(const bf16* __restrict__ x, const void* __restrict__ gamma,
                             const void* __restrict__ beta, const TW* __restrict__ w,
                             const float* __restrict__ wscale,
                             const void* __restrict__ bias, bool p16,
                             const TR* __restrict__ residual, TR* __restrict__ out, int M,
                             int C, int N, float eps, int strip_tiles, int stages) {
  constexpr bool Q = std::is_same<TW, int8_t>::value;
  constexpr bool F32_OUT = std::is_same<TR, float>::value;
  static_assert(Q || PASS != RowPass::COPY, "the copy pass is K5's, whose weight is int8");
  static_assert(!F32_OUT || PASS != RowPass::LN, "the f32 output is K4's, K4q's and K5's");
  constexpr int THREADS = LT_THREADS;
  // warps that run products: one per 16 x 32 slice of the tile, at most all;
  // in a smaller tile the others only copy and form A
  constexpr int MMA_WARPS = BM * BN / 512 < THREADS / 32 ? BM * BN / 512 : THREADS / 32;
  constexpr int WARPS_N = BN / 32, WARPS_M = MMA_WARPS / WARPS_N;
  constexpr int WM = BM / WARPS_M;  // rows per warp: 64, 32 or 16
  constexpr int MT = WM / 16;       // m16 tiles per warp; its 32 columns are 4 n8 tiles
  constexpr int B_LD = BN + LT_PAD;
  constexpr int W_STAGE = LT_BK * B_LD;
  constexpr int R_LD = Q ? BN + 16 : B_LD;  // a ring row, in TW elements (int8: 16 bytes of pad)
  constexpr int R_STAGE = LT_BK * R_LD;
  constexpr int CPR = BN * (int)sizeof(TW) / 16;  // 16-byte chunks per W tile row
  // int8: where the tile leaves warps without products and they take the
  // next W tile in one or two even steps a thread (the (32, 64) tile), those
  // warps alone convert it while the others multiply this one; else every
  // thread converts, after its products (measured faster on the 16-row
  // tiles, whose idle warps would each convert more than the products last)
  constexpr int IDLE_THREADS = THREADS - MMA_WARPS * 32;
  constexpr int W_CHUNKS = LT_BK * (BN / 16);  // 16-byte int8 chunks of a W tile
  constexpr bool CVT_IDLE = Q && IDLE_THREADS > 0 && W_CHUNKS % IDLE_THREADS == 0 &&
                            W_CHUNKS <= 2 * IDLE_THREADS;
  constexpr int CVT_T0 = CVT_IDLE ? MMA_WARPS * 32 : 0;  // the first converting thread

  extern __shared__ __align__(128) unsigned char lt_smem[];
  // K4, K4q and K5 may split K over a thread-block cluster of gridDim.z
  // blocks, one N tile each: block z takes the K tiles [z * kps, (z + 1) *
  // kps), columns [k_lo, k_lo + k_len) of x (h's halves) and rows of W. K3
  // takes all of K.
  int k_lo = 0, k_len = C;
  if constexpr (PASS != RowPass::LN) {
    const int kps = ((C + LT_BK - 1) / LT_BK + gridDim.z - 1) / gridDim.z;
    k_lo = blockIdx.z * kps * LT_BK;
    k_len = min(C - k_lo, kps * LT_BK);
  }
  const bool split = PASS != RowPass::LN && gridDim.z > 1;
  const int KT = (k_len + LT_BK - 1) / LT_BK;
  const int Cp = KT * LT_BK;  // A's columns, zero past k_len
  const int A_LD = Cp + LT_PAD;
  bf16* As = reinterpret_cast<bf16*>(lt_smem);  // [BM][A_LD]
  bf16* Ws = As + (size_t)BM * A_LD;  // stages x [LT_BK][B_LD]; int8: the two staging tiles
  TW* Wr;                             // the ring: stages x [LT_BK][R_LD]
  if constexpr (Q)
    Wr = reinterpret_cast<TW*>(Ws + 2 * W_STAGE);
  else
    Wr = Ws;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const bool mma_warp = MMA_WARPS == THREADS / 32 || warp < MMA_WARPS;
  const int m0 = blockIdx.y * BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int tile0 = blockIdx.x * strip_tiles;
  const int my_tiles = min(strip_tiles, n_tiles - tile0);
  const int total = my_tiles * KT;  // W tiles of this strip, N tile by N tile

  // The W tiles of the strip, N tile by N tile, K tile by K tile, go round the
  // ring: load_next() starts the next one (or nothing past the last) and
  // commits a group either way, so the group count stays uniform.
  constexpr int W_ROWS = THREADS / CPR;  // W tile rows one pass of the block copies
  const int w_r = tid / CPR, w_c = (tid % CPR) * (16 / (int)sizeof(TW));
  const TW* w_src = w + (size_t)(k_lo + w_r) * N + w_c;
  TW* w_dst = Wr + w_r * R_LD + w_c;
  int ld_nt = 0, ld_kt = 0, ld_slot = 0;
  auto load_next = [&]() {
    if (ld_nt < my_tiles) {
      const int n0 = (tile0 + ld_nt) * BN, k0 = ld_kt * LT_BK;
      const TW* src = w_src + (size_t)k0 * N + n0;
      TW* dst = w_dst + (size_t)ld_slot * R_STAGE;
      const bool n_ok = n0 + w_c < N;
#pragma unroll
      for (int j = 0; j < LT_BK / W_ROWS; ++j) {
        const bool ok = n_ok && k0 + j * W_ROWS + w_r < k_len;
        cp_async16(dst + j * W_ROWS * R_LD, ok ? src + (size_t)j * W_ROWS * N : w, ok);
      }
      if (++ld_kt == KT) {
        ld_kt = 0;
        ++ld_nt;
      }
      if (++ld_slot == stages) ld_slot = 0;
    }
    cp_async_commit();
  };

  // Where the ring holds the whole strip (total <= stages: the small-M
  // shapes, one N tile of at most twelve K tiles) every W tile is started now,
  // and the products run through them behind one wait and one barrier (int8:
  // one barrier a tile, for its staging tiles). The int8 ring keeps one tile
  // more in flight: a slot is free once its tile is converted, a step ahead.
  const bool resident = total <= stages;
  const int started = resident ? total : stages - (Q ? 0 : 1);
  const int chunks = k_len / 8;
  if constexpr (PASS == RowPass::GEGLU) {
    // The first W tiles fly while the block forms u = a * gelu(g) of its rows
    // into As, once, in f32 with erff and one rounding to bf16 (rows past M
    // and columns past k_len as zeros). h's row block is twice A, more than
    // shared memory holds at F = 2560, so it is not staged there: each of
    // the block's threads keeps eight 16-byte pairs of loads in flight in
    // registers.
    for (int s = 0; s < started; ++s) load_next();
    const int kc = Cp / 8;  // 16-byte chunks of an A row
    constexpr int ILP = 8;
    for (int i0 = tid; i0 < BM * kc; i0 += ILP * THREADS) {
      uint4 av[ILP], gv[ILP];
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const int i = i0 + u * THREADS, r = i / kc, ch = i % kc, m = m0 + r;
        av[u] = gv[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < BM * kc && m < M && ch < chunks) {
          const bf16* hrow = x + (size_t)m * 2 * C + k_lo + ch * 8;
          av[u] = *reinterpret_cast<const uint4*>(hrow);
          gv[u] = *reinterpret_cast<const uint4*>(hrow + C);
        }
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const int i = i0 + u * THREADS;
        if (i < BM * kc) {
          float a[8], gt[8], y[8];
          unpack8(av[u], a);
          unpack8(gv[u], gt);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            y[e] = a[e] * (0.5f * gt[e] * (1.f + erff(gt[e] * 0.70710678118654752f)));
          store8(As + (size_t)(i / kc) * A_LD + (i % kc) * 8, y);
        }
      }
    }
  } else if constexpr (PASS == RowPass::COPY) {
    // group 0: the row block's x as it is (the Pallas dot runs in x's dtype,
    // so nothing is rounded), rows past M and columns past k_len as zeros;
    // then the first W tiles. No pass: the products wait only for the copies.
    const int kc = Cp / 8;  // 16-byte chunks of an A row
    for (int i = tid; i < BM * kc; i += THREADS) {
      const int r = i / kc, ch = i % kc, m = m0 + r;
      const bool ok = m < M && ch < chunks;
      cp_async16(As + (size_t)r * A_LD + ch * 8, ok ? x + (size_t)m * C + k_lo + ch * 8 : x, ok);
    }
    cp_async_commit();
    for (int s = 0; s < started; ++s) load_next();
  } else {
  // group 0: the row block's x, as it is, into As (rows past M as zeros, whose
  // LN is beta: finite, and never stored); then the first W tiles, which fly
  // while the rows are normalized
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    const bf16* xrow = x + (size_t)(m < M ? m : 0) * C;
    for (int ch = lane; ch < chunks; ch += 32)
      cp_async16(As + (size_t)r * A_LD + ch * 8, xrow + ch * 8, m < M);
  }
  cp_async_commit();
  for (int s = 0; s < started; ++s) load_next();
  // gamma and beta of this lane's chunks, fetched while x is on its way
  float gv[LT_LN_CH][8], bv[LT_LN_CH][8];
#pragma unroll
  for (int k = 0; k < LT_LN_CH; ++k) {
    if (lane + 32 * k < chunks) {
      load8_param(gamma, (lane + 32 * k) * 8, p16, gv[k]);
      load8_param(beta, (lane + 32 * k) * 8, p16, bv[k]);
    }
  }
  cp_async_wait_dyn(started);  // x, the oldest group, has landed
  __syncthreads();

  // LayerNorm in place, from shared memory: one warp per row, four rows at a
  // time so that their reductions overlap. f32 statistics, two-pass variance,
  // one rounding to bf16. A lane touches the same chunks in every pass, so it
  // only reads back its own writes and the passes need no barrier. The row
  // (C <= LT_MAX_C: at most LT_LN_CH chunks a lane) is read from shared
  // memory once and held in registers as f32.
  {
    constexpr int RPW = BM / (THREADS / 32);  // rows per warp: 8 or 16
    const float inv_c = 1.f / (float)C;
    for (int j0 = 0; j0 < RPW; j0 += 4) {
      bf16* arow = As + (size_t)(warp * RPW + j0) * A_LD;
      float mean[4], rstd[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) mean[u] = rstd[u] = 0.f;
      float v[4][LT_LN_CH][8];
#pragma unroll
      for (int k = 0; k < LT_LN_CH; ++k) {
        const int ch = lane + 32 * k;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint4 raw = make_uint4(0u, 0u, 0u, 0u);
          if (ch < chunks)
            raw = *reinterpret_cast<const uint4*>(arow + (size_t)u * A_LD + ch * 8);
          unpack8(raw, v[u][k]);
#pragma unroll
          for (int i = 0; i < 8; ++i) mean[u] += v[u][k][i];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) mean[u] = warp_sum(mean[u]) * inv_c;
#pragma unroll
      for (int k = 0; k < LT_LN_CH; ++k) {
        if (lane + 32 * k < chunks) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float d = v[u][k][i] - mean[u];
              rstd[u] = fmaf(d, d, rstd[u]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        rstd[u] = rsqrtf(warp_sum(rstd[u]) * inv_c + eps);
        mean[u] = -mean[u] * rstd[u];  // (x - mean) * rstd = x * rstd + this
      }
#pragma unroll
      for (int k = 0; k < LT_LN_CH; ++k) {
        const int ch = lane + 32 * k;
        if (ch < chunks) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float y[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              y[i] = fmaf(fmaf(v[u][k][i], rstd[u], mean[u]), gv[k][i], bv[k][i]);
            store8(arow + (size_t)u * A_LD + ch * 8, y);
          }
        }
      }
      for (int ch = chunks + lane; ch < Cp / 8; ch += 32) {  // zero columns past C
#pragma unroll
        for (int u = 0; u < 4; ++u)
          *reinterpret_cast<uint4*>(arow + (size_t)u * A_LD + ch * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  }

  // per-lane offsets of the ldmatrix addresses: A rows of the warp's m16
  // tiles, and W rows (k) by columns (n) of a k16 x n16 pair of n8 tiles
  const int a_off = (wm * WM + (lane & 15)) * A_LD + (lane >> 4) * 8;
  const int b_off = ((((lane >> 3) & 1) << 3) + (lane & 7)) * B_LD + wn * 32 + (lane >> 4) * 8;

  // int8: the W tile in ring slot `rs` into bf16 staging tile `sb`, 16
  // values a thread a step (zero-filled rows and columns stay zero); called
  // by the threads from CVT_T0 on
  constexpr int CVT_THREADS = THREADS - CVT_T0;
  const bool converts = !CVT_IDLE || !mma_warp;
  auto convert = [&](int rs, int sb) {
    const TW* src = Wr + (size_t)rs * R_STAGE;
    bf16* dst = Ws + (size_t)sb * W_STAGE;
#pragma unroll
    for (int u = 0; u < (W_CHUNKS + CVT_THREADS - 1) / CVT_THREADS; ++u) {
      const int c = tid - CVT_T0 + u * CVT_THREADS, r = c / (BN / 16), col = (c % (BN / 16)) * 16;
      if (W_CHUNKS % CVT_THREADS == 0 || c < W_CHUNKS) {
        uint4 lo, hi;
        int8x16_to_bf16(*reinterpret_cast<const uint4*>(src + r * R_LD + col), lo, hi);
        *reinterpret_cast<uint4*>(dst + r * B_LD + col) = lo;
        *reinterpret_cast<uint4*>(dst + r * B_LD + col + 8) = hi;
      }
    }
  };
  if constexpr (Q) {  // W tile 0 into staging tile 0 (As is written by now, for this thread)
    if (resident)
      cp_async_wait<0>();
    else
      cp_async_wait_dyn(started - 1);  // x and W tile 0 have landed
    __syncthreads();
    if (converts) convert(0, 0);
  }

  float acc[MT][4][4];
  int kt = 0, nt = 0, slot = 0;
  for (int i = 0; i < total; ++i) {
    if constexpr (Q) {
      // W tile i + 1 has landed (for this thread) ... for all; staging tile
      // i & 1 (converted a step ago) is written, the other and tile i's ring
      // slot are free; at i = 0, As is written
      if (!resident) cp_async_wait_dyn(stages - 2);
      __syncthreads();
      if (!resident) load_next();  // tile i + stages into tile i's slot
    } else if (!resident) {
      cp_async_wait_dyn(stages - 2);  // W tile i has landed (for this thread)
      __syncthreads();  // ... for all, tile i-1's slot is free; at i = 0, As is written
      load_next();                    // tile i + stages - 1 into the slot tile i - 1 left
    } else if (i == 0) {
      cp_async_wait<0>();
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
    const bf16* At = As + a_off + kt * LT_BK;
    if (mma_warp) {
    // two sets of fragments: the next k16 step's are fetched before this
    // step's products start, so the tensor cores do not wait for ldmatrix
    uint32_t af[2][MT][4], bf[2][2][4];
    auto fetch = [&](int set, int kk) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) ldmatrix_x4(af[set][mi], At + mi * 16 * A_LD + kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) ldmatrix_x4_trans(bf[set][np], Wt + kk * B_LD + np * 16);
    };
    fetch(0, 0);
#pragma unroll
    for (int ks = 0; ks < LT_BK / 16; ++ks) {
      if (ks + 1 < LT_BK / 16) fetch((ks + 1) & 1, (ks + 1) * 16);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16_16816(acc[mi][2 * np], af[ks & 1][mi], bf[ks & 1][np][0], bf[ks & 1][np][1]);
          mma_bf16_16816(acc[mi][2 * np + 1], af[ks & 1][mi], bf[ks & 1][np][2],
                         bf[ks & 1][np][3]);
        }
      }
    }
    }
    // int8: tile i + 1 into the other staging tile, behind this tile's
    // products, whose tensor-core work its loads and integer work overlap
    // (CVT_IDLE: by the warps without products, beside them)
    if constexpr (Q) {
      if (i + 1 < total && converts) convert((i + 1) % stages, (i + 1) & 1);
    }

    if (++kt == KT) {  // this N tile is complete: + bias, one rounding, 16-byte stores
      if (mma_warp && !split) {
      const int nb = (tile0 + nt) * BN + wn * 32;
      float bv[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nb + j * 8 + 2 * t;  // N is even, so col and col + 1 are in or out together
        bv[j][0] = bv[j][1] = 0.f;
        if (bias != nullptr && col < N) {
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
      float sv[4][2];  // int8: the columns' scales
      if constexpr (Q) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sc = nb + j * 8 + 2 * t;
          const float2 s2 = sc < N ? *reinterpret_cast<const float2*>(wscale + sc)
                                   : make_float2(0.f, 0.f);
          sv[j][0] = s2.x;
          sv[j][1] = s2.y;
        }
      }
      const int col = nb + t * 8;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t v[4];
          const int row = m0 + wm * WM + mi * 16 + half * 8 + g;
          if constexpr (F32_OUT) {  // (* wscale) + bias (+ residual) in f32, stored as f32 pairs
            if (row < M) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int rc = nb + j * 8 + 2 * t;
                if (rc < N) {
                  float y0 = acc[mi][j][2 * half], y1 = acc[mi][j][2 * half + 1];
                  if constexpr (Q) {
                    y0 = fmaf(y0, sv[j][0], bv[j][0]);
                    y1 = fmaf(y1, sv[j][1], bv[j][1]);
                  } else {
                    y0 += bv[j][0];
                    y1 += bv[j][1];
                  }
                  if constexpr (PASS == RowPass::GEGLU) {
                    const float2 r2 =
                        *reinterpret_cast<const float2*>(residual + (size_t)row * N + rc);
                    y0 += r2.x;
                    y1 += r2.y;
                  }
                  *reinterpret_cast<float2*>(out + (size_t)row * N + rc) = make_float2(y0, y1);
                }
              }
            }
            continue;
          }
          if constexpr (PASS == RowPass::GEGLU) {  // (* wscale) + bias + residual in f32, one rounding
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int rc = nb + j * 8 + 2 * t;
              float2 r2 = make_float2(0.f, 0.f);
              if (row < M && rc < N)
                r2 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(residual + (size_t)row * N + rc));
              if constexpr (Q)
                v[j] = pack_bf16(fmaf(acc[mi][j][2 * half], sv[j][0], bv[j][0]) + r2.x,
                                 fmaf(acc[mi][j][2 * half + 1], sv[j][1], bv[j][1]) + r2.y);
              else
                v[j] = pack_bf16(acc[mi][j][2 * half] + bv[j][0] + r2.x,
                                 acc[mi][j][2 * half + 1] + bv[j][1] + r2.y);
            }
          } else if constexpr (Q) {  // K3q, K5: * wscale + bias in f32, one rounding
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = pack_bf16(fmaf(acc[mi][j][2 * half], sv[j][0], bv[j][0]),
                               fmaf(acc[mi][j][2 * half + 1], sv[j][1], bv[j][1]));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = pack_bf16(acc[mi][j][2 * half] + bv[j][0], acc[mi][j][2 * half + 1] + bv[j][1]);
          }
          quad_transpose(v, t);
          if (row < M && col < N)
            *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
      }
      kt = 0;
      ++nt;
    }
  }

  if constexpr (PASS != RowPass::LN) {
    if (split) {
      // Each block's f32 tile in its own shared memory; then every block sums
      // its rows (r = rank mod splits) over the cluster's tiles in rank order,
      // (* wscale, after the sum) + bias (+ residual) in f32, one rounding,
      // 16-byte stores.
      namespace cg = cooperative_groups;
      cg::cluster_group cluster = cg::this_cluster();
      constexpr int C_LD = BN + 4;
      float* Cs = reinterpret_cast<float*>(lt_smem);
      cp_async_wait<0>();
      __syncthreads();
      if (mma_warp) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half)
              *reinterpret_cast<float2*>(Cs + (wm * WM + mi * 16 + half * 8 + g) * C_LD +
                                         wn * 32 + j * 8 + 2 * t) =
                  make_float2(acc[mi][j][2 * half], acc[mi][j][2 * half + 1]);
      }
      cluster.sync();
      const int splits = gridDim.z, rank = blockIdx.z;
      const int my_rows = (BM - rank + splits - 1) / splits;
      const int n0 = tile0 * BN;
      for (int it = tid; it < my_rows * (BN / 8); it += THREADS) {
        const int r = rank + (it / (BN / 8)) * splits, col = n0 + (it % (BN / 8)) * 8;
        const int row = m0 + r;
        if (row >= M || col >= N) continue;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int q = 0; q < splits; ++q) {
          const float* src = cluster.map_shared_rank(Cs, q) + r * C_LD + (col - n0);
          const float4 lo = *reinterpret_cast<const float4*>(src);
          const float4 hi = *reinterpret_cast<const float4*>(src + 4);
          v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
          v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
        }
        float bv[8], rv[8];
        if constexpr (PASS == RowPass::GEGLU) {
          load8_param(bias, col, p16, bv);
          load8(residual + (size_t)row * N + col, rv);
        } else {  // K5: no residual, and the bias may be null
#pragma unroll
          for (int e = 0; e < 8; ++e) bv[e] = 0.f;
          if (bias != nullptr) load8_param(bias, col, p16, bv);
        }
        if constexpr (Q) {
          float sv[8];
          load8(wscale + col, sv);
          if constexpr (PASS == RowPass::GEGLU) {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = fmaf(v[e], sv[e], bv[e]) + rv[e];
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = fmaf(v[e], sv[e], bv[e]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = v[e] + bv[e] + rv[e];
        }
        store8(out + (size_t)row * N + col, v);
      }
      cluster.sync();  // no block leaves while another still reads its tile
    }
  }
}

template <RowPass PASS, int BM, int BN, typename TW = bf16, typename TR = bf16>
static int row_block_launch(const void* x, const void* gamma, const void* beta, const void* w,
                            const void* bias, bool p16, const void* residual, void* out, int M,
                            int C, int N, float eps, int strip_tiles, int stages,
                            cudaStream_t stream, int splits = 1, const void* wscale = nullptr) {
  constexpr bool Q = std::is_same<TW, int8_t>::value;
  auto kern = row_block_matmul_bf16_kernel<PASS, BM, BN, TW, TR>;
  static bool configured = false;  // per instantiation: above 48 KB needs the attribute
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, LT_MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int kt_all = (C + LT_BK - 1) / LT_BK, kt = (kt_all + splits - 1) / splits;
  if ((splits - 1) * kt >= kt_all) return (int)cudaErrorInvalidValue;  // an empty split
  // A, then the ring (int8: two bf16 staging tiles and an int8 ring)
  size_t smem = ((size_t)BM * (kt * LT_BK + LT_PAD) +
                 (size_t)stages * LT_BK * (BN + LT_PAD)) * sizeof(bf16);
  if (Q)
    smem = ((size_t)BM * (kt * LT_BK + LT_PAD) + (size_t)2 * LT_BK * (BN + LT_PAD)) *
               sizeof(bf16) + (size_t)stages * LT_BK * (BN + 16);
  if (splits > 1 && smem < (size_t)BM * (BN + 4) * sizeof(float))
    smem = (size_t)BM * (BN + 4) * sizeof(float);  // the split epilogue's f32 tile
  if (smem > (size_t)LT_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int n_tiles = (N + BN - 1) / BN;
  dim3 grid((n_tiles + strip_tiles - 1) / strip_tiles, (M + BM - 1) / BM, splits);
  const bf16* px = static_cast<const bf16*>(x);
  const TR* pr = static_cast<const TR*>(residual);
  const TW* pw = static_cast<const TW*>(w);
  const float* ps = static_cast<const float*>(wscale);
  TR* po = static_cast<TR*>(out);
  if (splits == 1) {
    kern<<<grid, LT_THREADS, smem, stream>>>(px, gamma, beta, pw, ps, bias, p16, pr, po, M, C,
                                             N, eps, strip_tiles, stages);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(LT_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kern, px, gamma, beta, pw, ps, bias, p16, pr, po,
                                         M, C, N, eps, strip_tiles, stages);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// K4's, K4q's and K5's (bm, bn): (64, 128), (64, 64), (32, 128), (32, 64),
// (16, 128), (16, 64), 256 threads each (the smaller tiles run their products
// on 4 or 2 warps).
template <RowPass PASS, typename TW, typename TR = bf16>
static int thin_tile_launch(int bm, int bn, const void* x, const void* w, const void* bias,
                            bool p16, const void* residual, void* out, int M, int C, int N,
                            int strip_tiles, int stages, cudaStream_t s, int splits,
                            const void* wscale) {
#define A2K_THIN(BM_, BN_)                                                                     \
  if (bm == BM_ && bn == BN_)                                                                  \
    return row_block_launch<PASS, BM_, BN_, TW, TR>(x, nullptr, nullptr, w, bias, p16,       \
                                                    residual, out, M, C, N, 0.f, strip_tiles, \
                                                    stages, s, splits, wscale);
  A2K_THIN(64, 128)
  A2K_THIN(64, 64)
  A2K_THIN(32, 128)
  A2K_THIN(32, 64)
  A2K_THIN(16, 128)
  A2K_THIN(16, 64)
#undef A2K_THIN
  return (int)cudaErrorInvalidValue;
}

}  // namespace a2k

extern "C" {

// K3 in bf16 with its launch plan. x: bf16 [M, C]; gamma, beta: [C] and
// bias: [N] or null, all three f32 (param_dtype 0) or all three bf16 (1: the
// cast parameter tree's own leaves, read as they are); w: bf16 [C, N]; out:
// bf16 [M, N]. C (at most 768) and N multiples of 8, all pointers 16-byte
// aligned. (bm, bn) in {(128, 128), (64, 128), (64, 64)}: rows per block and
// N-tile width; strip_tiles: N tiles per block;
// stages: 2 to 12 W tiles in the ring, within 232448 bytes of shared memory.
int a2k_ln_matmul_bf16(const void* x, const void* gamma, const void* beta, const void* w,
                       const void* bias, int param_dtype, void* out, int M, int C, int N,
                       float eps, int bm, int bn, int strip_tiles, int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || C <= 0 || C > a2k::LT_MAX_C || N <= 0 || (C & 7) || (N & 7) ||
      strip_tiles < 1 || stages < 2 ||
      stages > 12 || (param_dtype != 0 && param_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool p16 = param_dtype == 1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gamma) |
       reinterpret_cast<uintptr_t>(beta) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  using a2k::RowPass;
  if (bm == 128 && bn == 128)
    return a2k::row_block_launch<RowPass::LN, 128, 128>(x, gamma, beta, w, bias, p16, nullptr,
                                                        out, M, C, N, eps, strip_tiles, stages,
                                                        s);
  if (bm == 64 && bn == 128)
    return a2k::row_block_launch<RowPass::LN, 64, 128>(x, gamma, beta, w, bias, p16, nullptr,
                                                       out, M, C, N, eps, strip_tiles, stages, s);
  if (bm == 64 && bn == 64)
    return a2k::row_block_launch<RowPass::LN, 64, 64>(x, gamma, beta, w, bias, p16, nullptr,
                                                      out, M, C, N, eps, strip_tiles, stages, s);
  return (int)cudaErrorInvalidValue;
}

// K3q in bf16 with its launch plan: as a2k_ln_matmul_bf16 with wq: int8
// [C, N] (N a multiple of 16) and wscale: f32 [N], out = LN(x) . wq * wscale
// + bias; stages: 2 to 12 int8 W tiles in the ring (besides two bf16 staging
// tiles).
int a2k_ln_matmul_q_bf16(const void* x, const void* gamma, const void* beta, const void* wq,
                         const void* wscale, const void* bias, int param_dtype, void* out, int M,
                         int C, int N, float eps, int bm, int bn, int strip_tiles, int stages,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || C <= 0 || C > a2k::LT_MAX_C || N <= 0 || (C & 7) || (N & 15) ||
      strip_tiles < 1 || stages < 2 || stages > 12 || (param_dtype != 0 && param_dtype != 1) ||
      wscale == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool p16 = param_dtype == 1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gamma) |
       reinterpret_cast<uintptr_t>(beta) | reinterpret_cast<uintptr_t>(wq) |
       reinterpret_cast<uintptr_t>(wscale) | reinterpret_cast<uintptr_t>(bias) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  using a2k::RowPass;
  if (bm == 128 && bn == 128)
    return a2k::row_block_launch<RowPass::LN, 128, 128, int8_t>(
        x, gamma, beta, wq, bias, p16, nullptr, out, M, C, N, eps, strip_tiles, stages, s, 1,
        wscale);
  if (bm == 64 && bn == 128)
    return a2k::row_block_launch<RowPass::LN, 64, 128, int8_t>(
        x, gamma, beta, wq, bias, p16, nullptr, out, M, C, N, eps, strip_tiles, stages, s, 1,
        wscale);
  if (bm == 64 && bn == 64)
    return a2k::row_block_launch<RowPass::LN, 64, 64, int8_t>(
        x, gamma, beta, wq, bias, p16, nullptr, out, M, C, N, eps, strip_tiles, stages, s, 1,
        wscale);
  return (int)cudaErrorInvalidValue;
}

// The argument checks of K4 in bf16 (both modes).
static int geglu_bf16_args_ok(const void* h, const void* w, const void* bias, int param_dtype,
                              const void* residual, const void* out, int M, int F, int N,
                              int strip_tiles, int stages, int splits) {
  if (M <= 0 || F <= 0 || N <= 0 || (F & 7) || (N & 7) || strip_tiles < 1 || stages < 2 ||
      stages > 12 || (param_dtype != 0 && param_dtype != 1) || bias == nullptr ||
      residual == nullptr || splits < 1 || splits > 8 || (splits > 1 && strip_tiles != 1))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(residual) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

// K4 in bf16 with its launch plan: out = residual + (a * gelu(g)) . w + bias
// for h = [a | g]. h: bf16 [M, 2F]; w: bf16 [F, N]; bias: [N], f32
// (param_dtype 0) or bf16 (1), read as stored; residual, out: bf16 [M, N]. F
// and N multiples of 8, all pointers 16-byte aligned. (bm, bn) in {(64, 128),
// (64, 64), (32, 128), (32, 64), (16, 128), (16, 64)}, 256 threads each (the
// smaller tiles run their products on 4 or 2 warps; all eight copy and form
// the gate product); strip_tiles and stages as for K3; splits 1 to 8: K split
// over a thread-block cluster (strip_tiles 1 then).
int a2k_geglu_matmul_bf16(const void* h, const void* w, const void* bias, int param_dtype,
                          const void* residual, void* out, int M, int F, int N, int bm, int bn,
                          int strip_tiles, int stages, int splits, void* stream) {
  const int rc = geglu_bf16_args_ok(h, w, bias, param_dtype, residual, out, M, F, N,
                                    strip_tiles, stages, splits);
  if (rc) return rc;
  return a2k::thin_tile_launch<a2k::RowPass::GEGLU, a2k::bf16>(
      bm, bn, h, w, bias, param_dtype == 1, residual, out, M, F, N, strip_tiles, stages,
      static_cast<cudaStream_t>(stream), splits, nullptr);
}

// K4's f32-residual mode (the tensor-parallel K4): as a2k_geglu_matmul_bf16
// with residual and out f32 [M, N]: out = residual + (a * gelu(g)) . w + bias
// summed in f32 and stored unrounded.
int a2k_geglu_matmul_bf16_f32res(const void* h, const void* w, const void* bias,
                                 int param_dtype, const void* residual, void* out, int M, int F,
                                 int N, int bm, int bn, int strip_tiles, int stages, int splits,
                                 void* stream) {
  const int rc = geglu_bf16_args_ok(h, w, bias, param_dtype, residual, out, M, F, N,
                                    strip_tiles, stages, splits);
  if (rc) return rc;
  return a2k::thin_tile_launch<a2k::RowPass::GEGLU, a2k::bf16, float>(
      bm, bn, h, w, bias, param_dtype == 1, residual, out, M, F, N, strip_tiles, stages,
      static_cast<cudaStream_t>(stream), splits, nullptr);
}

// The argument checks of K4q in bf16 (both modes).
static int geglu_q_bf16_args_ok(const void* h, const void* wq, const void* wscale,
                                const void* bias, int param_dtype, const void* residual,
                                const void* out, int M, int F, int N, int strip_tiles, int stages,
                                int splits) {
  if (M <= 0 || F <= 0 || N <= 0 || (F & 7) || (N & 15) || strip_tiles < 1 || stages < 2 ||
      stages > 12 || (param_dtype != 0 && param_dtype != 1) || wscale == nullptr ||
      bias == nullptr || residual == nullptr || splits < 1 || splits > 8 ||
      (splits > 1 && strip_tiles != 1))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(wq) |
       reinterpret_cast<uintptr_t>(wscale) | reinterpret_cast<uintptr_t>(bias) |
       reinterpret_cast<uintptr_t>(residual) | reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

// K4q in bf16 with its launch plan: as a2k_geglu_matmul_bf16 with wq: int8
// [F, N] (N a multiple of 16) and wscale: f32 [N], out = residual + (a *
// gelu(g)) . wq * wscale + bias; stages: 2 to 12 int8 W tiles in the ring
// (besides two bf16 staging tiles).
int a2k_geglu_matmul_q_bf16(const void* h, const void* wq, const void* wscale, const void* bias,
                            int param_dtype, const void* residual, void* out, int M, int F, int N,
                            int bm, int bn, int strip_tiles, int stages, int splits,
                            void* stream) {
  const int rc = geglu_q_bf16_args_ok(h, wq, wscale, bias, param_dtype, residual, out, M, F, N,
                                      strip_tiles, stages, splits);
  if (rc) return rc;
  return a2k::thin_tile_launch<a2k::RowPass::GEGLU, int8_t>(
      bm, bn, h, wq, bias, param_dtype == 1, residual, out, M, F, N, strip_tiles, stages,
      static_cast<cudaStream_t>(stream), splits, wscale);
}

// K4q's f32-residual mode (the tensor-parallel K4q): as
// a2k_geglu_matmul_q_bf16 with residual and out f32 [M, N]: out = residual +
// (a * gelu(g)) . wq * wscale + bias summed in f32 and stored unrounded.
int a2k_geglu_matmul_q_bf16_f32res(const void* h, const void* wq, const void* wscale,
                                   const void* bias, int param_dtype, const void* residual,
                                   void* out, int M, int F, int N, int bm, int bn,
                                   int strip_tiles, int stages, int splits, void* stream) {
  const int rc = geglu_q_bf16_args_ok(h, wq, wscale, bias, param_dtype, residual, out, M, F, N,
                                      strip_tiles, stages, splits);
  if (rc) return rc;
  return a2k::thin_tile_launch<a2k::RowPass::GEGLU, int8_t, float>(
      bm, bn, h, wq, bias, param_dtype == 1, residual, out, M, F, N, strip_tiles, stages,
      static_cast<cudaStream_t>(stream), splits, wscale);
}

// K5 in bf16 with its launch plan: out = x . wq * wscale + bias, x: bf16
// [M, K] as it is (K a multiple of 8); wq: int8 [K, N] (N a multiple of 16);
// wscale: f32 [N]; bias: [N], f32 (param_dtype 0) or bf16 (1), or null;
// out: bf16 [M, N]; all pointers 16-byte aligned. bm, bn, strip_tiles,
// stages (int8 tiles) and splits as for K4q; K is bounded only by the shared
// memory its row block takes.
static int int8_bf16_args_ok(const void* x, const void* wq, const void* wscale,
                             const void* bias, int param_dtype, const void* out, int M, int K,
                             int N, int strip_tiles, int stages, int splits) {
  if (M <= 0 || K <= 0 || N <= 0 || (K & 7) || (N & 15) || strip_tiles < 1 || stages < 2 ||
      stages > 12 || (param_dtype != 0 && param_dtype != 1) || wscale == nullptr ||
      splits < 1 || splits > 8 || (splits > 1 && strip_tiles != 1))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
       reinterpret_cast<uintptr_t>(wscale) | reinterpret_cast<uintptr_t>(bias) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

int a2k_int8_matmul_bf16(const void* x, const void* wq, const void* wscale, const void* bias,
                         int param_dtype, void* out, int M, int K, int N, int bm, int bn,
                         int strip_tiles, int stages, int splits, void* stream) {
  const int rc = int8_bf16_args_ok(x, wq, wscale, bias, param_dtype, out, M, K, N, strip_tiles,
                                   stages, splits);
  if (rc) return rc;
  return a2k::thin_tile_launch<a2k::RowPass::COPY, int8_t>(
      bm, bn, x, wq, bias, param_dtype == 1, nullptr, out, M, K, N, strip_tiles, stages,
      static_cast<cudaStream_t>(stream), splits, wscale);
}

// K5's f32-output mode (the tensor-parallel K5, the row-parallel to_out): as
// a2k_int8_matmul_bf16 with out f32 [M, N]: out = x . wq * wscale + bias
// summed in f32 and stored unrounded (the tp callers pass a null bias and add
// it after the sum over the ranks).
int a2k_int8_matmul_bf16_f32out(const void* x, const void* wq, const void* wscale,
                                const void* bias, int param_dtype, void* out, int M, int K, int N,
                                int bm, int bn, int strip_tiles, int stages, int splits,
                                void* stream) {
  const int rc = int8_bf16_args_ok(x, wq, wscale, bias, param_dtype, out, M, K, N, strip_tiles,
                                   stages, splits);
  if (rc) return rc;
  return a2k::thin_tile_launch<a2k::RowPass::COPY, int8_t, float>(
      bm, bn, x, wq, bias, param_dtype == 1, nullptr, out, M, K, N, strip_tiles, stages,
      static_cast<cudaStream_t>(stream), splits, wscale);
}

// x: [M, C]; gamma, beta: f32 [C]; w: [C, N]; bias: f32 [N] or null; out: [M, N];
// ws: null or the split-K workspace (f32, ceil(C / k_split) * M * N); vec: GEMM_VEC_* bits.
int a2k_ln_matmul(const void* x, const void* gamma, const void* beta, const void* w,
                  const void* bias, void* out, int M, int C, int N, float eps, void* ws,
                  int k_split, int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return a2k::ln_impl<a2k::bf16>(x, gamma, beta, w, nullptr, bias, out, M, C, N, eps, ws,
                                   k_split, vec, s);
  return a2k::ln_impl<float>(x, gamma, beta, w, nullptr, bias, out, M, C, N, eps, ws, k_split,
                             vec, s);
}

// As a2k_ln_matmul with wq: int8 [C, N] and wscale: f32 [N].
int a2k_ln_matmul_q(const void* x, const void* gamma, const void* beta, const void* wq,
                    const void* wscale, const void* bias, void* out, int M, int C, int N,
                    float eps, void* ws, int k_split, int vec, int dtype, void* stream) {
  if (wscale == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return a2k::ln_impl<a2k::bf16>(x, gamma, beta, wq, wscale, bias, out, M, C, N, eps, ws,
                                   k_split, vec, s);
  return a2k::ln_impl<float>(x, gamma, beta, wq, wscale, bias, out, M, C, N, eps, ws, k_split,
                             vec, s);
}

// h: [M, 2F]; w: [F, N]; bias: f32 [N]; residual, out: [M, N];
// ws: null or the split-K workspace (f32, ceil(F / k_split) * M * N); vec: GEMM_VEC_* bits.
int a2k_geglu_matmul(const void* h, const void* w, const void* bias, const void* residual,
                     void* out, int M, int F, int N, void* ws, int k_split, int vec, int dtype,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return a2k::geglu_impl<a2k::bf16>(h, w, nullptr, bias, residual, out, M, F, N, ws, k_split,
                                      vec, s);
  return a2k::geglu_impl<float>(h, w, nullptr, bias, residual, out, M, F, N, ws, k_split, vec,
                                s);
}

// As a2k_geglu_matmul with wq: int8 [F, N] and wscale: f32 [N].
int a2k_geglu_matmul_q(const void* h, const void* wq, const void* wscale, const void* bias,
                       const void* residual, void* out, int M, int F, int N, void* ws,
                       int k_split, int vec, int dtype, void* stream) {
  if (wscale == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return a2k::geglu_impl<a2k::bf16>(h, wq, wscale, bias, residual, out, M, F, N, ws, k_split,
                                      vec, s);
  return a2k::geglu_impl<float>(h, wq, wscale, bias, residual, out, M, F, N, ws, k_split, vec,
                                s);
}

// x: [M, K] (f32 or bf16, not rounded); wq: int8 [K, N]; wscale: f32 [N];
// bias: f32 [N] or null; out: [M, N] in x's dtype; ws, vec as above.
int a2k_int8_matmul(const void* x, const void* wq, const void* wscale, const void* bias,
                    void* out, int M, int K, int N, void* ws, int k_split, int vec, int dtype,
                    void* stream) {
  if (wscale == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return a2k::int8_impl<a2k::bf16>(x, wq, wscale, bias, out, M, K, N, ws, k_split, vec, s);
  return a2k::int8_impl<float>(x, wq, wscale, bias, out, M, K, N, ws, k_split, vec, s);
}

}  // extern "C"
