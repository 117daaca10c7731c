// K3: LayerNorm + matmul and K4: GEGLU gate + matmul + residual, the
// spatial-transformer blocks' fused matmuls.
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
// Both are the shared GEMM core (common.cuh) with a prologue: K3's block
// first computes mean and rstd of its 64 rows (one warp per row, two-pass,
// C <= 640 in the UNet) into shared memory, then normalizes each A element
// as it loads; K4 forms a * gelu(g) from the two halves of each h row as
// it loads. Neither the LN output nor the [M, F] gate product is written
// to device memory.
//
// Bounds on the H100: M = B*T <= 8192 rows, C in {256, 384, 640}, N up to
// 8C (GEGLU proj_in), so these are small-to-medium GEMMs whose time at
// CFG batch 2 is set by the weight read and by the prologue (K4 evaluates
// erff once per A element for every 64-wide N tile), not by the tensor
// cores; the small-M products of the deep levels split K (common.cuh).
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

template <typename T>
static int ln_impl(const void* x, const void* gamma, const void* beta, const void* w,
                   const void* bias, void* out, int M, int C, int N, float eps, void* ws,
                   int k_split, int vec, cudaStream_t stream) {
  LnPrologue<T> pro;
  pro.x = static_cast<const T*>(x);
  pro.gamma = static_cast<const float*>(gamma);
  pro.beta = static_cast<const float*>(beta);
  pro.C = C;
  pro.eps = eps;
  return launch_gemm<T>(pro, w, bias, nullptr, out, static_cast<float*>(ws), M, N, C, k_split,
                        vec, stream);
}

template <typename T>
static int geglu_impl(const void* h, const void* w, const void* bias, const void* residual,
                      void* out, int M, int F, int N, void* ws, int k_split, int vec,
                      cudaStream_t stream) {
  GegluPrologue<T> pro;
  pro.h = static_cast<const T*>(h);
  pro.F = F;
  return launch_gemm<T>(pro, w, bias, residual, out, static_cast<float*>(ws), M, N, F, k_split,
                        vec, stream);
}

}  // namespace a2k

extern "C" {

// x: [M, C]; gamma, beta: f32 [C]; w: [C, N]; bias: f32 [N] or null; out: [M, N];
// ws: null or the split-K workspace (f32, ceil(C / k_split) * M * N); vec: GEMM_VEC_* bits.
int a2k_ln_matmul(const void* x, const void* gamma, const void* beta, const void* w,
                  const void* bias, void* out, int M, int C, int N, float eps, void* ws,
                  int k_split, int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return a2k::ln_impl<a2k::bf16>(x, gamma, beta, w, bias, out, M, C, N, eps, ws, k_split,
                                   vec, s);
  return a2k::ln_impl<float>(x, gamma, beta, w, bias, out, M, C, N, eps, ws, k_split, vec, s);
}

// h: [M, 2F]; w: [F, N]; bias: f32 [N]; residual, out: [M, N];
// ws: null or the split-K workspace (f32, ceil(F / k_split) * M * N); vec: GEMM_VEC_* bits.
int a2k_geglu_matmul(const void* h, const void* w, const void* bias, const void* residual,
                     void* out, int M, int F, int N, void* ws, int k_split, int vec, int dtype,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return a2k::geglu_impl<a2k::bf16>(h, w, bias, residual, out, M, F, N, ws, k_split, vec, s);
  return a2k::geglu_impl<float>(h, w, bias, residual, out, M, F, N, ws, k_split, vec, s);
}

}  // extern "C"
