// K1: GroupNorm + SiLU + 3x3 SAME conv, the UNet and VAE ResBlock body,
// and K1q, its int8-weight variant.
//
// K1 replaces audioldm2_tpu/ops/resblock_pallas.py: gn_silu_conv3x3 (:130),
// gn_silu_conv3x3_cat (:282), gn_silu_conv3x3_tiled (:426) and
// gn_silu_conv3x3_cat_tiled (:520). K1q replaces gn_silu_conv3x3_q (:157,
// kernel _kernel_q :62): int8 taps [3, 3, Cin, Cout] with a per-output-
// channel f32 scale applied once to the f32 accumulator, and the activation
// rounded to bf16 whatever x's dtype (:73-74), so its GEMM runs on the
// tensor cores even for f32 inputs and writes x's dtype. It halves the
// weight bytes, which at CFG batch 2 are the larger share of the deep
// levels' traffic (640x640x9 weights against M = 128 rows); the int8 tile
// is converted to bf16 as it is stored to shared memory (exact), and the
// concat parts go in as two pointers where the JAX package concatenates.
// The four Pallas K1 variants exist only because of the TPU's 16 MB scoped
// VMEM; here they are one design:
//
//   1. a2k_gn_stats: one block per (batch, group) reduces the group over
//      the whole sample and both concat parts, two-pass (mean, then the
//      centred sum of squares) with double partial sums, and emits the
//      folded per-(B, C) affine a = rstd * gamma, c = beta - mean * a (as
//      _fold_gn_affine does). The Pallas kernels use E[x^2] - mean^2,
//      which cancels at S = 65536 in the VAE decoder; two passes do not.
//   2. a2k_gn_silu_conv3x3: an NHWC implicit GEMM, M = B*T*F, N = Cout,
//      K = 9*Cin over the HWIO weight viewed as [9*Cin, Cout]. The A
//      prologue loads x at the tap's shifted (t, f), applies silu(x*a + c)
//      in f32, and returns 0 outside [0,T) x [0,F): SAME padding of the
//      *activated* tensor. A second input pointer covers the decoder's
//      virtual concat [x1 ; x2] (a group may straddle the split).
//
// Bounds on the H100: at the UNet's shapes (Cin <= 1280, S <= 4096) the
// conv is compute-bound (9*Cin MACs per output element) but small in M at
// the deep levels (M = 128 at 32 x 2, CFG batch 2), so the GEMM core splits
// K to fill the SMs; at the VAE decoder's 1024 x 64 levels the activation
// prologue (one expf per A element, recomputed for every 64-wide N tile)
// bounds it. Every intermediate (the normalized, activated tensor and the
// concat) stays out of device memory; the loads are 16 bytes wide where
// the channel counts allow, and not yet pipelined.
#include "common.cuh"

namespace a2k {

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

template <typename T>
__global__ void __launch_bounds__(256)
gn_stats_kernel(const T* __restrict__ x1, const T* __restrict__ x2, int S, int C1, int C2,
                int G, float eps, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ a_out,
                float* __restrict__ c_out) {
  __shared__ double scratch[32];
  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int Cin = C1 + C2;
  const int cg = Cin / G;
  const size_t n = (size_t)S * cg;

  auto load = [&](size_t i) -> float {
    const size_t sp = i / cg;
    const int ch = g * cg + (int)(i % cg);
    return ch < C1 ? to_f(x1[((size_t)b * S + sp) * C1 + ch])
                   : to_f(x2[((size_t)b * S + sp) * C2 + (ch - C1)]);
  };

  double s = 0.0;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) s += (double)load(i);
  const double mean = block_sum(s, scratch) / (double)n;
  double v = 0.0;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const double d = (double)load(i) - mean;
    v += d * d;
  }
  const double var = block_sum(v, scratch) / (double)n;
  const float rstd = rsqrtf((float)var + eps);
  const float meanf = (float)mean;
  for (int i = threadIdx.x; i < cg; i += blockDim.x) {
    const int ch = g * cg + i;
    const float av = rstd * gamma[ch];
    a_out[(size_t)b * Cin + ch] = av;
    c_out[(size_t)b * Cin + ch] = beta[ch] - meanf * av;
  }
}

template <typename T>
static int gn_stats_impl(const void* x1, const void* x2, int B, int S, int C1, int C2, int G,
                         float eps, const void* gamma, const void* beta, void* a_out,
                         void* c_out, cudaStream_t stream) {
  gn_stats_kernel<T><<<B * G, 256, 0, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), S, C1, C2, G, eps,
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(a_out), static_cast<float*>(c_out));
  return (int)cudaGetLastError();
}

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

// x2 may be null (C2 = 0). gamma, beta: f32 [C1+C2]; a_out, c_out: f32 [B, C1+C2].
int a2k_gn_stats(const void* x1, const void* x2, int B, int S, int C1, int C2, int G, float eps,
                 const void* gamma, const void* beta, void* a_out, void* c_out, int dtype,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return a2k::gn_stats_impl<a2k::bf16>(x1, x2, B, S, C1, C2, G, eps, gamma, beta, a_out,
                                         c_out, s);
  return a2k::gn_stats_impl<float>(x1, x2, B, S, C1, C2, G, eps, gamma, beta, a_out, c_out,
                                   s);
}

// w: [3, 3, C1+C2, Cout] in the activation dtype; bias: f32 [Cout];
// out: [B, T, F, Cout] in the activation dtype; ws: null or the split-K
// workspace (f32, ceil(9*(C1+C2) / k_split) * B*T*F * Cout); vec: GEMM_VEC_* bits.
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
