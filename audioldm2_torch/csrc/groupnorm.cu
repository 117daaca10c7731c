// K6: GroupNorm (+ SiLU) of a channels-last tensor, with no conv after it:
// the UNet's out_norm and the VAE encoder's and decoder's norm_out.
//
// Replaces audioldm2_tpu/ops/groupnorm_pallas.py: group_norm_silu (:51,
// kernel _gn_silu_kernel :24), which holds one batch row in VMEM and loops
// over static channel slices per group because Mosaic cannot reshape the
// lane dim. Here it is two launches:
//
//   1. a2k_gn_stats (gn_silu_conv.cu, K1's statistics pass with x2 = null):
//      a grid of row chunks per sample, per-chunk two-pass mean and centred
//      sum of squares, combined in chunk order by Chan's formula in the last
//      block of each sample, folded into the per-(B, C) affine
//      a = rstd * gamma, c = beta - mean * a;
//   2. a2k_gn_apply (this file): y = silu(x * a + c) (or x * a + c) in f32,
//      rounded once to x's dtype, one thread per eight consecutive channels
//      with 16-byte loads and stores where C is a multiple of 8 and the
//      pointers are 16-byte aligned, else one thread per element.
//
// Bounds on the H100: both passes are memory-bound. The statistics pass
// reads x twice (whole rows, 16-byte loads; the second read mostly from
// L1/L2) with about two blocks per SM at any batch; the apply pass reads x
// and writes y once, with the (a, c) rows of one batch (C floats each) held
// in L1/L2.
#include "common.cuh"

namespace a2k {

template <typename T, bool SILU>
__global__ void __launch_bounds__(256)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ c, T* __restrict__ out, size_t n, int C, size_t SC) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t ac = (i / SC) * C + i % C;
  float y = to_f(x[i]) * a[ac] + c[ac];
  if (SILU) y = y / (1.f + expf(-y));
  out[i] = from_f<T>(y);
}

// Elements 8j..8j+7: C % 8 == 0, so the eight share a batch row and lie on
// consecutive channels.
template <typename T, bool SILU>
__global__ void __launch_bounds__(256)
gn_apply8_kernel(const T* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ c, T* __restrict__ out, size_t n8, int C, size_t SC) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n8) return;
  const size_t e = j * 8;
  const size_t ac = (e / SC) * C + e % C;
  float xv[8], av[8], cv[8], v[8];
  load8(x + e, xv);
  load8(a + ac, av);
  load8(c + ac, cv);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float y = xv[k] * av[k] + cv[k];
    v[k] = SILU ? y / (1.f + expf(-y)) : y;
  }
  store8(out + e, v);
}

template <typename T, bool SILU>
static int gn_apply_impl(const void* x, const void* a, const void* c, void* out, int B, int S,
                         int C, int vec, cudaStream_t stream) {
  const size_t SC = (size_t)S * C;
  const size_t n = (size_t)B * SC;
  if (n == 0) return 0;
  if (vec) {
    const size_t n8 = n / 8;
    gn_apply8_kernel<T, SILU><<<(unsigned)((n8 + 255) / 256), 256, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(c),
        static_cast<T*>(out), n8, C, SC);
  } else {
    gn_apply_kernel<T, SILU><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(c),
        static_cast<T*>(out), n, C, SC);
  }
  return (int)cudaGetLastError();
}

}  // namespace a2k

extern "C" {

// x, out: [B, S, C] in the dtype's type; a, c: f32 [B, C] from a2k_gn_stats;
// silu: apply SiLU after the affine; vec: 1 for the eight-wide path (C % 8
// == 0, x and out 16-byte aligned).
int a2k_gn_apply(const void* x, const void* a, const void* c, void* out, int B, int S, int C,
                 int silu, int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec && C % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return silu ? a2k::gn_apply_impl<a2k::bf16, true>(x, a, c, out, B, S, C, vec, s)
                : a2k::gn_apply_impl<a2k::bf16, false>(x, a, c, out, B, S, C, vec, s);
  return silu ? a2k::gn_apply_impl<float, true>(x, a, c, out, B, S, C, vec, s)
              : a2k::gn_apply_impl<float, false>(x, a, c, out, B, S, C, vec, s);
}

}  // extern "C"
