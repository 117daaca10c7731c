// K2: flash self-attention, softmax(q k^T * scale) v with no mask or bias.
//
// Replaces audioldm2_tpu/ops/attention_pallas.py: fused_self_attention
// (:114, kernel _attn_kernel :58). The TPU kernel holds a q block's whole
// [block_q, T] logits row in VMEM; a Hopper block cannot, so this kernel
// streams K/V in 32-row tiles with an online softmax and never writes the
// [T, T] logits anywhere.
//
// One block per (64-row q tile, head, batch), 128 threads: two threads per
// q row, each holding half of the head dimension for q and the output
// accumulator; the two halves of each q.k dot product meet through one
// warp shuffle. Logits are scaled by scale*log2(e) and exponentiated with
// exp2, as the Pallas kernel does. The running max and sum are f32; P is
// rounded to v's dtype before the PV product (the Pallas kernel's
// p.astype(vh.dtype)) while the sum uses the unrounded P. Ragged K/V tiles
// are masked to -inf; ragged q rows are computed and not stored.
//
// Bounds on the H100: at the UNet's self-attention sites (T in {1024, 256,
// 64}, D = 32) the work is 4*T^2*D flops per head with T*D*3 elements of
// input, so it is compute-bound; this first version runs the products on
// the FMA units from f32 shared-memory tiles (no tensor cores yet), which
// is what bounds it.
#include <math.h>

#include "common.cuh"

namespace a2k {

constexpr int ATT_BQ = 64;
constexpr int ATT_BKV = 32;
constexpr int ATT_THREADS = 128;

template <typename T, int D>
__global__ void __launch_bounds__(ATT_THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, int Tn, int H, float scale_log2) {
  constexpr int DH = D / 2;
  __shared__ float Ks[ATT_BKV][D];
  __shared__ float Vs[ATT_BKV][D];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int qi = blockIdx.x * ATT_BQ + r;
  const bool valid = qi < Tn;
  const size_t rs = (size_t)H * D;  // stride between tokens of [B, T, H, D]

  float qv[DH], acc[DH];
  const T* qp = q + ((size_t)b * Tn + (valid ? qi : 0)) * rs + (size_t)h * D + half * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qv[d] = to_f(qp[d]);
    acc[d] = 0.f;
  }
  float m_i = -INFINITY, l_i = 0.f;

  for (int kv0 = 0; kv0 < Tn; kv0 += ATT_BKV) {
    __syncthreads();
    for (int idx = tid; idx < ATT_BKV * D; idx += ATT_THREADS) {
      const int j = idx / D, d = idx % D;
      const int kj = kv0 + j;
      float kk = 0.f, vv = 0.f;
      if (kj < Tn) {
        const size_t off = ((size_t)b * Tn + kj) * rs + (size_t)h * D + d;
        kk = to_f(k[off]);
        vv = to_f(v[off]);
      }
      Ks[j][d] = kk;
      Vs[j][d] = vv;
    }
    __syncthreads();

    float s[ATT_BKV];
    float mx = m_i;
#pragma unroll
    for (int j = 0; j < ATT_BKV; ++j) {
      float p = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) p = fmaf(qv[d], Ks[j][half * DH + d], p);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p *= scale_log2;
      if (kv0 + j >= Tn) p = -INFINITY;
      s[j] = p;
      mx = fmaxf(mx, p);
    }
    const float corr = exp2f(m_i - mx);  // 0 on the first tile (m_i = -inf)
    l_i *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < ATT_BKV; ++j) {
      const float p = exp2f(s[j] - mx);
      l_i += p;
      const float pr = to_f(from_f<T>(p));
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(pr, Vs[j][half * DH + d], acc[d]);
    }
    m_i = mx;
  }

  if (valid) {
    T* op = o + ((size_t)b * Tn + qi) * rs + (size_t)h * D + half * DH;
    const float inv = 1.f / l_i;
#pragma unroll
    for (int d = 0; d < DH; ++d) op[d] = from_f<T>(acc[d] * inv);
  }
}

template <typename T, int D>
static int attn_launch(const void* q, const void* k, const void* v, void* o, int B, int Tn,
                       int H, float scale_log2, cudaStream_t stream) {
  dim3 grid((Tn + ATT_BQ - 1) / ATT_BQ, H, B);
  flash_attn_kernel<T, D><<<grid, ATT_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Tn, H, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
static int attn_dispatch(const void* q, const void* k, const void* v, void* o, int B, int Tn,
                         int H, int D, float scale_log2, cudaStream_t stream) {
  switch (D) {
    case 32: return attn_launch<T, 32>(q, k, v, o, B, Tn, H, scale_log2, stream);
    case 64: return attn_launch<T, 64>(q, k, v, o, B, Tn, H, scale_log2, stream);
    case 128: return attn_launch<T, 128>(q, k, v, o, B, Tn, H, scale_log2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace a2k

extern "C" {

// q, k, v, o: [B, T, H, D] contiguous, D in {32, 64, 128}.
int a2k_flash_attention(const void* q, const void* k, const void* v, void* o, int B, int T,
                        int H, int D, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  if (dtype == 1) return a2k::attn_dispatch<a2k::bf16>(q, k, v, o, B, T, H, D, scale_log2, s);
  return a2k::attn_dispatch<float>(q, k, v, o, B, T, H, D, scale_log2, s);
}

}  // extern "C"
