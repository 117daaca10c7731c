// K2: flash self-attention, softmax(q k^T * scale) v with no mask or bias.
//
// Replaces audioldm2_tpu/ops/attention_pallas.py: fused_self_attention
// (:114, kernel _attn_kernel :58). The TPU kernel holds a q block's whole
// [block_q, T] logits row in VMEM; a Hopper block cannot, so K/V stream in
// tiles through an online softmax and the [T, T] logits are never written
// anywhere. Logits are scaled by scale*log2(e) and exponentiated with exp2,
// as the Pallas kernel does; the running max and sum are f32; P is rounded
// to v's dtype before the PV product (the Pallas kernel's
// p.astype(vh.dtype)) while the sum runs over the unrounded P; one division
// at the end.
//
// Bounds on the H100: at the UNet's self-attention sites (T in {1024, 256,
// 64}, D = 32) a call does 4*B*H*T^2*D flops on 4*B*T*H*D elements, far
// above the card's 295 flops per byte: the products bound it, and beside
// them one exp2 per logit (with D = 32 a logit costs only 64 multiply-adds
// in each product, so the exponentials and the f32 softmax arithmetic weigh
// about as much as the products). At T = 64 and 256 a call has 40 to 100
// blocks of little work and is bound by latency.
//
// The bf16 path is the shared core of flash_bf16.cuh (mma.sync m16n8k16
// with ldmatrix, P in registers, a cp.async K/V ring; its design notes are
// there) in its ONLINE softmax mode: a running max, the accumulators and
// the sum rescaled as it grows.
//
// The f32 path (flash_attn_f32_kernel) serves the f32 checks, not the step
// loop: it stays on the FMA units so that its result is full f32 (TF32
// would break the f32 oracle). Two threads per q row, 32-row K/V tiles in
// f32 shared memory.
#include <math.h>

#include "flash_bf16.cuh"

namespace a2k {

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------

constexpr int ATT_BQ = 64;
constexpr int ATT_BKV = 32;
constexpr int ATT_THREADS = 128;

template <int D>
__global__ void __launch_bounds__(ATT_THREADS)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int Tn, int H,
                      float scale_log2) {
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
  const float* qp = q + ((size_t)b * Tn + (valid ? qi : 0)) * rs + (size_t)h * D + half * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qv[d] = qp[d];
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
        kk = k[off];
        vv = v[off];
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
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, Vs[j][half * DH + d], acc[d]);
    }
    m_i = mx;
  }

  if (valid) {
    float* op = o + ((size_t)b * Tn + qi) * rs + (size_t)h * D + half * DH;
    const float inv = 1.f / l_i;
#pragma unroll
    for (int d = 0; d < DH; ++d) op[d] = acc[d] * inv;
  }
}

template <int D>
static int attn_f32_launch(const void* q, const void* k, const void* v, void* o, int B, int Tn,
                           int H, float scale_log2, cudaStream_t stream) {
  dim3 grid((Tn + ATT_BQ - 1) / ATT_BQ, H, B);
  flash_attn_f32_kernel<D><<<grid, ATT_THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Tn, H, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace a2k

extern "C" {

// q, k, v: [B, T, H, D] with the H * D values of a token contiguous and
// the element strides between tokens and between batch entries given for
// each; o: [B, T, H, D] contiguous; D in {32, 64, 128}. In bf16 (dtype 1)
// the four pointers must be 16-byte aligned and every stride a multiple of
// 8; in f32 (dtype 0) q, k and v must be contiguous.
int a2k_flash_attention(const void* q, const void* k, const void* v, void* o, long long q_tok,
                        long long q_bat, long long k_tok, long long k_bat, long long v_tok,
                        long long v_bat, int B, int T, int H, int D, float scale, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * 1.4426950408889634f;
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const a2k::QkvStrides st = {q_tok, q_bat, k_tok, k_bat, v_tok, v_bat};
  const long long strides[6] = {q_tok, q_bat, k_tok, k_bat, v_tok, v_bat};
  if (dtype == 1) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
      return (int)cudaErrorMisalignedAddress;
    for (int i = 0; i < 6; ++i)
      if (strides[i] < 0 || (strides[i] & 7)) return (int)cudaErrorMisalignedAddress;
    constexpr auto ONLINE = a2k::Softmax::ONLINE;
    switch (D) {
      case 32: return a2k::attn_bf16_pick<32, ONLINE>(q, k, v, o, st, B, T, H, sl2, s);
      case 64: return a2k::attn_bf16_pick<64, ONLINE>(q, k, v, o, st, B, T, H, sl2, s);
      case 128: return a2k::attn_bf16_pick<128, ONLINE>(q, k, v, o, st, B, T, H, sl2, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  for (int i = 0; i < 6; ++i)
    if (strides[i] != (i % 2 ? (long long)T * H * D : (long long)H * D))
      return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return a2k::attn_f32_launch<32>(q, k, v, o, B, T, H, sl2, s);
    case 64: return a2k::attn_f32_launch<64>(q, k, v, o, B, T, H, sl2, s);
    case 128: return a2k::attn_f32_launch<128>(q, k, v, o, B, T, H, sl2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
