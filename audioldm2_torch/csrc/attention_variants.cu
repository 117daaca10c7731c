// K7 and K8: the two candidate self-attention designs of the A/B tool,
// softmax(q k^T * scale) v with no mask or bias, each rounding where its
// Pallas kernel rounds.
//
// K7 replaces tools/ab_attn_variants.py: v6bd_attention (:109, kernel
// _v6bd_kernel :53). The Pallas kernel builds a block-diagonal K/V
// [nh*T, 128] so that the TPU's MXU sees a 128-deep contraction; that is
// TPU machinery, 4x the work on zeros, and is not ported. What it computes
// per head is exact softmax: logits = (q . k) * scale * log2(e) in f32,
// m = the whole row's max, p = exp2(logits - m), the row sum over the
// unrounded f32 p, p rounded to the output dtype before P.V (f32
// accumulation), and the division by the sum at the end.
// K8 replaces tools/ab_attn_variants.py: v7_attention (:190, kernel
// _v7_kernel :152): p = exp2(clamp(logits, -100, 100)) with no max
// subtraction, pb = p rounded to v's dtype, the row sum over the rounded pb
// (the MXU's pb . ones), acc = pb . v in f32, out = acc / sum. Where a scaled
// logit passes +-100 the clamp makes v7 differ from softmax; K8 reproduces
// the clamp.
//
// bf16: K2's core (flash_bf16.cuh: mma.sync m16n8k16 with ldmatrix, P in
// registers, a three-stage cp.async K/V ring), one block per (64 or 128 q
// rows, head, batch) by K2's rule, in its ROW_MAX mode for K7 and its CLAMP
// mode for K8. K7 needs the max before it rounds any p (an online softmax
// would round exp2(l - m_running) instead, about an ulp away), so it makes
// two passes over K: the first runs only S = Q K^T and the row max, with K
// tiles alone through the ring (no exp2, no V loads, no P.V); the second is
// K2's loop with the max fixed, so nothing is rescaled. K8 makes one pass
// with no max and no rescale; its ragged K/V columns get p = 0 after the
// clamp.
//
// f32 serves the f32 checks: the FMA units, so that the result stays full
// f32 (no TF32). One block per (q tile of 64 rows, 128-channel column
// block, batch), 128 threads, holding the nh = 128 / D heads of its column
// block; each K/V row is one contiguous 128-channel load staged once in
// shared memory and read by all nh heads. Each warp owns 16 q rows; per head
// it computes its [16, 64] logit tile, turns it into P in shared memory and
// accumulates P . V_h; K7 first runs the whole logits once for the max.
//
// Bounds on the H100 (chip_smoke.kernel_work): one call does 4*B*H*T^2*D
// flops on 4*B*T*H*D elements; at the A/B shapes (T = 1024, H = 8, D = 32,
// batch 2 to 8) that is 6.4 GFLOP at B = 6 (~6.5 us at 989 TF/s bf16) on
// 12.6 MB (~3.8 us at 3.35 TB/s): the products bound it, and beside them
// one exp2 per logit, as for K2. K7's first pass adds half the products and
// no exp2.
#include <math.h>

#include "flash_bf16.cuh"

namespace a2k {

constexpr int AV_BQ = 64;       // q rows per block (16 per warp)
constexpr int AV_BKV = 64;      // K/V rows per tile
constexpr int AV_THREADS = 128;
constexpr int AV_CB = 128;      // channels per column block
constexpr int AV_LD = AV_CB + 4;    // Q/K/V rows
constexpr int AV_TLD = AV_BKV + 4;  // rows of a warp's [16, 64] logit and P tiles

// Q [64][LD], K and V [64][LD], S and P [64][TLD], f32
constexpr size_t AV_SMEM_BYTES = ((size_t)(AV_BQ + 2 * AV_BKV) * AV_LD + 2 * AV_BQ * AV_TLD) *
                                 sizeof(float);

// rows [r0, r0 + 64) x the block's 128 channels -> shared memory, in 16-byte
// chunks; rows past Tn are zero.
__device__ __forceinline__ void av_load_tile(float* dst, const float* __restrict__ src, int r0,
                                             int Tn, size_t row_stride) {
  constexpr int CHUNKS = AV_CB * (int)sizeof(float) / 16;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += AV_THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < Tn) v = reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * row_stride)[c];
    reinterpret_cast<float4*>(dst + r * AV_LD)[c] = v;
  }
}

// S[16, 64] (ld AV_TLD) = Q_h[16 rows of this warp] . K_h[64]^T; lane owns
// row lane / 2 and half the columns
template <int D>
__device__ __forceinline__ void av_logits(const float* Qw, const float* Ks, float* Sw, int h,
                                          int lane) {
  const int r = lane >> 1, c0 = (lane & 1) * (AV_BKV / 2);
  const float* qr = Qw + r * AV_LD + h * D;
  for (int j = 0; j < AV_BKV / 2; ++j) {
    const float* kr = Ks + (c0 + j) * AV_LD + h * D;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
    Sw[r * AV_TLD + c0 + j] = acc;
  }
}

template <int D, bool V7>
__global__ void __launch_bounds__(AV_THREADS)
attn_variant_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o, int Tn, int H,
                        float s2) {
  constexpr int NH = AV_CB / D;
  extern __shared__ __align__(128) unsigned char av_smem[];
  float* Qs = reinterpret_cast<float*>(av_smem);
  float* Ks = Qs + AV_BQ * AV_LD;
  float* Vs = Ks + AV_BKV * AV_LD;
  float* Ss = Vs + AV_BKV * AV_LD;
  float* Ps = Ss + AV_BQ * AV_TLD;

  const int q0 = blockIdx.x * AV_BQ, cb = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rs = (size_t)H * D;  // token stride of [B, T, H*D]
  const size_t base = (size_t)b * Tn * rs + (size_t)cb * AV_CB;
  const float* Qw = Qs + warp * 16 * AV_LD;
  float* Sw = Ss + warp * 16 * AV_TLD;
  float* Pw = Ps + warp * 16 * AV_TLD;
  // softmax element ownership: row r of the warp's 16, columns c0..c0+31
  const int r = lane >> 1, c0 = (lane & 1) * (AV_BKV / 2);

  av_load_tile(Qs, q + base, q0, Tn, rs);

  float m[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) m[h] = -INFINITY;
  if constexpr (!V7) {  // pass 1: each row's max over all T, per head
    for (int kv0 = 0; kv0 < Tn; kv0 += AV_BKV) {
      __syncthreads();
      av_load_tile(Ks, k + base, kv0, Tn, rs);
      __syncthreads();
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        av_logits<D>(Qw, Ks, Sw, h, lane);
        __syncwarp();
        float mx = -INFINITY;
        for (int j = 0; j < AV_BKV / 2; ++j)
          if (kv0 + c0 + j < Tn) mx = fmaxf(mx, Sw[r * AV_TLD + c0 + j] * s2);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        m[h] = fmaxf(m[h], mx);
        __syncwarp();
      }
    }
  }

  // pass 2 (K8's only pass): P, its row sum and P . V; in f32 the rounded
  // p of v7 is p itself
  float l[NH], acc[AV_CB / 2];
#pragma unroll
  for (int h = 0; h < NH; ++h) l[h] = 0.f;
#pragma unroll
  for (int i = 0; i < AV_CB / 2; ++i) acc[i] = 0.f;

  for (int kv0 = 0; kv0 < Tn; kv0 += AV_BKV) {
    __syncthreads();
    av_load_tile(Ks, k + base, kv0, Tn, rs);
    av_load_tile(Vs, v + base, kv0, Tn, rs);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      av_logits<D>(Qw, Ks, Sw, h, lane);
      __syncwarp();
      float sum = 0.f;
      for (int j = 0; j < AV_BKV / 2; ++j) {
        const int c = c0 + j;
        float p = 0.f;
        if (kv0 + c < Tn) {
          const float s = Sw[r * AV_TLD + c] * s2;
          p = V7 ? exp2f(fminf(fmaxf(s, -100.f), 100.f)) : exp2f(s - m[h]);
        }
        sum += p;
        Pw[r * AV_TLD + c] = p;
      }
      l[h] += sum;
      __syncwarp();
      // lane owns row r and, of each head, the channels (lane & 1) * D/2 ..
      const int d0 = h * D + (lane & 1) * (D / 2);
      for (int c = 0; c < AV_BKV; ++c) {
        const float p = Pw[r * AV_TLD + c];
        const float* vr = Vs + c * AV_LD + d0;
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[h * (D / 2) + i] = fmaf(p, vr[i], acc[h * (D / 2) + i]);
      }
      __syncwarp();
    }
  }

  // out = acc / sum, the two halves of each row's sum added first
#pragma unroll
  for (int h = 0; h < NH; ++h) l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
  const int qi = q0 + warp * 16 + r;
  if (qi < Tn) {
    float* orow = o + base + (size_t)qi * rs + (lane & 1) * (D / 2);
#pragma unroll
    for (int h = 0; h < NH; ++h)
      for (int i = 0; i < D / 2; ++i) orow[h * D + i] = acc[h * (D / 2) + i] / l[h];
  }
}

template <int D, bool V7>
static int av_f32_launch(const void* q, const void* k, const void* v, void* o, int B, int Tn,
                         int H, float s2, cudaStream_t stream) {
  auto kern = attn_variant_f32_kernel<D, V7>;
  const int smem = (int)AV_SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tn + AV_BQ - 1) / AV_BQ, (H * D) / AV_CB, B);
  kern<<<grid, AV_THREADS, smem, stream>>>(static_cast<const float*>(q),
                                           static_cast<const float*>(k),
                                           static_cast<const float*>(v), static_cast<float*>(o),
                                           Tn, H, s2);
  return (int)cudaGetLastError();
}

template <bool V7>
static int av_f32_dispatch(const void* q, const void* k, const void* v, void* o, int B, int Tn,
                           int H, int D, float s2, cudaStream_t stream) {
  switch (D) {
    case 16: return av_f32_launch<16, V7>(q, k, v, o, B, Tn, H, s2, stream);
    case 32: return av_f32_launch<32, V7>(q, k, v, o, B, Tn, H, s2, stream);
    case 64: return av_f32_launch<64, V7>(q, k, v, o, B, Tn, H, s2, stream);
    case 128: return av_f32_launch<128, V7>(q, k, v, o, B, Tn, H, s2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <Softmax MODE>
static int av_bf16_dispatch(const void* q, const void* k, const void* v, void* o, int B, int Tn,
                            int H, int D, float s2, cudaStream_t stream) {
  const long long tok = (long long)H * D, bat = tok * Tn;  // contiguous [B, T, H, D]
  const QkvStrides st = {tok, bat, tok, bat, tok, bat};
  switch (D) {
    case 16: return attn_bf16_pick<16, MODE>(q, k, v, o, st, B, Tn, H, s2, stream);
    case 32: return attn_bf16_pick<32, MODE>(q, k, v, o, st, B, Tn, H, s2, stream);
    case 64: return attn_bf16_pick<64, MODE>(q, k, v, o, st, B, Tn, H, s2, stream);
    case 128: return attn_bf16_pick<128, MODE>(q, k, v, o, st, B, Tn, H, s2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace a2k

extern "C" {

// q, k, v, o: [B, T, H, D] contiguous, H * D a multiple of 128, D in {16,
// 32, 64, 128}; s2 = scale * log2(e) as f32; variant 0 = v6bd (K7),
// 1 = v7 (K8); dtype 0 = f32, 1 = bf16 (the four pointers 16-byte aligned).
int a2k_attention_variant(const void* q, const void* k, const void* v, void* o, int B, int T,
                          int H, int D, float s2, int variant, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || H <= 0 || (H * D) % a2k::AV_CB != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
      return (int)cudaErrorMisalignedAddress;
    using a2k::Softmax;
    return variant ? a2k::av_bf16_dispatch<Softmax::CLAMP>(q, k, v, o, B, T, H, D, s2, s)
                   : a2k::av_bf16_dispatch<Softmax::ROW_MAX>(q, k, v, o, B, T, H, D, s2, s);
  }
  return variant ? a2k::av_f32_dispatch<true>(q, k, v, o, B, T, H, D, s2, s)
                 : a2k::av_f32_dispatch<false>(q, k, v, o, B, T, H, D, s2, s);
}

}  // extern "C"
