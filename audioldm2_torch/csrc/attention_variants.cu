// K7 and K8: the two candidate self-attention designs of the A/B tool,
// softmax(q k^T * scale) v with no mask or bias, each rounding where its
// Pallas kernel rounds.
//
// K7 replaces tools/ab_attn_variants.py: v6bd_attention (:109, kernel
// _v6bd_kernel :53). The Pallas kernel builds a block-diagonal K/V
// [nh*T, 128] so that the TPU's MXU sees a 128-deep contraction; that is 4x
// the work, all of it on zeros. What it computes per head is exact softmax:
// logits = (q . k) * scale * log2(e) in f32, m = the whole row's max,
// p = exp2(logits - m), the row sum over the unrounded f32 p, p rounded to
// the output dtype before P.V (f32 accumulation), and the division by the
// sum at the end.
// K8 replaces tools/ab_attn_variants.py: v7_attention (:190, kernel
// _v7_kernel :152): p = exp2(clamp(logits, -100, 100)) with no max
// subtraction, pb = p rounded to v's dtype, the row sum over the rounded pb
// (the MXU's pb . ones), acc = pb . v in f32, out = acc / sum. Where a scaled
// logit passes +-100 the clamp makes v7 differ from softmax; K8 reproduces
// the clamp.
//
// Design (head packing per 128-channel block, the Hopper counterpart of the
// block-diagonal product): one block per (q tile of 64 rows, 128-channel
// column block, batch), 128 threads; the block holds all nh = 128 / D heads
// of its column block. Each K/V row of the block is one contiguous
// 128-channel load (256 bytes in bf16), staged once in shared memory for a
// 64-row tile and read by all nh heads, so nothing is computed on zeros.
// Each warp owns 16 q rows; per head it computes its [16, 64] logit tile,
// turns it into P in shared memory and accumulates P . V_h, so after a
// tile's loads a warp needs only its own rows. In bf16 both products run on
// the tensor cores (WMMA 16x16x16, f32 accumulation; D = 32 is two k-steps);
// in f32 on the FMA units so the result stays full f32 (no TF32).
//
// The max: v6bd subtracts the whole row's max, not a running one. An
// online softmax would round exp2(l - m_running) and then rescale, which
// moves bf16 results by about an ulp. K7 therefore makes two passes over
// K: the first computes each row's max, the second exp2, the sum and P.V,
// so it rounds p exactly where v6bd does, at 1.5x the products of one pass.
// K7 against its plain version is then limited by f32 summation order only
// (tolerance 2e-2 of max|out| in bf16, 1e-4 in f32, as every kernel here).
// K8 needs no max and no rescale: one pass.
//
// Bounds on the H100: at the A/B shapes (T = 1024, H = 8, D = 32, batch 2
// to 8) one call does 4*B*H*T^2*D flops (6.4 GFLOP at B = 6, ~6.5 us at
// 989 TF/s bf16) on 4*B*T*H*D*2 bytes (12.6 MB, ~3.8 us at 3.35 TB/s): it is
// compute-bound. This first version issues WMMA (mma.sync) from shared
// memory without cp.async/TMA pipelining or wgmma, and pays the P round
// trip through shared memory and the exp2 on every logit, so it sits well
// below that bound; the times are in PERF.md.
#include <math.h>

#include "common.cuh"

namespace a2k {

constexpr int AV_BQ = 64;       // q rows per block (16 per warp)
constexpr int AV_BKV = 64;      // K/V rows per tile
constexpr int AV_THREADS = 128;
constexpr int AV_CB = 128;      // channels per column block
constexpr int AV_SLD = AV_CB + 4;  // f32 logit / output tile row, per warp

template <typename T>
struct AvLayout {
  static constexpr int LDT = AV_CB + (sizeof(T) == 2 ? 8 : 4);   // Q/K/V rows
  static constexpr int PLD = AV_BKV + (sizeof(T) == 2 ? 8 : 4);  // P rows
  static constexpr size_t Q_BYTES = (size_t)AV_BQ * LDT * sizeof(T);
  static constexpr size_t KV_BYTES = (size_t)AV_BKV * LDT * sizeof(T);
  static constexpr size_t S_BYTES = (size_t)AV_BQ * AV_SLD * sizeof(float);
  static constexpr size_t P_BYTES = (size_t)AV_BQ * PLD * sizeof(T);
  static constexpr size_t TOTAL = Q_BYTES + 2 * KV_BYTES + S_BYTES + P_BYTES;
};

// rows [r0, r0 + 64) x the block's 128 channels -> shared memory, in 16-byte
// chunks; rows past Tn are zero.
template <typename T>
__device__ __forceinline__ void av_load_tile(T* dst, const T* __restrict__ src, int r0, int Tn,
                                             size_t row_stride) {
  constexpr int LDT = AvLayout<T>::LDT;
  constexpr int CHUNKS = AV_CB * (int)sizeof(T) / 16;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += AV_THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < Tn)
      v = *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(src +
                                          (size_t)(r0 + r) * row_stride) + 16 * c);
    *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dst + r * LDT) + 16 * c) = v;
  }
}

// S[16, 64] (f32, ld AV_SLD) = Q_h[16 rows of this warp] . K_h[64]^T
template <typename T, int D>
__device__ __forceinline__ void av_logits(const T* Qw, const T* Ks, float* Sw, int h, int lane) {
  constexpr int LDT = AvLayout<T>::LDT;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
#pragma unroll
    for (int n = 0; n < AV_BKV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kd = 0; kd < D; kd += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qw + h * D + kd, LDT);
        wmma::load_matrix_sync(b, Ks + (n * 16) * LDT + h * D + kd, LDT);
        wmma::mma_sync(s, a, b, s);
      }
      wmma::store_matrix_sync(Sw + n * 16, s, AV_SLD, wmma::mem_row_major);
    }
  } else {
    const int r = lane >> 1, c0 = (lane & 1) * (AV_BKV / 2);
    const float* qr = Qw + r * LDT + h * D;
    for (int j = 0; j < AV_BKV / 2; ++j) {
      const float* kr = Ks + (c0 + j) * LDT + h * D;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      Sw[r * AV_SLD + c0 + j] = acc;
    }
  }
}

template <typename T, int D, bool V7>
__global__ void __launch_bounds__(AV_THREADS)
attn_variant_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, int Tn, int H, float s2) {
  using L = AvLayout<T>;
  constexpr int LDT = L::LDT, PLD = L::PLD;
  constexpr int NH = AV_CB / D;
  extern __shared__ __align__(128) unsigned char av_smem[];
  T* Qs = reinterpret_cast<T*>(av_smem);
  T* Ks = reinterpret_cast<T*>(av_smem + L::Q_BYTES);
  T* Vs = reinterpret_cast<T*>(av_smem + L::Q_BYTES + L::KV_BYTES);
  float* Ss = reinterpret_cast<float*>(av_smem + L::Q_BYTES + 2 * L::KV_BYTES);
  T* Ps = reinterpret_cast<T*>(av_smem + L::Q_BYTES + 2 * L::KV_BYTES + L::S_BYTES);

  const int q0 = blockIdx.x * AV_BQ, cb = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rs = (size_t)H * D;  // token stride of [B, T, H*D]
  const size_t base = (size_t)b * Tn * rs + (size_t)cb * AV_CB;
  const T* Qw = Qs + warp * 16 * LDT;
  float* Sw = Ss + warp * 16 * AV_SLD;
  T* Pw = Ps + warp * 16 * PLD;
  // softmax element ownership: row r of the warp's 16, columns c0..c0+31
  const int r = lane >> 1, c0 = (lane & 1) * (AV_BKV / 2);

  av_load_tile<T>(Qs, q + base, q0, Tn, rs);

  float m[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) m[h] = -INFINITY;
  if constexpr (!V7) {  // pass 1: each row's max over all T, per head
    for (int kv0 = 0; kv0 < Tn; kv0 += AV_BKV) {
      __syncthreads();
      av_load_tile<T>(Ks, k + base, kv0, Tn, rs);
      __syncthreads();
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        av_logits<T, D>(Qw, Ks, Sw, h, lane);
        __syncwarp();
        float mx = -INFINITY;
        for (int j = 0; j < AV_BKV / 2; ++j)
          if (kv0 + c0 + j < Tn) mx = fmaxf(mx, Sw[r * AV_SLD + c0 + j] * s2);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        m[h] = fmaxf(m[h], mx);
        __syncwarp();
      }
    }
  }

  // pass 2 (K8's only pass): P, its row sum and P . V
  float l[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) l[h] = 0.f;
  using namespace nvcuda;
  constexpr int NFRAG = std::is_same<T, bf16>::value ? AV_CB / 16 : 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_tc[NFRAG];
  float acc_f[std::is_same<T, bf16>::value ? 1 : AV_CB / 2];
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int i = 0; i < NFRAG; ++i) wmma::fill_fragment(acc_tc[i], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < AV_CB / 2; ++i) acc_f[i] = 0.f;
  }

  for (int kv0 = 0; kv0 < Tn; kv0 += AV_BKV) {
    __syncthreads();
    av_load_tile<T>(Ks, k + base, kv0, Tn, rs);
    av_load_tile<T>(Vs, v + base, kv0, Tn, rs);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      av_logits<T, D>(Qw, Ks, Sw, h, lane);
      __syncwarp();
      float sum = 0.f;
      for (int j = 0; j < AV_BKV / 2; ++j) {
        const int c = c0 + j;
        float p = 0.f;
        if (kv0 + c < Tn) {
          const float s = Sw[r * AV_SLD + c] * s2;
          p = V7 ? exp2f(fminf(fmaxf(s, -100.f), 100.f)) : exp2f(s - m[h]);
        }
        const T pr = from_f<T>(p);
        sum += V7 ? to_f(pr) : p;  // v7 sums the rounded pb, v6bd the f32 p
        Pw[r * PLD + c] = pr;
      }
      l[h] += sum;
      __syncwarp();
      if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
#pragma unroll
          for (int kc = 0; kc < AV_BKV; kc += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
            wmma::load_matrix_sync(a, Pw + kc, PLD);
            wmma::load_matrix_sync(bv, Vs + kc * LDT + h * D + j * 16, LDT);
            wmma::mma_sync(acc_tc[h * (D / 16) + j], a, bv, acc_tc[h * (D / 16) + j]);
          }
        }
      } else {
        // lane owns row r and, of each head, the channels (lane & 1) * D/2 ..
        const int d0 = h * D + (lane & 1) * (D / 2);
        for (int c = 0; c < AV_BKV; ++c) {
          const float p = Pw[r * PLD + c];
          const float* vr = Vs + c * LDT + d0;
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc_f[h * (D / 2) + i] = fmaf(p, vr[i], acc_f[h * (D / 2) + i]);
        }
      }
      __syncwarp();
    }
  }

  // epilogue: the warp's [16, 128] accumulator through its logit tile, then
  // out = acc / sum in f32 with one rounding
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int i = 0; i < NFRAG; ++i)
      wmma::store_matrix_sync(Sw + i * 16, acc_tc[i], AV_SLD, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        Sw[r * AV_SLD + h * D + (lane & 1) * (D / 2) + i] = acc_f[h * (D / 2) + i];
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < NH; ++h) l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
  const int qi = q0 + warp * 16 + r;
  if (qi < Tn) {
    T* orow = o + base + (size_t)qi * rs;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      for (int i = 0; i < D / 2; ++i) {
        const int c = h * D + (lane & 1) * (D / 2) + i;
        orow[c] = from_f<T>(Sw[r * AV_SLD + c] / l[h]);
      }
    }
  }
}

template <typename T, int D, bool V7>
static int av_launch(const void* q, const void* k, const void* v, void* o, int B, int Tn, int H,
                     float s2, cudaStream_t stream) {
  auto kern = attn_variant_kernel<T, D, V7>;
  const int smem = (int)AvLayout<T>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tn + AV_BQ - 1) / AV_BQ, (H * D) / AV_CB, B);
  kern<<<grid, AV_THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), Tn, H,
                                           s2);
  return (int)cudaGetLastError();
}

template <typename T, bool V7>
static int av_dispatch(const void* q, const void* k, const void* v, void* o, int B, int Tn,
                       int H, int D, float s2, cudaStream_t stream) {
  switch (D) {
    case 16: return av_launch<T, 16, V7>(q, k, v, o, B, Tn, H, s2, stream);
    case 32: return av_launch<T, 32, V7>(q, k, v, o, B, Tn, H, s2, stream);
    case 64: return av_launch<T, 64, V7>(q, k, v, o, B, Tn, H, s2, stream);
    case 128: return av_launch<T, 128, V7>(q, k, v, o, B, Tn, H, s2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace a2k

extern "C" {

// q, k, v, o: [B, T, H, D] contiguous, H * D a multiple of 128, D in {16,
// 32, 64, 128}; s2 = scale * log2(e) as f32; variant 0 = v6bd (K7),
// 1 = v7 (K8); dtype 0 = f32, 1 = bf16.
int a2k_attention_variant(const void* q, const void* k, const void* v, void* o, int B, int T,
                          int H, int D, float s2, int variant, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((H * D) % a2k::AV_CB != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    return variant ? a2k::av_dispatch<a2k::bf16, true>(q, k, v, o, B, T, H, D, s2, s)
                   : a2k::av_dispatch<a2k::bf16, false>(q, k, v, o, B, T, H, D, s2, s);
  }
  return variant ? a2k::av_dispatch<float, true>(q, k, v, o, B, T, H, D, s2, s)
                 : a2k::av_dispatch<float, false>(q, k, v, o, B, T, H, D, s2, s);
}

}  // extern "C"
