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
// The bf16 design (flash_attn_bf16_kernel):
//  - Both products run on the tensor cores, mma.sync m16n8k16 with f32
//    accumulation, operands fetched with ldmatrix. One block owns 64 or 128
//    q rows of one (batch, head), one warp 16 of them.
//  - S = Q K^T stays in the accumulator registers. The online softmax works
//    on those fragments: a row's max and sum live in the four threads of a
//    quad (__shfl_xor_sync 1 and 2). P never touches shared memory: the
//    f32 accumulators are rounded to bf16 in registers (pack_bf16, the
//    rounding of from_f<bf16>) and two n8 accumulator tiles are exactly one
//    k16 A fragment of the second product. The row sum adds p before that
//    rounding.
//  - K and V tiles of 64 rows are staged in shared memory as bf16 by
//    16-byte cp.async with zero fill for rows past T, in a ring of three
//    stages (two at D = 128): the loads of tiles i+1 and i+2 are in flight
//    while tile i multiplies, with one __syncthreads() per tile.
//  - Rows are padded by 16 bytes (D + 8 elements): the eight 16-byte rows
//    one ldmatrix phase reads then fall into eight different 16-byte bank
//    groups for D = 32, 64 and 128, so no read conflicts. V is the B operand
//    of P V in [kv, D] row-major and is read with ldmatrix.trans.
//  - Q is loaded once (same path), kept as A fragments in registers.
//  - q, k and v each come with their own token and batch strides, so the
//    three column blocks of a fused QKV projection's [B, T, 3C] output are
//    read where they lie, with no copy before the call; the heads of a
//    token stay contiguous. The output is contiguous.
//  - Ragged edges: K/V rows past T are zero-filled and their logits set to
//    -inf after the product (only the last tile can have them, and the first
//    tile always holds a valid key, so the running max is finite before the
//    first exp2(m_i - mx)); ragged q rows are computed and not stored.
//  - Small shapes: 64 q rows (4 warps) per block unless 128-row blocks
//    still give every SM two blocks; K/V is not split across blocks.
// Why mma.sync and not wgmma: at D = 32 the second product's accumulator is
// only 32 columns wide and the first one's operand depth only 32, so a
// warpgroup instruction has little to amortize, while the softmax between
// the two products needs the accumulator in registers either way; the
// FlashAttention-2 design behind PyTorch's own flash backend uses mma.sync
// too. wgmma (m64n64k16 for S with B from shared memory, P as the register
// A operand of m64n32k16) would add asynchronous products, which let one
// warpgroup's softmax overlap the other's products, worth having once D or
// T grow; it needs the 128-byte-swizzled layouts and descriptors instead of
// the padded rows.
//
// The f32 path (flash_attn_f32_kernel) serves the f32 checks, not the step
// loop: it stays on the FMA units so that its result is full f32 (TF32
// would break the f32 oracle). Two threads per q row, 32-row K/V tiles in
// f32 shared memory.
#include <math.h>

#include "common.cuh"

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

// ---------------------------------------------------------------------------
// bf16: tensor cores, P in registers, K/V through a cp.async ring
// ---------------------------------------------------------------------------

constexpr int FA_BKV = 64;  // K/V rows per tile
constexpr int FA_PAD = 8;   // elements (16 bytes) of padding per shared-memory row

template <int D>
struct FaLayout {
  static constexpr int LD = D + FA_PAD;
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int STAGE_ELEMS = 2 * FA_BKV * LD;  // one K tile and one V tile
  static constexpr size_t bytes(int bq) {
    return ((size_t)bq * LD + (size_t)STAGES * STAGE_ELEMS) * sizeof(bf16);
  }
};

// 2^x on the special-function unit; ex2.approx(-inf) = +0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Element strides of q, k and v between tokens and between batch entries.
struct QkvStrides {
  long long q_tok, q_bat, k_tok, k_bat, v_tok, v_bat;
};

template <int D, int BQ>
__global__ void __launch_bounds__(BQ * 2)
flash_attn_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, QkvStrides st, int Tn,
                       int H, float scale_log2) {
  using L = FaLayout<D>;
  constexpr int LD = L::LD;
  constexpr int STAGES = L::STAGES;
  constexpr int THREADS = BQ * 2;  // one warp per 16 q rows
  constexpr int CPR = D / 8;       // 16-byte chunks per row
  constexpr int KS = D / 16;       // k16 steps of Q K^T
  constexpr int NT = FA_BKV / 8;   // n8 tiles of S
  constexpr int DT = D / 8;        // n8 tiles of O

  extern __shared__ __align__(128) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);  // [BQ][LD]
  bf16* KVs = Qs + BQ * LD;                     // STAGES x (K [BKV][LD], V [BKV][LD])

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + (size_t)b * st.q_bat + (size_t)h * D;
  const bf16* kb = k + (size_t)b * st.k_bat + (size_t)h * D;
  const bf16* vb = v + (size_t)b * st.v_bat + (size_t)h * D;
  const int n_tiles = (Tn + FA_BKV - 1) / FA_BKV;

  // rows [r0, r0 + rows) of one head -> shared memory; rows past Tn are zeros
  auto load_rows = [&](bf16* dst, const bf16* src, size_t tok, int r0, int rows) {
    for (int idx = tid; idx < rows * CPR; idx += THREADS) {
      const int r = idx / CPR, c = (idx % CPR) * 8;
      const bool ok = r0 + r < Tn;
      cp_async16(dst + r * LD + c, src + (size_t)(ok ? r0 + r : 0) * tok + c, ok);
    }
  };
  auto load_kv = [&](int tile) {
    bf16* dst = KVs + (tile % STAGES) * L::STAGE_ELEMS;
    load_rows(dst, kb, (size_t)st.k_tok, tile * FA_BKV, FA_BKV);
    load_rows(dst + FA_BKV * LD, vb, (size_t)st.v_tok, tile * FA_BKV, FA_BKV);
  };

  // group 0: Q; groups 1 .. STAGES-1: the first K/V tiles (empty groups keep
  // the count uniform when T has fewer tiles)
  load_rows(Qs, qb, (size_t)st.q_tok, q0, BQ);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // Q has landed
  __syncthreads();

  uint32_t qf[KS][4];
  {
    const bf16* p = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], p + ks * 16);
  }

  float of[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) of[j][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max, and this thread's share
  // of the running sum (the quad's shares are added at the end)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // per-lane offsets of the ldmatrix addresses inside a K and a V tile
  const int k_off = (((lane >> 4) << 3) + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const int v_off = ((((lane >> 3) & 1) << 3) + (lane & 7)) * LD + (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();  // tile `it` has landed (for this thread)
    __syncthreads();              // ... for all, and tile it-1's slot is free
    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);
    cp_async_commit();

    const bf16* Ks = KVs + (it % STAGES) * L::STAGE_ELEMS;
    const bf16* Vs = Ks + FA_BKV * LD;

    // S = Q K^T: [16, 64] per warp, f32, in registers
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + jp * 16 * LD + ks * 16 + k_off);
        mma_bf16_16816(s[2 * jp], qf[ks], kf[0], kf[1]);
        mma_bf16_16816(s[2 * jp + 1], qf[ks], kf[2], kf[3]);
      }
    }

#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    if (it == n_tiles - 1 && (Tn % FA_BKV) != 0) {  // zero-filled rows give logit 0, not -inf
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (it * FA_BKV + j * 8 + 2 * t + (e & 1) >= Tn) s[j][e] = -INFINITY;
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = fast_exp2(m0 - mx0), c1 = fast_exp2(m1 - mx1);  // 0 on the first tile
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      of[j][0] *= c0;
      of[j][1] *= c0;
      of[j][2] *= c1;
      of[j][3] *= c1;
    }

    // P = exp2(S - m), summed unrounded, rounded to bf16 as A fragments
    uint32_t pf[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = fast_exp2(s[j][0] - mx0), p1 = fast_exp2(s[j][1] - mx0);
      const float p2 = fast_exp2(s[j][2] - mx1), p3 = fast_exp2(s[j][3] - mx1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[j][0] = pack_bf16(p0, p1);
      pf[j][1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int kc = 0; kc < FA_BKV / 16; ++kc) {
      const uint32_t a[4] = {pf[2 * kc][0], pf[2 * kc][1], pf[2 * kc + 1][0], pf[2 * kc + 1][1]};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + kc * 16 * LD + dp * 16 + v_off);
        mma_bf16_16816(of[2 * dp], a, vf[0], vf[1]);
        mma_bf16_16816(of[2 * dp + 1], a, vf[2], vf[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const size_t rs = (size_t)H * D;  // the output is contiguous [B, T, H, D]
  bf16* ob = o + (size_t)b * Tn * rs + (size_t)h * D + 2 * t;
  if (r0 < Tn) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * rs + j * 8) =
          pack_bf16(of[j][0] * inv0, of[j][1] * inv0);
  }
  if (r1 < Tn) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * rs + j * 8) =
          pack_bf16(of[j][2] * inv1, of[j][3] * inv1);
  }
}

template <int D, int BQ>
static int attn_bf16_launch(const void* q, const void* k, const void* v, void* o,
                            const QkvStrides& st, int B, int Tn, int H, float scale_log2,
                            cudaStream_t stream) {
  auto kern = flash_attn_bf16_kernel<D, BQ>;
  const int smem = (int)FaLayout<D>::bytes(BQ);
  static bool configured = false;  // per instantiation: above 48 KB needs the attribute
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Tn + BQ - 1) / BQ, H, B);
  kern<<<grid, BQ * 2, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                       static_cast<const bf16*>(v), static_cast<bf16*>(o), st, Tn,
                                       H, scale_log2);
  return (int)cudaGetLastError();
}

// 128 q rows per block where that still gives every SM two blocks, else 64.
template <int D>
static int attn_bf16_pick(const void* q, const void* k, const void* v, void* o,
                          const QkvStrides& st, int B, int Tn, int H, float scale_log2,
                          cudaStream_t stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const long blocks128 = (long)((Tn + 127) / 128) * H * B;
  if (blocks128 >= 2L * sms)
    return attn_bf16_launch<D, 128>(q, k, v, o, st, B, Tn, H, scale_log2, stream);
  return attn_bf16_launch<D, 64>(q, k, v, o, st, B, Tn, H, scale_log2, stream);
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
    switch (D) {
      case 32: return a2k::attn_bf16_pick<32>(q, k, v, o, st, B, T, H, sl2, s);
      case 64: return a2k::attn_bf16_pick<64>(q, k, v, o, st, B, T, H, sl2, s);
      case 128: return a2k::attn_bf16_pick<128>(q, k, v, o, st, B, T, H, sl2, s);
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
