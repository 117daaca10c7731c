// The bf16 flash-attention core shared by K2 (attention.cu) and the A/B
// tool's K7 and K8 (attention_variants.cu): softmax(q k^T * scale) v with no
// mask or bias, in one of three softmax modes (Softmax below).
//
// Design:
//  - Both products run on the tensor cores, mma.sync m16n8k16 with f32
//    accumulation, operands fetched with ldmatrix. One block owns 64 or 128
//    q rows of one (batch, head), one warp 16 of them.
//  - S = Q K^T stays in the accumulator registers. The softmax works on
//    those fragments: a row's max and sum live in the four threads of a quad
//    (__shfl_xor_sync 1 and 2). P never touches shared memory: the f32
//    accumulators are rounded to bf16 in registers (pack_bf16, the rounding
//    of from_f<bf16>) and two n8 accumulator tiles are exactly one k16 A
//    fragment of the second product.
//  - K and V tiles of 64 rows are staged in shared memory as bf16 by
//    16-byte cp.async with zero fill for rows past T, in a ring of three
//    stages (two at D = 128): the loads of tiles i+1 and i+2 are in flight
//    while tile i multiplies, with one __syncthreads() per tile.
//  - Rows are padded by 16 bytes (D + 8 elements): the eight 16-byte rows
//    one ldmatrix phase reads then fall into eight different 16-byte bank
//    groups for D = 16, 32, 64 and 128, so no read conflicts. V is the B
//    operand of P V in [kv, D] row-major and is read with ldmatrix.trans.
//  - Q is loaded once (same path), kept as A fragments in registers.
//  - q, k and v each come with their own token and batch strides, so the
//    three column blocks of a fused QKV projection's [B, T, 3C] output are
//    read where they lie, with no copy before the call; the heads of a
//    token stay contiguous. The output is contiguous.
//  - Ragged edges: K/V rows past T are zero-filled and their logits set to
//    -inf after the product (only the last tile can have them, and the first
//    tile always holds a valid key, so a row's max is finite); ragged q rows
//    are computed and not stored.
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
#pragma once

#include <math.h>

#include "common.cuh"

namespace a2k {

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

// How the logits s (already times scale * log2(e)) become P and its row sum.
// Every mode rounds p to bf16 before P V and divides by the sum last.
//   ONLINE  (K2): a running max m; p = exp2(s - m), the accumulators and the
//           sum rescaled when m grows; the sum over the unrounded p.
//   ROW_MAX (K7, v6bd): m = the whole row's max, from a first pass over K
//           that runs only S = Q K^T (no exp2, no V); then p = exp2(s - m)
//           with m fixed, so nothing is rescaled; the sum over the
//           unrounded p.
//   CLAMP   (K8, v7): p = exp2(clamp(s, -100, 100)) with no max, so nothing
//           is rescaled; the sum over the rounded p. Ragged K/V columns get
//           -inf after the clamp (p = 0), not 2^-100.
enum class Softmax { ONLINE, ROW_MAX, CLAMP };

template <int D, int BQ, Softmax MODE>
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
  // ROW_MAX streams K twice: its load sequence is the n_tiles K tiles alone,
  // then the n_tiles K/V tiles; the ring runs across the seam.
  constexpr int PASSES = MODE == Softmax::ROW_MAX ? 2 : 1;

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
  const int n_loads = PASSES * n_tiles;

  // rows [r0, r0 + rows) of one head -> shared memory; rows past Tn are zeros
  auto load_rows = [&](bf16* dst, const bf16* src, size_t tok, int r0, int rows) {
    for (int idx = tid; idx < rows * CPR; idx += THREADS) {
      const int r = idx / CPR, c = (idx % CPR) * 8;
      const bool ok = r0 + r < Tn;
      cp_async16(dst + r * LD + c, src + (size_t)(ok ? r0 + r : 0) * tok + c, ok);
    }
  };
  // load u of the sequence -> ring slot u % STAGES
  auto load_kv = [&](int u) {
    bf16* dst = KVs + (u % STAGES) * L::STAGE_ELEMS;
    if constexpr (MODE == Softmax::ROW_MAX) {
      if (u < n_tiles) {
        load_rows(dst, kb, (size_t)st.k_tok, u * FA_BKV, FA_BKV);
        return;
      }
      u -= n_tiles;
    }
    load_rows(dst, kb, (size_t)st.k_tok, u * FA_BKV, FA_BKV);
    load_rows(dst + FA_BKV * LD, vb, (size_t)st.v_tok, u * FA_BKV, FA_BKV);
  };

  // group 0: Q; groups 1 .. STAGES-1: the first loads (empty groups keep
  // the count uniform when T has fewer tiles)
  load_rows(Qs, qb, (size_t)st.q_tok, q0, BQ);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_loads) load_kv(s);
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
  // rows g and g + 8 of the warp's 16: the max (running in ONLINE), and this
  // thread's share of the sum (the quad's shares are added at the end)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // per-lane offsets of the ldmatrix addresses inside a K and a V tile
  const int k_off = (((lane >> 4) << 3) + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const int v_off = ((((lane >> 3) & 1) << 3) + (lane & 7)) * LD + (lane >> 4) * 8;

  // S = Q K^T of K/V tile `tile`: [16, 64] per warp, f32, in registers, times
  // scale * log2(e) (clamped in CLAMP); columns past Tn -inf
  auto logits = [&](const bf16* Ks, float (&s)[NT][4], int tile) {
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
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale_log2;
        if constexpr (MODE == Softmax::CLAMP) s[j][e] = fminf(fmaxf(s[j][e], -100.f), 100.f);
      }
    if (tile == n_tiles - 1 && (Tn % FA_BKV) != 0) {  // zero-filled rows give logit 0, not -inf
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tile * FA_BKV + j * 8 + 2 * t + (e & 1) >= Tn) s[j][e] = -INFINITY;
    }
  };

  if constexpr (MODE == Softmax::ROW_MAX) {  // pass 1: each row's max over all of T
    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (it + STAGES - 1 < n_loads) load_kv(it + STAGES - 1);
      cp_async_commit();
      float s[NT][4];
      logits(KVs + (it % STAGES) * L::STAGE_ELEMS, s, it);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int u = (PASSES - 1) * n_tiles + it;  // this tile's place in the load sequence
    cp_async_wait<STAGES - 2>();  // load u has landed (for this thread)
    __syncthreads();              // ... for all, and load u-1's slot is free
    if (u + STAGES - 1 < n_loads) load_kv(u + STAGES - 1);
    cp_async_commit();

    const bf16* Ks = KVs + (u % STAGES) * L::STAGE_ELEMS;
    const bf16* Vs = Ks + FA_BKV * LD;

    float s[NT][4];
    logits(Ks, s, it);

    // P, rounded to bf16 as A fragments, and its row sum
    uint32_t pf[NT][2];
    if constexpr (MODE == Softmax::ONLINE) {
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
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (MODE == Softmax::CLAMP) {  // no max; the sum over the rounded p
        pf[j][0] = pack_bf16(fast_exp2(s[j][0]), fast_exp2(s[j][1]));
        pf[j][1] = pack_bf16(fast_exp2(s[j][2]), fast_exp2(s[j][3]));
        // a bf16 is the top half of the f32 it widens to, exactly
        l0 += __uint_as_float(pf[j][0] << 16) + __uint_as_float(pf[j][0] & 0xffff0000u);
        l1 += __uint_as_float(pf[j][1] << 16) + __uint_as_float(pf[j][1] & 0xffff0000u);
      } else {  // p = exp2(s - m), summed unrounded
        const float p0 = fast_exp2(s[j][0] - m0), p1 = fast_exp2(s[j][1] - m0);
        const float p2 = fast_exp2(s[j][2] - m1), p3 = fast_exp2(s[j][3] - m1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pf[j][0] = pack_bf16(p0, p1);
        pf[j][1] = pack_bf16(p2, p3);
      }
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

template <int D, int BQ, Softmax MODE>
static int attn_bf16_launch(const void* q, const void* k, const void* v, void* o,
                            const QkvStrides& st, int B, int Tn, int H, float scale_log2,
                            cudaStream_t stream) {
  auto kern = flash_attn_bf16_kernel<D, BQ, MODE>;
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
template <int D, Softmax MODE>
static int attn_bf16_pick(const void* q, const void* k, const void* v, void* o,
                          const QkvStrides& st, int B, int Tn, int H, float scale_log2,
                          cudaStream_t stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const long blocks128 = (long)((Tn + 127) / 128) * H * B;
  if (blocks128 >= 2L * sms)
    return attn_bf16_launch<D, 128, MODE>(q, k, v, o, st, B, Tn, H, scale_log2, stream);
  return attn_bf16_launch<D, 64, MODE>(q, k, v, o, st, B, Tn, H, scale_log2, stream);
}

}  // namespace a2k
