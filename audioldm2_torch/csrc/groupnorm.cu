// K6: GroupNorm (+ SiLU) of a channels-last tensor, with no conv after it:
// the UNet's out_norm and the VAE encoder's and decoder's norm_out.
//
// Replaces audioldm2_tpu/ops/groupnorm_pallas.py: group_norm_silu (:51,
// kernel _gn_silu_kernel :24), which holds one batch row in VMEM and loops
// over static channel slices per group because Mosaic cannot reshape the
// lane dim. Here it is one cooperative launch, a2k_group_norm_silu, on a
// grid of one block per SM (ops/_build.py: group_norm_silu_plan), the
// blocks of one sample splitting its rows into contiguous slabs:
//
//   1. each block copies its slab into shared memory (16-byte cp.async) and
//      forms its groups' mean and centred sum of squares M2 by two passes
//      over shared memory: exact, no E[x^2] - mean^2 cancellation at the
//      VAE's S = 65536 rows, and no traffic to device memory;
//   2. the blocks of a sample meet at a barrier (an arrival counter per
//      sample that the last block resets, and a generation word it bumps);
//   3. every block combines the sample's partials in double by Chan's
//      formula in closed form (about the first block's mean, so nothing
//      cancels) in one fixed order, so the result has the same bits in
//      every block and in every run, folds them into the per-channel affine
//      a = rstd * gamma, c = beta - mean * a (gamma and beta read as
//      stored, f32 or bf16), and writes y = silu(x * a + c) (or x * a + c)
//      in f32, rounded once to x's dtype, from shared memory.
//
// Device memory sees x read once and y written once: the bound. A slab that
// does not fit in shared memory ("re-read" mode, for a tensor above about
// 29 MB on 132 SMs: the VAE decode at batch 2 and up) keeps its last
// rows_held rows there: their copy is in flight while the statistics of the
// rows before them are formed from device memory (one pass, shifted by a
// value of each group: see below), and those rows are read once more, for
// the output. More samples than the grid takes at once (a batch above the
// SM count) are taken in turn, block (slot, k) doing part k of samples
// slot, slot + slots, ... Cooperative launch keeps every block resident,
// which the barrier needs; nothing is allocated and the host never waits,
// so the launch can be captured in a CUDA graph.
#include "common.cuh"

namespace a2k {

constexpr int GN_THREADS = 512;
constexpr int GN_MAX_SMEM = 232448;

// Shared memory of one block: the slab (rows_held rows of x, 16-byte
// rounded), the running (n, mean, M2) of each group in double, the
// per-thread channel sums [row lanes][C], the chunk's group means and M2s,
// and the affine (a, c) [2][C].
__host__ __device__ inline size_t gnsilu_smem_bytes(int rows_held, int C, int G, int esize,
                                                    bool vec) {
  const int cp = vec ? C / 8 : C;  // pieces of a row, eight channels each where vec
  const int rp = cp >= GN_THREADS ? 1 : GN_THREADS / cp;
  const size_t slab = ((size_t)rows_held * C * esize + 15) / 16 * 16;
  return slab + (size_t)G * 3 * sizeof(double) + (size_t)rp * C * sizeof(float) +
         (size_t)2 * G * sizeof(float) + (size_t)2 * C * sizeof(float);
}

template <typename T, bool VEC>
__device__ __forceinline__ void gn_load_piece(const T* p, float v[VEC ? 8 : 1]) {
  if constexpr (VEC)
    load8(p, v);
  else
    v[0] = to_f(*p);
}

template <typename T, bool VEC>
__device__ __forceinline__ void gn_store_piece(T* p, const float v[VEC ? 8 : 1]) {
  if constexpr (VEC)
    store8(p, v);
  else
    *p = from_f<T>(v[0]);
}

// A thread's sums over rows rl, rl + RP, ... below cr of its piece of
// channels at src (rows C apart): s = sum (v - m) (pass 0) or sum (v - m)^2
// (pass 1); SQ: s2 = sum (v - m)^2 as well, in the same pass.
template <typename T, bool VEC, bool SQ>
__device__ __forceinline__ void gn_piece_sums(const T* src, int C, int cr, int rl, int RP,
                                              const float (&m)[VEC ? 8 : 1], bool pass,
                                              float (&s)[VEC ? 8 : 1], float (&s2)[VEC ? 8 : 1]) {
  constexpr int PW = VEC ? 8 : 1;
#pragma unroll
  for (int i = 0; i < PW; ++i) {
    s[i] = 0.f;
    if (SQ) s2[i] = 0.f;
  }
#pragma unroll 4
  for (int r = rl; r < cr; r += RP) {
    float v[PW];
    gn_load_piece<T, VEC>(src + (size_t)r * C, v);
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      const float d = v[i] - m[i];
      s[i] = pass ? fmaf(d, d, s[i]) : s[i] + d;
      if (SQ) s2[i] = fmaf(d, d, s2[i]);
    }
  }
}

// Grid: slots x nb blocks, block (slot, k) taking rows [k * rows, min(S,
// (k + 1) * rows)) of samples slot, slot + slots, ... below B, none empty;
// the last rows_held of them stay in shared memory (all: resident). part:
// f32 [B, nb, G, 2] (each block's mean and M2 per group); bar: two unsigned
// per sample (arrivals, left zero; a generation word). VEC: C a multiple of
// 8, x and out 16-byte aligned. RESIDENT: rows_held >= rows (the re-read
// mode's code compiled out).
template <typename T, bool VEC, bool RESIDENT>
__global__ void __launch_bounds__(GN_THREADS, 1)
group_norm_silu_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                       const void* __restrict__ beta, bool p16, T* __restrict__ out, int B, int S,
                       int C, int G, float eps, bool silu, int nb, int rows, int rows_held,
                       float* __restrict__ part, unsigned* __restrict__ bar) {
  extern __shared__ __align__(16) unsigned char gn_smem[];
  constexpr int PW = VEC ? 8 : 1;
  const int tid = threadIdx.x;
  const int k = blockIdx.x % nb, slots = gridDim.x / nb;
  const int cg = C / G, CP = C / PW;
  const bool wide = CP > GN_THREADS;
  const int RP = wide ? 1 : GN_THREADS / CP;  // row lanes
  const int rl = wide ? 0 : tid / CP, j0 = wide ? tid : tid % CP;
  const int r0 = k * rows, nr = min(S, r0 + rows) - r0;
  const int split = RESIDENT ? 0 : nr - min(nr, rows_held);  // rows [split, nr) held
  const size_t slab_bytes = ((size_t)rows_held * C * sizeof(T) + 15) / 16 * 16;
  T* slab = reinterpret_cast<T*>(gn_smem);
  double* run = reinterpret_cast<double*>(gn_smem + slab_bytes);  // [G][3]
  float* psum = reinterpret_cast<float*>(run + 3 * G);            // [RP][C]
  float* gsum = psum + (size_t)RP * C;                             // [2][G]
  float* ac = gsum + 2 * G;                                        // [2][C]

  for (int b = blockIdx.x / nb; b < B; b += slots) {
    const T* xb = x + ((size_t)b * S + r0) * C;
    const T* held = xb + (size_t)split * C;
    __syncthreads();  // the last sample's reads of the slab are done
    if constexpr (VEC) {  // in flight during the statistics of the rows before them
      const int n16 = (nr - split) * C * (int)sizeof(T) / 16;
      for (int i = tid; i < n16; i += GN_THREADS)
        cp_async16(reinterpret_cast<uint4*>(slab) + i, reinterpret_cast<const uint4*>(held) + i,
                   true);
      cp_async_commit();
    }
    // the rows before the held ones (re-read mode) from device memory, then
    // the held ones from the slab. The slab's: two passes, the group sums,
    // then the squares centred on the group means. Device memory's: one pass
    // (a thread has one piece of channels where rows are not wide), its sums
    // and sums of squares shifted by each group's value in the block's first
    // row, so they cancel only as far as that value lies from the mean; two
    // passes where rows are wide. Per-thread channel sums, then each
    // channel's over the row lanes, then each group's, in a fixed order.
    for (int in_slab = split > 0 ? 0 : 1; in_slab < 2; ++in_slab) {
      const int cr = in_slab ? nr - split : split;
      const T* src = in_slab ? slab : xb;
      const bool shifted = !RESIDENT && !in_slab && !wide;
      if (in_slab) {
        if constexpr (VEC)
          cp_async_wait<0>();
        else
          for (int i = tid; i < cr * C; i += GN_THREADS) slab[i] = held[i];
        __syncthreads();
      } else if (shifted) {
        for (int g = tid; g < G; g += GN_THREADS) gsum[G + g] = to_f(xb[(size_t)g * cg]);
        __syncthreads();
      }
      float s2[PW];  // shifted: the squares, held while the sums are reduced
      for (int pass = 0; pass < 2; ++pass) {
        if (shifted && pass == 1) {
          if (rl < RP) {
#pragma unroll
            for (int i = 0; i < PW; ++i) psum[rl * C + j0 * PW + i] = s2[i];
          }
        } else {
          for (int j = j0; rl < RP && j < CP; j += GN_THREADS) {
            float s[PW], m[PW];
            int g = j * PW / cg, rem = j * PW - g * cg;  // the group of channel j * PW
#pragma unroll
            for (int i = 0; i < PW; ++i) {
              m[i] = shifted ? gsum[G + g] : pass ? gsum[g] : 0.f;
              if (++rem == cg) {
                rem = 0;
                ++g;
              }
            }
            if (shifted)
              gn_piece_sums<T, VEC, true>(src + j * PW, C, cr, rl, RP, m, false, s, s2);
            else
              gn_piece_sums<T, VEC, false>(src + j * PW, C, cr, rl, RP, m, pass, s, s2);
#pragma unroll
            for (int i = 0; i < PW; ++i) psum[rl * C + j * PW + i] = s[i];
          }
        }
        __syncthreads();
        for (int ch = tid; ch < C; ch += GN_THREADS) {  // column ch is this thread's alone
          float s = 0.f;
          for (int r = 0; r < RP; ++r) s += psum[r * C + ch];
          psum[ch] = s;
        }
        __syncthreads();
        for (int g = tid; g < G; g += GN_THREADS) {
          float s = 0.f;
          for (int c = 0; c < cg; ++c) s += psum[g * cg + c];
          gsum[pass * G + g] = pass || shifted ? s : s / (float)(cr * cg);
        }
        __syncthreads();
      }
      for (int g = tid; g < G; g += GN_THREADS) {
        double n = cr * cg, mean = gsum[g], m2 = gsum[G + g];  // the first part as it is
        if (shifted) {  // from the shifted sums, about the same value as in the pass
          const double d = mean / n;
          m2 -= mean * d;
          mean = (double)to_f(xb[(size_t)g * cg]) + d;
        }
        if (in_slab && split > 0) {
          n = run[3 * g];
          mean = run[3 * g + 1];
          m2 = run[3 * g + 2];
          chan_combine(n, mean, m2, (double)cr * cg, (double)gsum[g], (double)gsum[G + g]);
        }
        run[3 * g] = n;
        run[3 * g + 1] = mean;
        run[3 * g + 2] = m2;
      }
    }
    __syncthreads();
    for (int g = tid; g < G; g += GN_THREADS) {
      float* pp = part + (((size_t)b * nb + k) * G + g) * 2;
      pp[0] = (float)run[3 * g + 1];
      pp[1] = (float)run[3 * g + 2];
    }

    // The sample's barrier. One release by thread 0 covers the block's writes
    // (the barrier orders them before it, and PTX fences are cumulative); the
    // generation is read before arriving, so a waiter never misses the bump;
    // a waiter's acquiring load, and the last block's fence, order the reads
    // of the other blocks' partials after their writes.
    __syncthreads();
    if (tid == 0) {
      unsigned* arrive = bar + 2 * b;
      unsigned* gen = bar + 2 * b + 1;
      auto acquire = [&]() {
        unsigned v;
        asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(gen) : "memory");
        return v;
      };
      const unsigned g0 = acquire();
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
      if (atomicAdd(arrive, 1u) == (unsigned)(nb - 1)) {
        atomicExch(arrive, 0u);
        asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
        atomicAdd(gen, 1u);
      } else {
        while (acquire() == g0) __nanosleep(32);
      }
    }
    __syncthreads();

    // The sample's nb partials (n_q, m_q, M2_q) combined in double by Chan's
    // formula in closed form, about block 0's mean K (near the sample's mean,
    // so nothing cancels): with d_q = m_q - K, mean = K + sum n_q d_q / n and
    // M2 = sum (M2_q + n_q d_q^2) - (sum n_q d_q)^2 / n. `lanes` lanes per
    // group, lane l taking blocks l, l + lanes, ... in order, the lanes summed
    // by a butterfly (each lane ends with the same bits), so every block gets
    // the same result; one pass over the partials, no division a partial.
    float* gmean = gsum;
    float* grstd = gsum + G;
    int lanes = 1;
    while (lanes < 32 && 2 * lanes * G <= GN_THREADS) lanes *= 2;
    auto lane_sum = [&](double v) {  // within aligned groups of `lanes` lanes
      for (int o = lanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      return v;
    };
    for (int g0 = 0; g0 < G; g0 += GN_THREADS / lanes) {
      const int g = g0 + tid / lanes, l = tid % lanes;
      const float2* pg = reinterpret_cast<const float2*>(part) + (size_t)b * nb * G + min(g, G - 1);
      const double K = (double)__ldcg(pg).x;
      double n = 0.0, s1 = 0.0, s2 = 0.0;
      if (g < G) {
#pragma unroll 4
        for (int q = l; q < nb; q += lanes) {
          const double nq = (double)(min(S, (q + 1) * rows) - q * rows) * cg;
          const float2 pm = __ldcg(pg + (size_t)q * G);
          const double d = (double)pm.x - K;
          n += nq;
          s1 += nq * d;
          s2 += (double)pm.y + nq * d * d;
        }
      }
      n = lane_sum(n);
      s1 = lane_sum(s1);
      s2 = lane_sum(s2);
      if (g < G && l == 0) {
        gmean[g] = (float)(K + s1 / n);
        grstd[g] = rsqrtf((float)((s2 - s1 * s1 / n) / n) + eps);
      }
    }
    __syncthreads();
    for (int ch = tid; ch < C; ch += GN_THREADS) {
      const int g = ch / cg;
      const float gm = p16 ? to_f(static_cast<const bf16*>(gamma)[ch])
                           : static_cast<const float*>(gamma)[ch];
      const float bt = p16 ? to_f(static_cast<const bf16*>(beta)[ch])
                           : static_cast<const float*>(beta)[ch];
      const float av = grstd[g] * gm;  // rstd * gamma
      ac[ch] = av;
      ac[C + ch] = bt - gmean[g] * av;
    }
    __syncthreads();

    // y = silu(x * a + c) in f32, one rounding: the thread's channels' a and c
    // in registers, x from the slab or, before the held rows, again from
    // device memory
    T* ob = out + ((size_t)b * S + r0) * C;
    for (int j = j0; rl < RP && j < CP; j += GN_THREADS) {
      float av[PW], cv[PW];
#pragma unroll
      for (int i = 0; i < PW; ++i) {
        av[i] = ac[j * PW + i];
        cv[i] = ac[C + j * PW + i];
      }
      auto apply = [&](const T* xs, T* os) {
        float v[PW];
        gn_load_piece<T, VEC>(xs + j * PW, v);
#pragma unroll
        for (int i = 0; i < PW; ++i) {
          const float y = fmaf(v[i], av[i], cv[i]);
          v[i] = silu ? __fdividef(y, 1.f + expf(-y)) : y;
        }
        gn_store_piece<T, VEC>(os + j * PW, v);
      };
      int r = rl;
#pragma unroll 4
      for (; r < split; r += RP) apply(xb + (size_t)r * C, ob + (size_t)r * C);
#pragma unroll 4
      for (; r < nr; r += RP) apply(slab + (size_t)(r - split) * C, ob + (size_t)r * C);
    }
  }  // samples
}

template <typename T, bool VEC, bool RESIDENT>
static int gnsilu_launch_as(const void* x, const void* gamma, const void* beta, bool p16,
                            void* out, int B, int S, int C, int G, float eps, bool silu, int slots,
                            int nb, int rows, int rows_held, void* part, void* bar,
                            cudaStream_t stream) {
  auto kern = group_norm_silu_kernel<T, VEC, RESIDENT>;
  static bool configured = false;  // per instantiation: above 48 KB needs the attribute
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GN_MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const size_t smem = gnsilu_smem_bytes(rows_held, C, G, (int)sizeof(T), VEC);
  if (smem > (size_t)GN_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const T* px = static_cast<const T*>(x);
  T* po = static_cast<T*>(out);
  float* pp = static_cast<float*>(part);
  unsigned* pb = static_cast<unsigned*>(bar);
  void* args[] = {(void*)&px,  (void*)&gamma, (void*)&beta, (void*)&p16,  (void*)&po,
                  (void*)&B,   (void*)&S,     (void*)&C,    (void*)&G,    (void*)&eps,
                  (void*)&silu, (void*)&nb,   (void*)&rows, (void*)&rows_held, (void*)&pp,
                  (void*)&pb};
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                                dim3(slots * nb), dim3(GN_THREADS), args, smem,
                                                stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
static int gnsilu_launch(const void* x, const void* gamma, const void* beta, bool p16, void* out,
                         int B, int S, int C, int G, float eps, bool silu, int slots, int nb,
                         int rows, int rows_held, void* part, void* bar, cudaStream_t stream) {
  return rows_held >= rows
             ? gnsilu_launch_as<T, VEC, true>(x, gamma, beta, p16, out, B, S, C, G, eps, silu,
                                              slots, nb, rows, rows_held, part, bar, stream)
             : gnsilu_launch_as<T, VEC, false>(x, gamma, beta, p16, out, B, S, C, G, eps, silu,
                                               slots, nb, rows, rows_held, part, bar, stream);
}

// The re-read instantiation: at least the resident one's registers.
template <typename T, bool VEC>
static int gnsilu_occupancy(int smem, int* blocks) {
  auto kern = group_norm_silu_kernel<T, VEC, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GN_MAX_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, GN_THREADS, smem);
  return (int)err;
}

}  // namespace a2k

extern "C" {

// x, out: [B, S, C] in the dtype's type; gamma, beta: [C], f32
// (param_dtype 0) or bf16 (1), read as stored; slots x nb blocks, nb per
// sample of `rows` rows each (none empty), `slots` samples at a time
// (samples slot, slot + slots, ... in turn); the last rows_held rows of a
// block's in shared memory (>= rows: resident); part: f32 [B, nb, G, 2]
// scratch; bar: 2B unsigned, zero at first use, as every launch leaves the
// arrivals; vec: 1 for eight channels a thread (C % 8 == 0, x and out
// 16-byte aligned).
int a2k_group_norm_silu(const void* x, const void* gamma, const void* beta, int param_dtype,
                        void* out, int B, int S, int C, int G, float eps, int silu, int slots,
                        int nb, int rows, int rows_held, int vec, void* part, void* bar,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || C <= 0 || G <= 0 || C % G || slots < 1 || slots > B || nb < 1 ||
      rows < 1 || rows_held < 1 || (nb - 1) * rows >= S || (long long)nb * rows < S ||
      (param_dtype != 0 && param_dtype != 1) ||
      (vec && ((C & 7) || ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
                           15))))
    return (int)cudaErrorInvalidValue;
  const bool p16 = param_dtype == 1, act = silu != 0;
  if (dtype == 1)
    return vec ? a2k::gnsilu_launch<a2k::bf16, true>(x, gamma, beta, p16, out, B, S, C, G, eps,
                                                     act, slots, nb, rows, rows_held, part, bar,
                                                     s)
               : a2k::gnsilu_launch<a2k::bf16, false>(x, gamma, beta, p16, out, B, S, C, G, eps,
                                                      act, slots, nb, rows, rows_held, part, bar,
                                                      s);
  return vec ? a2k::gnsilu_launch<float, true>(x, gamma, beta, p16, out, B, S, C, G, eps, act,
                                               slots, nb, rows, rows_held, part, bar, s)
             : a2k::gnsilu_launch<float, false>(x, gamma, beta, p16, out, B, S, C, G, eps, act,
                                                slots, nb, rows, rows_held, part, bar, s);
}

// Blocks of a2k_group_norm_silu one SM holds at once with `smem` bytes of
// dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int a2k_group_norm_silu_occupancy(int dtype, int vec, int smem, int* blocks) {
  if (dtype == 1)
    return vec ? a2k::gnsilu_occupancy<a2k::bf16, true>(smem, blocks)
               : a2k::gnsilu_occupancy<a2k::bf16, false>(smem, blocks);
  return vec ? a2k::gnsilu_occupancy<float, true>(smem, blocks)
             : a2k::gnsilu_occupancy<float, false>(smem, blocks);
}

}  // extern "C"
