// Shared pieces of the package's Hopper kernels: dtype helpers, reductions
// and one tiled GEMM core with a prologue hook.
//
// The GEMM core computes out[M, N] = pro(A)[M, K] . W[K, N] * wscale[N] +
// bias[N] (+ residual[M, N]) with f32 accumulation. A is never read from
// memory as a matrix: each element comes from the prologue functor, which
// computes it from the real inputs as the tile loads (GroupNorm+SiLU of a
// shifted conv tap, LayerNorm of a row, the GEGLU gate product, or the
// input itself) and is rounded to the tile type TC before the product, as
// the Pallas kernels round it. The intermediate therefore never exists in
// device memory.
//
// Three types: TC, the type of the A and B tiles in shared memory and of
// the product (bf16 on the tensor cores, or f32 on the FMA units); TW, the
// weight's type in device memory (TC, or int8, converted to TC as the B
// tile is stored, which is exact since |q| <= 127); TIO, the type of the
// residual and the output (the activation's type). The int8 weights carry
// a per-column f32 scale, applied to the f32 accumulator before the bias
// and the residual: the scale is per output column, so this equals the
// product with the dequantized weight, and split-K partial sums are
// linear, so the split-K reduction applies it after the sum.
//
// Tiles: 64 x 64 output per block, K in steps of 32, 128 threads (4 warps).
// bf16 runs on the tensor cores through WMMA 16x16x16 fragments (mma.sync
// on sm_90a); f32 runs on FMA units so that its results stay full f32 (no
// TF32). Shared memory stays under the 48 KB static limit, so no dynamic
// shared-memory attribute is needed.
//
// Loads: with GEMM_VEC_A the prologue produces A eight consecutive k at a
// time (one index computation and 16-byte loads per eight elements); with
// GEMM_VEC_B the weight tile loads eight consecutive n per thread (16 bytes
// of bf16, 32 of f32, 8 of int8). The wrapper sets them only where K/N are
// multiples of 8 and the pointers aligned to those loads.
// Split-K: a small-M product (the UNet's 32 x 2 level gives M = 128 at CFG
// batch 2, i.e. 20 blocks on 132 SMs) runs gridDim.z slices of K, each
// writing an f32 partial tile to a workspace; splitk_reduce sums the slices
// in a fixed order (deterministic) and applies bias and residual.
//
// The core serves K1q, K3q, K4q and K5 in f32, K3 and K4 in f32, and K1 at
// shapes its own kernels do not take. The kernels redesigned around
// Hopper's asynchronous copies, the bf16 K2 (attention.cu), K3 and K4
// (lnmm.cu) and K1 in bf16 and f32 (gn_silu_conv.cu), do not use it; they share the PTX
// helpers below (16-byte cp.async with zero fill, ldmatrix, mma.sync
// m16n8k16 with f32 accumulation, the quad transpose of the epilogues).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace a2k {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// Eight consecutive elements, 16-byte aligned, to f32 / from f32.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
// Eight consecutive int8, 8-byte aligned, to f32 (exact).
__device__ __forceinline__ void load8(const int8_t* p, float v[8]) {
  const int2 raw = *reinterpret_cast<const int2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = (float)b[i];
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// ---------------------------------------------------------------------------
// PTX helpers of the pipelined bf16 kernels.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row): a0 = (row g, k 2t..2t+1), a1 = (row g+8, same k),
//                     a2 = (row g, k 2t+8..), a3 = (row g+8, k 2t+8..)
//   B (16 x 8, col):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C (16 x 8, f32):  c0, c1 = (row g, n 2t, 2t+1), c2, c3 = (row g+8, same n)
// ldmatrix.x4 loads four 8 x 8 b16 matrices; lane i gives the address of
// row i % 8 of matrix i / 8, and register j of lane (g, t) receives
// elements (g, 2t..2t+1) of matrix j, or with .trans (2t..2t+1, g).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !pred (src is not
// read then but must be a valid address). Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// The same for a run-time n; waiting for fewer than asked is always safe.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a . b for one 16 x 8 x 16 bf16 product, f32 accumulation.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one register of two bf16 (lo in the low half), round to nearest
// even: the rounding of from_f<bf16>.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Eight bf16 in one 16-byte register group, as f32.
__device__ __forceinline__ void unpack8(const uint4& raw, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
// Sixteen int8 (one 16-byte register group) to sixteen bf16 (two), exactly
// (|q| <= 128 is a bf16 value): each byte, offset to unsigned, becomes the
// low mantissa byte of the f32 2^23, the offset is subtracted in f32, and
// the upper half of the exact f32 is the bf16. No conversion instruction.
__device__ __forceinline__ void int8x16_to_bf16(const uint4& q, uint4& lo, uint4& hi) {
  const uint32_t in[4] = {q.x, q.y, q.z, q.w};
  uint32_t o[8];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t u = in[w] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) - 8388736.f;
    o[2 * w] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    o[2 * w + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// Eight consecutive LN or bias parameters from index idx (a multiple of 8),
// stored as f32 or, with p16, as bf16 (exact in f32 either way).
__device__ __forceinline__ void load8_param(const void* p, int idx, bool p16, float v[8]) {
  if (p16)
    load8(static_cast<const bf16*>(p) + idx, v);
  else
    load8(static_cast<const float*>(p) + idx, v);
}

// 4 x 4 transpose inside a quad: thread t of the quad gives v[j] (its pair of
// columns 2t, 2t+1 of n8 tile j) and ends with v[k] = thread k's pair of tile
// t, i.e. the 8 contiguous columns of tile t. Two butterfly steps.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool odd = t & 1;
  uint32_t s0 = odd ? v[0] : v[1], s1 = odd ? v[2] : v[3];
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 1), r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (odd) {
    v[0] = r0;
    v[2] = r1;
  } else {
    v[1] = r0;
    v[3] = r1;
  }
  const bool hi = t & 2;
  s0 = hi ? v[0] : v[2];
  s1 = hi ? v[1] : v[3];
  r0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (hi) {
    v[0] = r0;
    v[1] = r1;
  } else {
    v[2] = r0;
    v[3] = r1;
  }
}

// The current device's SM count into *sms, read once per process. Returns
// the CUDA error of a query that failed (and reads again at the next call).
inline int sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, n = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return (int)cudaErrorInvalidDevice;
    cached = n;
  }
  *sms = cached;
  return (int)cudaSuccess;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the whole block; every thread gets the result. `scratch` holds
// one value per warp. Ends with a barrier so scratch can be reused.
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  V total = 0;
  for (int i = 0; i < nwarps; ++i) total += scratch[i];
  __syncthreads();
  return total;
}

// (n, mean, m2) of one part combined with (nb, mb, m2b) of another, by
// Chan's formula; a part with nb = 0 leaves it as it is. The GroupNorm
// statistics of K1, K1q and K6 combine their partial sums with it.
__device__ __forceinline__ void chan_combine(double& n, double& mean, double& m2, double nb,
                                             double mb, double m2b) {
  if (nb == 0.0) return;
  const double tot = n + nb, w = nb / tot, d = mb - mean;
  mean += d * w;
  m2 += m2b + d * d * n * w;
  n = tot;
}

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int GEMM_THREADS = 128;
constexpr int A_LD = BK + 8;  // +8 elements: rows stay 16-byte aligned, fewer bank conflicts
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

constexpr int GEMM_VEC_A = 1;
constexpr int GEMM_VEC_B = 2;

// Prologue interface:
//   __device__ void block_init(int m0, int M, float* sm) const;     // per-block setup
//   __device__ float operator()(int m, int k, const float* sm) const;  // one element
//   __device__ void eight(int m, int k, const float* sm, float v[8]) const;
//       // elements k..k+7 of row m; called only under GEMM_VEC_A
// `sm` is 2 * BM floats of shared memory owned by the prologue.
template <typename TC, typename TW, typename TIO, typename Prologue>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_prologue_kernel(Prologue pro, const TW* __restrict__ w, const float* __restrict__ wscale,
                     const float* __restrict__ bias, const TIO* __restrict__ residual,
                     TIO* __restrict__ out, float* __restrict__ ws, int M, int N, int K,
                     int k_split, int vec) {
  __shared__ __align__(128) TC As[BM * A_LD];
  __shared__ __align__(128) TC Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];
  __shared__ float pro_sm[2 * BM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);

  pro.block_init(m0, M, pro_sm);
  __syncthreads();

  auto load_tiles = [&](int k0) {
    if (vec & GEMM_VEC_A) {
      // 64 rows x 4 chunks of 8 k: two chunks per thread
      for (int idx = tid; idx < BM * (BK / 8); idx += GEMM_THREADS) {
        const int r = idx >> 2, k = k0 + (idx & 3) * 8;
        const int m = m0 + r;
        float v[8];
        if (m < M && k < ke) {
          pro.eight(m, k, pro_sm, v);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = 0.f;
        }
        store8(As + r * A_LD + (idx & 3) * 8, v);
      }
    } else {
      for (int idx = tid; idx < BM * BK; idx += GEMM_THREADS) {
        const int r = idx / BK, c = idx % BK;
        const int m = m0 + r, k = k0 + c;
        const float v = (m < M && k < ke) ? pro(m, k, pro_sm) : 0.f;
        As[r * A_LD + c] = from_f<TC>(v);
      }
    }
    if (vec & GEMM_VEC_B) {
      // 32 rows x 8 chunks of 8 n: two chunks per thread
      for (int idx = tid; idx < BK * (BN / 8); idx += GEMM_THREADS) {
        const int r = idx >> 3, c = (idx & 7) * 8;
        const int k = k0 + r, n = n0 + c;
        float v[8];
        if (k < ke && n < N) {
          load8(w + (size_t)k * N + n, v);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = 0.f;
        }
        store8(Bs + r * B_LD + c, v);
      }
    } else {
      for (int idx = tid; idx < BK * BN; idx += GEMM_THREADS) {
        const int r = idx / BN, c = idx % BN;
        const int k = k0 + r, n = n0 + c;
        Bs[r * B_LD + c] = from_f<TC>((k < ke && n < N) ? to_f(w[(size_t)k * N + n]) : 0.f);
      }
    }
  };

  if constexpr (std::is_same<TC, float>::value) {
    // f32: 8 x 4 outputs per thread on the FMA units.
    const int tx = tid % 16, ty = tid / 16;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = kb; k0 < ke; k0 += BK) {
      load_tiles(k0);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[(ty * 8 + i) * A_LD + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk * B_LD + tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty * 8 + i) * C_LD + tx * 4 + j] = acc[i][j];
  } else {
    // bf16: each warp owns a 32 x 32 quarter of the tile as 2 x 2 fragments.
    using namespace nvcuda;
    const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = kb; k0 < ke; k0 += BK) {
      load_tiles(k0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bfr[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
                                C_LD, wmma::mem_row_major);
  }
  __syncthreads();

  // Epilogue: the f32 partial tile to the split-K workspace, or * wscale
  // + bias (+ residual) in f32 with one rounding to the output dtype.
  for (int idx = tid; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      float v = Cs[r * C_LD + c];
      const size_t o = (size_t)m * N + n;
      if (ws != nullptr) {
        ws[(size_t)blockIdx.z * M * N + o] = v;
      } else {
        if (wscale != nullptr) v *= wscale[n];
        if (bias != nullptr) v += bias[n];
        if (residual != nullptr) v += to_f(residual[o]);
        out[o] = from_f<TIO>(v);
      }
    }
  }
}

template <typename TIO>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, int splits,
                     const float* __restrict__ wscale, const float* __restrict__ bias,
                     const TIO* __restrict__ residual, TIO* __restrict__ out, int M, int N) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += ws[z * mn + i];
  if (wscale != nullptr) v *= wscale[i % N];
  if (bias != nullptr) v += bias[i % N];
  if (residual != nullptr) v += to_f(residual[i]);
  out[i] = from_f<TIO>(v);
}

// wscale: null, or the int8 weight's f32 [N] scale.
// ws: null, or an f32 workspace of ceil(K / k_split) * M * N for split-K.
template <typename TC, typename TW, typename TIO, typename Prologue>
inline int launch_gemm(const Prologue& pro, const void* w, const void* wscale, const void* bias,
                       const void* residual, void* out, float* ws, int M, int N, int K,
                       int k_split, int vec, cudaStream_t stream) {
  if (ws == nullptr || k_split <= 0 || k_split >= K) {
    ws = nullptr;
    k_split = K;
  }
  const int splits = (K + k_split - 1) / k_split;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_prologue_kernel<TC, TW, TIO, Prologue><<<grid, GEMM_THREADS, 0, stream>>>(
      pro, static_cast<const TW*>(w), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<const TIO*>(residual),
      static_cast<TIO*>(out), ws, M, N, K, k_split, vec);
  if (ws != nullptr) {
    const size_t mn = (size_t)M * N;
    splitk_reduce_kernel<TIO><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
        ws, splits, static_cast<const float*>(wscale), static_cast<const float*>(bias),
        static_cast<const TIO*>(residual), static_cast<TIO*>(out), M, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace a2k
