// Shared pieces of the package's Hopper kernels: dtype helpers, reductions
// and one tiled GEMM core with a prologue hook.
//
// The GEMM core computes out[M, N] = pro(A)[M, K] . W[K, N] + bias[N]
// (+ residual[M, N]) with f32 accumulation. A is never read from memory as
// a matrix: each element comes from the prologue functor, which computes it
// from the real inputs as the tile loads (GroupNorm+SiLU of a shifted conv
// tap, LayerNorm of a row, the GEGLU gate product) and is rounded to the
// weight dtype before the product, as the Pallas kernels round it. The
// intermediate therefore never exists in device memory.
//
// Tiles: 64 x 64 output per block, K in steps of 32, 128 threads (4 warps).
// bf16 runs on the tensor cores through WMMA 16x16x16 fragments (mma.sync
// on sm_90a); f32 runs on FMA units so that its results stay full f32 (no
// TF32). Shared memory stays under the 48 KB static limit, so no dynamic
// shared-memory attribute is needed.
//
// Loads: with GEMM_VEC_A the prologue produces A eight consecutive k at a
// time (one index computation and 16-byte loads per eight elements); with
// GEMM_VEC_B the weight tile loads 16 bytes per thread. The wrapper sets
// them only where K/N are multiples of 8 and the pointers 16-byte aligned.
// Split-K: a small-M product (the UNet's 32 x 2 level gives M = 128 at CFG
// batch 2, i.e. 20 blocks on 132 SMs) runs gridDim.z slices of K, each
// writing an f32 partial tile to a workspace; splitk_reduce sums the slices
// in a fixed order (deterministic) and applies bias and residual. There is
// no cp.async/TMA pipelining or wgmma yet: that is later work.
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
template <typename T, typename Prologue>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_prologue_kernel(Prologue pro, const T* __restrict__ w, const float* __restrict__ bias,
                     const T* __restrict__ residual, T* __restrict__ out,
                     float* __restrict__ ws, int M, int N, int K, int k_split, int vec) {
  __shared__ __align__(128) T As[BM * A_LD];
  __shared__ __align__(128) T Bs[BK * B_LD];
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
        As[r * A_LD + c] = from_f<T>(v);
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
        Bs[r * B_LD + c] = (k < ke && n < N) ? w[(size_t)k * N + n] : from_f<T>(0.f);
      }
    }
  };

  if constexpr (std::is_same<T, float>::value) {
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

  // Epilogue: the f32 partial tile to the split-K workspace, or + bias
  // (+ residual) in f32 with one rounding to the output dtype.
  for (int idx = tid; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      float v = Cs[r * C_LD + c];
      const size_t o = (size_t)m * N + n;
      if (ws != nullptr) {
        ws[(size_t)blockIdx.z * M * N + o] = v;
      } else {
        if (bias != nullptr) v += bias[n];
        if (residual != nullptr) v += to_f(residual[o]);
        out[o] = from_f<T>(v);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, int splits, const float* __restrict__ bias,
                     const T* __restrict__ residual, T* __restrict__ out, int M, int N) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += ws[z * mn + i];
  if (bias != nullptr) v += bias[i % N];
  if (residual != nullptr) v += to_f(residual[i]);
  out[i] = from_f<T>(v);
}

// ws: null, or an f32 workspace of ceil(K / k_split) * M * N for split-K.
template <typename T, typename Prologue>
inline int launch_gemm(const Prologue& pro, const void* w, const void* bias,
                       const void* residual, void* out, float* ws, int M, int N, int K,
                       int k_split, int vec, cudaStream_t stream) {
  if (ws == nullptr || k_split <= 0 || k_split >= K) {
    ws = nullptr;
    k_split = K;
  }
  const int splits = (K + k_split - 1) / k_split;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_prologue_kernel<T, Prologue><<<grid, GEMM_THREADS, 0, stream>>>(
      pro, static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const T*>(residual), static_cast<T*>(out), ws, M, N, K, k_split, vec);
  if (ws != nullptr) {
    const size_t mn = (size_t)M * N;
    splitk_reduce_kernel<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
        ws, splits, static_cast<const float*>(bias), static_cast<const T*>(residual),
        static_cast<T*>(out), M, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace a2k
