// RG-LRU diagonal linear recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py:35
// _rglru_kernel (called through :53 rglru_scan) and computes what its
// oracle src/repro/kernels/ref.py:40 rglru_scan_ref computes: for every
// (batch, channel), h_t = a_t * h_{t-1} + b_t from h = 0, in float32,
// over the whole time axis.  a, b are (B, T, R), float32 or bfloat16,
// contiguous; h is written as (B, T, R) in float32 or bfloat16.  Any T
// and R (the Pallas kernel asks T and R to divide its blocks).
//
// Bound: the scan reads a and b once and writes h once.  At the serving
// path's shape (B = 1, T = 3072, R = 4096, float32 in, bfloat16 out) that
// is 125.8 MB, about 38 us at 3.35 TB/s; one multiply-add per element is
// nothing beside it, so it is bound by bytes.  The catch is the
// dependence along T: one thread per channel walking all of T gives only
// B * R = 4096 threads, 32 blocks of 128 on 132 SMs, each waiting out
// 3072 dependent steps.  Design: a chunked scan in one launch.  A block
// owns 32 neighbouring channels of one batch row and cuts T into 16
// chunks, one warp per chunk (512 threads), so a warp's loads at one t
// are 32 neighbouring channels.  Pass 1: each thread scans its chunk from
// h = 0, keeping the chunk's product of a and its local end value, in
// shared memory.  Then one warp chains the 16 chunks' carries,
// carry_k = A_{k-1} * carry_{k-1} + H_{k-1}, the combine of
// src/repro/models/rglru.py:86.  Pass 2: each thread re-walks its chunk
// from its true carry and writes h.  The first chunk walks exactly the
// oracle's recurrence; later chunks differ from it only by the
// reassociated carry (float32 rounding).  a and b are read twice, the
// second time mostly from L2; blocks never talk to each other.  FMA
// contraction is allowed (float32 with a tolerance).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (repro_torch/_build.py)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 32;  // channels per block (one warp's width)
constexpr int kChunks = 16;    // time chunks per block (one warp each)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kChannels * kChunks) rglru_scan_kernel(
    const Tin* __restrict__ a, const Tin* __restrict__ b,
    Tout* __restrict__ h, int64_t T, int64_t R) {
  __shared__ float s_prod[kChunks][kChannels];
  __shared__ float s_end[kChunks][kChannels];
  __shared__ float s_carry[kChunks][kChannels];
  const int c = threadIdx.x;
  const int k = threadIdx.y;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kChannels + c;
  const bool live = r < R;
  const int64_t len = (T + kChunks - 1) / kChunks;
  const int64_t t0 = k * len < T ? k * len : T;
  const int64_t t1 = t0 + len < T ? t0 + len : T;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * T * R + r;

  float prod = 1.f, end = 0.f;
  if (live) {
#pragma unroll 8
    for (int64_t t = t0; t < t1; ++t) {
      const float a_t = to_f32(a[base + t * R]);
      end = a_t * end + to_f32(b[base + t * R]);
      prod *= a_t;
    }
  }
  s_prod[k][c] = prod;
  s_end[k][c] = end;
  __syncthreads();
  if (k == 0) {
    float carry = 0.f;
    for (int j = 0; j < kChunks; ++j) {
      s_carry[j][c] = carry;
      carry = s_prod[j][c] * carry + s_end[j][c];
    }
  }
  __syncthreads();
  if (!live) return;
  float state = s_carry[k][c];
#pragma unroll 8
  for (int64_t t = t0; t < t1; ++t) {
    state = to_f32(a[base + t * R]) * state + to_f32(b[base + t * R]);
    store(&h[base + t * R], state);
  }
}

template <typename Tin, typename Tout>
int launch(const void* a, const void* b, void* h, int64_t B, int64_t T,
           int64_t R, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((R + kChannels - 1) / kChannels),
                  static_cast<unsigned>(B));
  const dim3 block(kChannels, kChunks);
  rglru_scan_kernel<Tin, Tout><<<grid, block, 0, stream>>>(
      static_cast<const Tin*>(a), static_cast<const Tin*>(b),
      static_cast<Tout*>(h), T, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  Launches on `stream`; returns
// cudaGetLastError() of the launch (or cudaErrorInvalidValue for a
// shape the grid cannot hold).
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h,
                                 int64_t B, int64_t T, int64_t R,
                                 int in_dtype, int out_dtype, void* stream) {
  if (B == 0 || T == 0 || R == 0) return 0;
  if (B > 65535 || (R + kChannels - 1) / kChannels > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(a, b, h, B, T, R, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(a, b, h, B, T, R, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(a, b, h, B, T, R, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, b, h, B, T, R, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
