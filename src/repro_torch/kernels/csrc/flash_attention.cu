// Flash attention (online softmax, causal and/or sliding window, GQA),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:39
// _flash_kernel (called through :104 flash_attention) and computes what
// its oracle src/repro/kernels/ref.py:13 attention_ref computes:
// q (B, Hq, T, hd), k and v (B, Hkv, S, hd) -> o (B, Hq, T, hd) in q's
// dtype, query head h reading kv head h / (Hq / Hkv).  Logits are
// sm_scale * q.k in float32; key j is visible to query i when j < S,
// j <= i (causal) and j > i - window (window > 0), on global indices;
// hidden logits are -2^30, not -inf, as the Pallas kernel has them; the
// running max m, sum l and accumulator stay float32, and o = acc /
// max(l, 1e-30).  Inputs float32 or bfloat16, contiguous; hd <= 256 and
// any T and S (the Pallas kernel asks them to divide its blocks).  A
// query that sees no key at all (a window that ends before the first
// key; never under a causal mask with S >= T) gives 0.
//
// Bound: at the serving path's shape (B = 1, Hq = 16, Hkv = 1,
// T = S = 3072, hd = 256, window 2048, bfloat16) the visible (i, j)
// pairs are 16 * 4,195,328 and each costs 4 * hd operations (q.k and
// p.v): 68.7 GFLOP, 0.069 ms at 989 TFLOP/s of dense bf16 tensor-core
// work, against 53.5 MB of q, k, v and o (0.016 ms at 3.35 TB/s): bound
// by operations.  Design (a simple kernel that is right; wgmma, TMA and
// bf16 tiles are later work): no tensor cores, float32 FMAs on the CUDA
// cores, so it runs far above that bound.  One block of 256 threads per
// (batch, query head, block of 32 queries) walks the key blocks of 64
// that its queries can see, skipping the blocks that the causal and
// window masks empty, as the Pallas kernel does (a third of them at the
// serving shape).  Shared memory holds the query tile, one key and one
// value tile as float32 (hd padded to HD = 64, 128 or 256 with zeros;
// 170.5 KB at HD = 256), and the tile's softmax weights.  Each warp owns
// 4 query rows: its lanes take 2 keys each for the logits (float4 reads
// along hd; rows padded by 4 floats, so the reads are free of bank
// conflicts), reduce the row max and sum with shuffles, and then own
// HD / 32 output columns of those rows for p.v, accumulating in
// registers.  Warps never wait for each other inside a tile; the block
// syncs only around the key/value loads.  MQA costs nothing extra: the
// 16 query heads' blocks read the one kv head, mostly from L2.  Built
// without --use_fast_math (expf stays IEEE-accurate).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (repro_torch/_build.py)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;                 // queries per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kRows = kBQ / kWarps;     // query rows per warp (4)
constexpr float kNegInf = -1073741824.f;  // -2^30, the Pallas kernel's
constexpr int kPad = 4;                 // floats of row padding

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
constexpr int64_t smem_bytes() {
  return 4 * (kBQ * (HD + kPad)      // q tile
              + kBK * (HD + kPad)    // k tile
              + kBK * HD             // v tile
              + kBK * (kBQ + kPad)); // softmax weights, transposed
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
    int64_t Tq, int64_t S, int hd, float sm_scale, int causal,
    int64_t window) {
  constexpr int QS = HD + kPad;        // q / k row stride (floats)
  constexpr int PS = kBQ + kPad;       // weight row stride
  constexpr int NC = HD / 32;          // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * QS;
  float* sP = sV + kBK * HD;           // [key][query row]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * Hq + h;
  const int64_t bhk = static_cast<int64_t>(blockIdx.z) * Hkv
                      + h / (Hq / Hkv);
  const T* qp = q + bh * Tq * hd;
  const T* kp = k + bhk * S * hd;
  const T* vp = v + bhk * S * hd;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    sQ[r * QS + d] = (q0 + r < Tq && d < hd)
                         ? to_f32(qp[(q0 + r) * hd + d]) : 0.f;
  }

  // Keys any of this block's queries can see: [k_lo, k_hi].
  const int64_t q_last = (q0 + kBQ < Tq ? q0 + kBQ : Tq) - 1;
  int64_t k_hi = S - 1;
  if (causal && q_last < k_hi) k_hi = q_last;
  int64_t k_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int row0 = warp * kRows;

  for (int64_t kt = (k_lo / kBK) * kBK; kt <= k_hi; kt += kBK) {
    __syncthreads();  // the previous tile's k, v and weights are read
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      const bool in = kt + j < S && d < hd;
      sK[j * QS + d] = in ? to_f32(kp[(kt + j) * hd + d]) : 0.f;
      sV[j * HD + d] = in ? to_f32(vp[(kt + j) * hd + d]) : 0.f;
    }
    __syncthreads();

    // Logits of rows row0..row0+3 against keys lane and lane + 32.
    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k0 = sK + lane * QS;
    const float* k1 = sK + (lane + 32) * QS;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(k0 + d);
      const float4 a1 = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(sQ + (row0 + i) * QS + d);
        s[i][0] += x.x * a0.x + x.y * a0.y + x.z * a0.z + x.w * a0.w;
        s[i][1] += x.x * a1.x + x.y * a1.y + x.z * a1.z + x.w * a1.w;
      }
    }

    // Online softmax, one row at a time; the warp holds the row's 64
    // logits two per lane.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t qi = q0 + row0 + i;
      float x[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int64_t kj = kt + lane + 32 * c;
        bool ok = kj < S;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        x[c] = ok ? s[i][c] * sm_scale : kNegInf;
      }
      float mx = fmaxf(x[0], x[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p0 = expf(x[0] - m_new);
      const float p1 = expf(x[1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
      sP[lane * PS + row0 + i] = p0;
      sP[(lane + 32) * PS + row0 + i] = p1;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();

    // acc[i][c] += sum_j p[i][j] v[j][lane + 32 c].
    const int64_t n_keys = S - kt < kBK ? S - kt : kBK;
    for (int j = 0; j < n_keys; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(sP + j * PS + row0);
      const float* vr = sV + j * HD + lane;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vr[32 * c];
        acc[0][c] += p.x * vv;
        acc[1][c] += p.y * vv;
        acc[2][c] += p.z * vv;
        acc[3][c] += p.w * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qi = q0 + row0 + i;
    if (qi >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * Tq + qi) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) store(&orow[d], acc[i][c] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int Hq, int Hkv, int64_t Tq, int64_t S, int hd, float sm_scale,
           int causal, int64_t window, cudaStream_t stream) {
  constexpr int64_t bytes = smem_bytes<HD>();
  // Above 48 KB a block's shared memory must be opted into (per device,
  // so on every launch; the call is cheap beside the kernel).
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((Tq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(Hq), static_cast<unsigned>(B));
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Tq, S, hd,
      sm_scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             int64_t B, int Hq, int Hkv, int64_t Tq, int64_t S, int hd,
             float sm_scale, int causal, int64_t window,
             cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Tq, S, hd, sm_scale,
                         causal, window, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Tq, S, hd, sm_scale,
                          causal, window, stream);
  return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Tq, S, hd, sm_scale,
                        causal, window, stream);
}

}  // namespace

// dtype code: 0 float32, 1 bfloat16 (q, k, v and o alike).  causal is 0
// or 1; window 0 means none.  Launches on `stream`; returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t B,
                                      int Hq, int Hkv, int64_t Tq, int64_t S,
                                      int hd, float sm_scale, int causal,
                                      int64_t window, int dtype,
                                      void* stream) {
  if (B == 0 || Hq == 0 || Tq == 0) return 0;
  if (hd < 1 || hd > 256 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || B > 65535
      || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Hq, Hkv, Tq, S, hd, sm_scale,
                           causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Tq, S, hd,
                                   sm_scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
