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
// key; never under a causal mask with S >= T, nor without a mask) gives
// 0, or the mean of the v rows of the tiles it passed, as in the Pallas
// kernel.  The models call it causal with S = T, and without a mask for
// Whisper's encoder (T = S = 1500) and its cross attention at prefill
// (the prompt's T against S = 1500).
//
// Logit soft-capping (the reference model's _softcap in _mha and
// decode_attention, src/repro/models/layers.py:167-176; the Pallas kernel
// has none): with softcap > 0 each logit y = sm_scale * q.k becomes
// softcap * tanh(y / softcap), after sm_scale and before the mask, so a
// hidden logit (masked, or a key zero-filled past S) stays exactly -2^30
// and never turns into a visible -softcap.  The cap is a template
// parameter of both kernels' bodies: the kernels without it are the same
// code as before it existed, and a launch with softcap <= 0 takes them.
//
// Bound: at the serving path's shape (B = 1, Hq = 16, Hkv = 1,
// T = S = 3072, hd = 256, window 2048, bfloat16) the visible (i, j)
// pairs are 16 * 4,195,328 and each costs 4 * hd operations (q.k and
// p.v): 68.7 GFLOP, 0.069 ms at 989 TFLOP/s of dense bf16 tensor-core
// work, against 53.5 MB of q, k, v and o (0.016 ms at 3.35 TB/s): bound
// by operations, so the tensor cores are the resource.
//
// bfloat16 (the serving dtype): a tensor-core kernel.
// - Both products on the tensor cores with wgmma (bf16 x bf16 -> f32).
//   A block of 256 threads is two warpgroups; each owns 64 query rows of
//   the block's 128.  S = Q K^T is 16 (hd 256) m64n64k16 steps with Q
//   and K read from shared memory through descriptors; O += P V is 4
//   m64n{hd}k16 steps with P as the register A operand (the f32
//   accumulator layout of S is the bf16 A-fragment layout, so P is
//   packed in place and never goes back to shared memory) and V read
//   from shared memory MN-major (the transpose bit).  The float32
//   kernel below runs both products as FMAs on the CUDA cores (67
//   TFLOP/s peak); in bf16 the tensor cores give 989.
// - Tiles stay bf16 in shared memory, stored as hd/64 column blocks of
//   rows x 128 bytes with the 128-byte swizzle that the descriptors
//   name, so wgmma reads them without bank conflicts: Q 128 x 256
//   (64 KB) and a ring of two K and two V stages of 64 x 256 (32 KB
//   each), 193 KB with the 1 KB of alignment slack, one block per SM
//   with up to 255 registers a thread (the float32 kernel's f32 tiles take
//   170.5 KB for 32 queries).  hd is zero-padded to 64, 128 or 256.
// - Loads overlap compute: K/V tile j+1 is copied with cp.async (16
//   bytes a thread, L2-cached, zero-filled past S and hd) into the other
//   stage while tile j is multiplied; one barrier per tile.  hd not a
//   multiple of 8 (or unaligned pointers) take a synchronous copy into
//   the same layout.
// - Tiles that the causal and window masks empty for the whole block
//   are never visited, and a warpgroup skips a tile empty for its 64
//   rows; only tiles that cross the diagonal, the window edge or S test
//   each element.
// - Block order: the Hq heads of one query block run next to each other,
//   so under MQA/GQA they read the same K/V tiles from L2, and the last
//   (under a causal mask the heaviest) query blocks start first.
// - Not done, because it measured slower: issuing S for tile j+1 before
//   the softmax of tile j (the FlashAttention-3 overlap inside a
//   warpgroup) keeps S, P and O live at once and spills at hd 256 on
//   255 registers a thread; tree reductions for the row max and sum, and
//   skipping the O rescale when no row max grew, were slower as well.
// Numerics: products of bf16 values are exact in float32, so S differs
// from the float32 kernel only in summation order.  Logits are scaled by
// sm_scale * log2(e) and exponentiated with ex2.approx.ftz (the
// hardware's approximate 2^x, far finer than bf16).  P is rounded to
// bf16 for the second product (relative error <= 2^-9 per weight), as
// the model's own reference does in _mha (src/repro/models/layers.py:178);
// the Pallas kernel and attention_ref keep P in float32.  l sums the
// unrounded P, and o is acc times 1 / max(l, 1e-30).
//
// Soft-capped (bf16): tanh(y / softcap) is 1 - 2 / (1 + e^(2 y / softcap)),
// with e^(..) from ex2.approx.ftz on one product of the logit and a
// folded constant and 1 / (..) from rcp.approx.ftz, and the result times
// softcap * log2(e) in one FMA: absolute error near 2^-22 of softcap
// where tanh.approx.f32 (one MUFU op, relative error near 2^-11) would
// move a logit by softcap * 2^-11, 0.024 at softcap 50, more than the
// bf16 rounding of P.  It costs two special-function (MUFU) operations a
// logit (ex2, rcp) beside the softmax's ex2.  The H100 issues about 3.9 T
// of them a second (FlashAttention-3, arXiv:2407.08608) against 989
// TFLOP/s of tensor-core work, so at hd 64 one a visible pair already
// costs as long as its 4 * hd products.  Bound of a capped call: the
// largest of the tensor-core time, the special-function time of the two
// operations a pair that the function needs (one tanh, one exponential)
// and the bytes time: the special-function unit at hd 64, it and the
// tensor cores alike at hd 128, the tensor cores at hd 256.
//
// float32: a SIMT kernel: one block of 256 threads per (batch, query
// head, block of 32 queries), float32 FMAs on the CUDA cores with IEEE
// expf, float32 tiles in shared memory.  It carries the float32 checks
// (atol 2e-5 against the oracle), which TF32 tensor cores could not
// meet.  Its cap is softcap * tanhf(y * (1 / softcap)) with CUDA's
// accurate tanhf and 1 / softcap taken on the host.  The capped body
// runs in a kernel of its own, flash_attention_f32_softcap, with a
// register budget of one block per SM: under the uncapped kernel's
// (ptxas keeps it to 80 registers a thread) the capped hd 256 body
// spilled the row sums.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (repro_torch/_build.py)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1073741824.f;  // -2^30, the Pallas kernel's

// --------------------------------------------------------------------------
// float32: SIMT kernel
// --------------------------------------------------------------------------
namespace f32 {

constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;                 // queries per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kRows = kBQ / kWarps;     // query rows per warp (4)
constexpr int kPad = 4;                 // floats of row padding

template <int HD>
constexpr int64_t smem_bytes() {
  return 4 * (kBQ * (HD + kPad)      // q tile
              + kBK * (HD + kPad)    // k tile
              + kBK * HD             // v tile
              + kBK * (kBQ + kPad)); // softmax weights, transposed
}

// One block per (batch, query head, block of 32 queries) walks the key
// tiles of 64 that its queries can see.  Each warp owns 4 query rows:
// its lanes take 2 keys each for the logits (float4 reads along hd; rows
// padded by 4 floats, so the reads are free of bank conflicts), reduce
// the row max and sum with shuffles, and then own hd / 32 output columns
// of those rows for p.v, accumulating in registers.
template <int HD, bool CAP>
__device__ __forceinline__ void attention_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Hq, int Hkv,
    int64_t Tq, int64_t S, int hd, float sm_scale, int causal,
    int64_t window, float softcap, float inv_softcap) {
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
  const float* qp = q + bh * Tq * hd;
  const float* kp = k + bhk * S * hd;
  const float* vp = v + bhk * S * hd;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    sQ[r * QS + d] = (q0 + r < Tq && d < hd) ? qp[(q0 + r) * hd + d] : 0.f;
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
      sK[j * QS + d] = in ? kp[(kt + j) * hd + d] : 0.f;
      sV[j * HD + d] = in ? vp[(kt + j) * hd + d] : 0.f;
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
        float y = s[i][c] * sm_scale;
        if constexpr (CAP) y = tanhf(y * inv_softcap) * softcap;
        x[c] = ok ? y : kNegInf;
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
    float* orow = o + (bh * Tq + qi) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) orow[d] = acc[i][c] / denom;
    }
  }
}

#define F32_ARGS                                                          \
  const float *__restrict__ q, const float *__restrict__ k,               \
      const float *__restrict__ v, float *__restrict__ o, int Hq, int Hkv, \
      int64_t Tq, int64_t S, int hd, float sm_scale, int causal,           \
      int64_t window, float softcap, float inv_softcap
#define F32_PASS \
  q, k, v, o, Hq, Hkv, Tq, S, hd, sm_scale, causal, window, softcap, inv_softcap

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_f32(F32_ARGS) {
  attention_f32<HD, false>(F32_PASS);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_f32_softcap(F32_ARGS) {
  attention_f32<HD, true>(F32_PASS);
}

#undef F32_ARGS
#undef F32_PASS

template <int HD, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int Hq, int Hkv, int64_t Tq, int64_t S, int hd, float sm_scale,
           float softcap, int causal, int64_t window, cudaStream_t stream) {
  constexpr int64_t bytes = smem_bytes<HD>();
  const auto kernel =
      CAP ? flash_attention_f32_softcap<HD> : flash_attention_f32<HD>;
  // Above 48 KB a block's shared memory must be opted into (per device,
  // so on every launch; the call is cheap beside the kernel).
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((Tq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(Hq), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Tq, S,
      hd, sm_scale, causal, window, softcap, CAP ? 1.f / softcap : 0.f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// --------------------------------------------------------------------------
// bfloat16: tensor-core kernel (wgmma)
// --------------------------------------------------------------------------
namespace bf16 {

constexpr int kBQ = 128;                // queries per block, 64 per warpgroup
constexpr int kBK = 64;                 // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: 1 KB of slack to align the tiles to the 1024-byte
// swizzle atom, the Q tile, then two K and two V stages.
template <int HD>
constexpr int smem_bytes() {
  return 1024 + kBQ * HD * 2 + 4 * kBK * HD * 2;
}

// Byte offset of 16-byte chunk c (bf16 columns 8c..8c+7) of row r in a
// tile of `rows` rows, stored as column blocks of 64 (rows x 128 bytes
// each) with the 128-byte swizzle: chunk c & 7 of row r sits at chunk
// (c & 7) ^ (r & 7) of the row.
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// Copy rows row0 .. row0 + ROWS - 1 of a (n_rows, hd) bf16 matrix into a
// swizzled tile, zeros past n_rows and hd: cp.async of 16 bytes a thread
// when `vec`, else a synchronous copy through registers.
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t row0, int64_t n_rows,
                                          int hd, bool vec) {
  constexpr int kChunks = HD / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "tile / threads");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kChunks, c = e % kChunks;
    const int64_t row = row0 + r;
    const uint32_t to = dst + swizzled(ROWS, r, c);
    if (vec) {
      const bool in = row < n_rows && c * 8 < hd;
      const __nv_bfloat16* from = in ? src + row * hd + c * 8 : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(to), "l"(from), "r"(in ? 16 : 0) : "memory");
    } else {
      const unsigned short* s16 =
          reinterpret_cast<const unsigned short*>(src);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = c * 8 + 2 * j;
        const uint32_t lo = row < n_rows && d < hd ? s16[row * hd + d] : 0;
        const uint32_t hi =
            row < n_rows && d + 1 < hd ? s16[row * hd + d + 1] : 0;
        w[j] = lo | hi << 16;
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(to), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Make this thread's shared-memory writes visible to the async proxy
// (wgmma reads its operands through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Tie registers that an asynchronous wgmma reads or writes to this
// point of the program, so the compiler moves no access across it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

#define F8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),      \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 64, f32) = (scale_d ? D : 0) + A (64 x 16) B (16 x 64): A and B
// bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x N, f32) += A (64 x 16, bf16 in registers: the A fragment, which
// is the f32 accumulator layout packed in pairs) B (16 x N, bf16 in
// shared memory, MN-major: imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40),
        F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40),
        F8(48), F8(56), F8(64), F8(72), F8(80), F8(88),
        F8(96), F8(104), F8(112), F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F8

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (HD == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (HD == 128) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n256(d, a, b);
}

// One block per (batch, query head, block of 128 queries); warpgroup w
// owns query rows q0 + 64 w .. q0 + 64 w + 63.  In the wgmma accumulator
// layout a thread (warp wp of its warpgroup, lane) holds, of a 64 x N
// tile, rows 16 wp + lane / 4 (elements 4 b + 0, 1) and that + 8
// (elements 4 b + 2, 3), columns 8 b + 2 (lane % 4) + {0, 1}.
// Without CAP a logit s becomes s * scale_log2 (sm_scale * log2 e); with
// CAP, scale_log2 is 2 sm_scale log2(e) / softcap and cap_log2 is
// softcap * log2(e): x = cap_log2 (1 - 2 / (1 + 2^(s scale_log2))).
template <int HD, bool CAP>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int Hq, int Hkv, int64_t Tq, int64_t S, int hd, float scale_log2,
    int causal, int64_t window, int n_qblocks, int vec, float cap_log2) {
  constexpr int NO = HD / 2;             // output accumulators a thread
  constexpr uint32_t kTile = kBK * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023)
      & ~1023u;
  const uint32_t sK = sQ + kBQ * HD * 2;  // stage s at sK + s * kTile
  const uint32_t sV = sK + 2 * kTile;

  // The Hq heads of one query block are neighbours in launch order, and
  // the last query blocks come first.
  const int64_t lin = blockIdx.x;
  const int h = static_cast<int>(lin % Hq);
  const int64_t qb = n_qblocks - 1 - (lin / Hq) % n_qblocks;
  const int64_t b = lin / (static_cast<int64_t>(Hq) * n_qblocks);
  const int64_t q0 = qb * kBQ;
  const int64_t bh = b * Hq + h;
  const int64_t bhk = b * Hkv + h / (Hq / Hkv);
  const __nv_bfloat16* qp = q + bh * Tq * hd;
  const __nv_bfloat16* kp = k + bhk * S * hd;
  const __nv_bfloat16* vp = v + bhk * S * hd;

  // Keys any of this block's queries can see: [k_lo, k_hi].
  const int64_t q_last = (q0 + kBQ < Tq ? q0 + kBQ : Tq) - 1;
  int64_t k_hi = S - 1;
  if (causal && q_last < k_hi) k_hi = q_last;
  int64_t k_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  const int64_t kt0 = (k_lo / kBK) * kBK;
  const int n_tiles =
      k_hi >= kt0 ? static_cast<int>((k_hi - kt0) / kBK) + 1 : 0;

  load_tile<kBQ, HD>(sQ, qp, q0, Tq, hd, vec);
  if (n_tiles > 0) {
    load_tile<kBK, HD>(sK, kp, kt0, S, hd, vec);
    load_tile<kBK, HD>(sV, vp, kt0, S, hd, vec);
  }
  cp_async_commit();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int64_t w0 = q0 + 64 * wg;                  // the warpgroup's rows
  const int64_t w1 = (w0 + 63 < Tq ? w0 + 63 : Tq - 1);
  const int64_t row = w0 + 16 * warp + lane / 4;    // and row + 8
  const int col = 2 * (lane % 4);
  const uint32_t sQw = sQ + wg * 64 * 128;

  float acc[NO], s[32];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int64_t kt = kt0 + static_cast<int64_t>(it) * kBK;
    const uint32_t sKt = sK + (it & 1) * kTile, sVt = sV + (it & 1) * kTile;
    cp_async_wait_all();
    fence_proxy_async();
    // Tile it is in shared memory, and every warpgroup is done with tile
    // it - 1, whose stage the next copy refills.
    __syncthreads();
    if (it + 1 < n_tiles) {
      const uint32_t nxt = ((it + 1) & 1) * kTile;
      load_tile<kBK, HD>(sK + nxt, kp, kt + kBK, S, hd, vec);
      load_tile<kBK, HD>(sV + nxt, vp, kt + kBK, S, hd, vec);
      cp_async_commit();
    }
    // Nothing to do if the warpgroup has no rows or the masks empty the
    // tile for all of them.
    if (w1 < w0 || (causal && kt > w1)
        || (window > 0 && kt + kBK - 1 <= w0 - window))
      continue;
    const bool edge = kt + kBK > S || (causal && kt + kBK - 1 > w0)
                      || (window > 0 && kt <= w1 - window);

    // S = Q K^T over hd in steps of 16: within a 64-column block the
    // descriptor moves 32 bytes a step; blocks are rows x 128 bytes apart.
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint32_t qa = sQw + (ks / 4) * (kBQ * 128) + (ks % 4) * 32;
      const uint32_t ka = sKt + (ks / 4) * (kBK * 128) + (ks % 4) * 32;
      wgmma_ss_n64(s, descriptor(qa, 16, 1024), descriptor(ka, 16, 1024),
                   ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // Online softmax in base 2 on the thread's two rows; the cap, where
    // there is one, on every logit of every tile, before the mask.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x;
      if constexpr (CAP)
        x = fmaf(rcp(1.f + ex2(s[i] * scale_log2)), -2.f * cap_log2,
                 cap_log2);
      else
        x = s[i] * scale_log2;
      if (edge) {
        const int64_t qi = row + 8 * ((i >> 1) & 1);
        const int64_t kj = kt + 8 * (i >> 2) + col + (i & 1);
        bool ok = kj < S;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        if (!ok) x = kNegInf;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(s[i] - mx[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // P as bf16 A fragments: keys 16 ks .. 16 ks + 15 are accumulator
    // elements 8 ks .. 8 ks + 7.
    uint32_t p[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    // O += P V over the tile's keys in steps of 16 (16 rows of V are
    // 2048 bytes); V's 64-column blocks are kBK * 128 bytes apart.
    pin(acc);
    pin(p);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2],
                             p[4 * ks + 3]};
      wgmma_pv<HD>(acc, a, descriptor(sVt + ks * 2048, kBK * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
  }

  // The row sums are spread over the four lanes that share a row; o is
  // acc times 1 / max(l, 1e-30) (one division a row, not one an element).
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qi = row + 8 * r;
    if (qi >= Tq) continue;
    __nv_bfloat16* orow = o + (bh * Tq + qi) * hd;
#pragma unroll
    for (int bc = 0; bc < HD / 8; ++bc) {
      const int d = 8 * bc + col;
      const float x0 = acc[4 * bc + 2 * r] * inv[r];
      const float x1 = acc[4 * bc + 2 * r + 1] * inv[r];
      if (d + 1 < hd && hd % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < hd) orow[d] = __float2bfloat16(x0);
        if (d + 1 < hd) orow[d + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int HD, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int Hq, int Hkv, int64_t Tq, int64_t S, int hd, float sm_scale,
           float softcap, int causal, int64_t window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16<HD, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_qblocks = (Tq + kBQ - 1) / kBQ;
  const int64_t blocks = B * Hq * n_qblocks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = hd % 8 == 0
      && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
           | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const float scale_log2 =
      CAP ? 2.f * sm_scale * kLog2e / softcap : sm_scale * kLog2e;
  flash_attention_bf16<HD, CAP><<<static_cast<unsigned>(blocks), kThreads,
                                  bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Hq, Hkv, Tq, S, hd, scale_log2, causal, window,
      static_cast<int>(n_qblocks), vec, softcap * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16

template <bool CAP, typename Launch>
int dispatch_hd(int hd, Launch&& launch) {
  if (hd <= 64) return launch(std::integral_constant<int, 64>(),
                              std::bool_constant<CAP>());
  if (hd <= 128) return launch(std::integral_constant<int, 128>(),
                               std::bool_constant<CAP>());
  return launch(std::integral_constant<int, 256>(),
                std::bool_constant<CAP>());
}

template <typename Launch>
int dispatch(int hd, bool cap, Launch&& launch) {
  return cap ? dispatch_hd<true>(hd, launch) : dispatch_hd<false>(hd, launch);
}

}  // namespace

// dtype code: 0 float32, 1 bfloat16 (q, k, v and o alike).  causal is 0
// or 1; window 0 means none; softcap > 0 caps the logits, any other value
// means none.  Launches on `stream`; returns cudaGetLastError() of the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t B,
                                      int Hq, int Hkv, int64_t Tq, int64_t S,
                                      int hd, float sm_scale, float softcap,
                                      int causal, int64_t window, int dtype,
                                      void* stream) {
  if (B == 0 || Hq == 0 || Tq == 0) return 0;
  if (hd < 1 || hd > 256 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || B > 65535
      || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (dtype == 0)
    return dispatch(hd, cap, [&](auto HD, auto CAP) {
      return f32::launch<decltype(HD)::value, decltype(CAP)::value>(
          q, k, v, o, B, Hq, Hkv, Tq, S, hd, sm_scale, softcap, causal,
          window, s);
    });
  if (dtype == 1)
    return dispatch(hd, cap, [&](auto HD, auto CAP) {
      return bf16::launch<decltype(HD)::value, decltype(CAP)::value>(
          q, k, v, o, B, Hq, Hkv, Tq, S, hd, sm_scale, softcap, causal,
          window, s);
    });
  return static_cast<int>(cudaErrorInvalidValue);
}
