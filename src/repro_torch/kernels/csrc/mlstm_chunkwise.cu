// Chunkwise-parallel stabilised mLSTM cell, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mlstm_chunkwise.py:31
// _mlstm_kernel (called through :85 mlstm_chunkwise) and computes what
// its oracle src/repro/models/xlstm.py:69 _mlstm_chunkwise computes.  For
// each (batch, head) it walks the T/L chunks in order, carrying the
// matrix memory C (dk, dv), the normaliser n (dk) and the stabiliser m;
// per chunk, with b = cumsum(log_sigmoid(f)) and g = b[L-1]:
//   D_ij   = b_i - b_j + i_j for j <= i, else -inf
//   m_i    = max(b_i + m, max_j D_ij), floored at -1e30
//   h_i    = (e^{b_i+m-m_i} q_i C + sum_j e^{D_ij-m_i} (q_i.k_j) v_j)
//            / max(|e^{b_i+m-m_i} q_i.n + sum_j e^{D_ij-m_i} q_i.k_j|,
//                  e^{-m_i})
//   m'     = max(g + m, max_j (g - b_j + i_j)), floored at -1e30
//   C      = e^{g+m-m'} C + sum_j e^{g-b_j+i_j-m'} k_j v_j^T, n likewise.
// m starts at -inf (the oracle's start; the Pallas kernel's -1e30 gives
// the same values) or at a given state.  Inputs q, k (B,H,T,dk),
// v (B,H,T,dv), i, f (B,H,T) are float32 or bfloat16, contiguous; h is
// written in the inputs' dtype, the final state, when asked for, in
// float32.  All arithmetic is float32.
//
// Bound: the cell reads q, k, v and the gates once and writes h once;
// at the forecaster's shape (B=8668, H=2, T=L=16, dk=dv=32) that is
// 144 MB, about 43 us at 3.35 TB/s, against ~1.7 GFLOP of products (about
// 25 us at 67 TFLOP/s of float32), so it is bound by bytes.  Design (a
// simple kernel that is right; wgmma and TMA are later work): grid
// (B*H, ceil(dv/32)), 128 threads; each block owns one (b, h) and a
// 32-column slice of C and v, holds its C slice and n in shared memory
// for the whole walk, and recomputes everything that does not depend on
// the slice (gate prefix, D, m_i, q.k, row sums, q.n, the n update), so
// blocks never talk to each other.  q and k rows are padded by one float
// in shared memory so that the q.k loop, where neighbouring threads read
// neighbouring rows of k, is free of bank conflicts.  No library call:
// the four products are the block's own loops.  Built without
// --use_fast_math (expf, log1pf and division stay IEEE-accurate); FMA
// contraction is allowed, the path being float32 with a tolerance.
//
// Limits: L <= 64 and dk <= 128 (shared memory: 109 KB at those limits,
// opted in above 48 KB); any dv.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (repro_torch/_build.py)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBV = 32;           // columns of C (and of v and h) per block
constexpr float kFloor = -1e30f;  // stabiliser floor, as the oracle's

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// jax.nn.log_sigmoid(x) = -softplus(-x) = min(x, 0) - log1p(exp(-|x|)),
// the form torch's F.logsigmoid uses too.
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Shared floats a block needs for chunk length L and key width dk.
__host__ __device__ inline int64_t smem_floats(int64_t L, int64_t dk) {
  return 2 * L * (dk + 1)   // q, k (rows padded by one)
         + L * kBV          // v slice
         + L * (L + 1)      // P = S o qk (rows padded by one)
         + dk * kBV         // C slice
         + dk               // n
         + 5 * L            // b, i, w, inter_w, norm
         + 4;               // m, m', scale_old, pad
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_chunkwise_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ ig,
    const T* __restrict__ fg, const float* __restrict__ C0,
    const float* __restrict__ n0, const float* __restrict__ m0,
    T* __restrict__ h, float* __restrict__ C_out, float* __restrict__ n_out,
    float* __restrict__ m_out, int T_len, int L, int dk, int dv) {
  extern __shared__ float smem[];
  const int64_t bh = blockIdx.x;
  const int v0 = blockIdx.y * kBV;
  const int bv = min(kBV, dv - v0);  // this block's columns
  const int tid = threadIdx.x;
  const int qs = dk + 1;
  const int ps = L + 1;
  float* sq = smem;
  float* sk = sq + L * qs;
  float* sv = sk + L * qs;
  float* sP = sv + L * kBV;
  float* sC = sP + L * ps;
  float* sn = sC + dk * kBV;
  float* sb = sn + dk;
  float* si = sb + L;
  float* sw = si + L;
  float* sinter = sw + L;
  float* snorm = sinter + L;
  float* sm = snorm + L;  // [0] m, [1] m', [2] scale_old

  const int64_t base_qk = bh * T_len * dk;
  const int64_t base_v = bh * T_len * dv;
  const int64_t base_g = bh * T_len;
  const bool want_state = C_out != nullptr;
  // C and n are exactly zero until the first update (or a given state),
  // and then q.C and q.n add exactly zero: skip them.
  bool have_state = C0 != nullptr;

  for (int e = tid; e < dk * kBV; e += kThreads) {
    const int d = e / kBV, c = e % kBV;
    sC[e] = (have_state && c < bv) ? C0[(bh * dk + d) * dv + v0 + c] : 0.f;
  }
  for (int d = tid; d < dk; d += kThreads)
    sn[d] = have_state ? n0[bh * dk + d] : 0.f;
  if (tid == 0) sm[0] = have_state ? m0[bh] : -INFINITY;

  const int n_chunks = T_len / L;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int64_t t0 = static_cast<int64_t>(ch) * L;
    const bool update = ch + 1 < n_chunks || want_state;
    __syncthreads();  // the previous chunk is done with q, k, v, P and m

    for (int e = tid; e < L * dk; e += kThreads) {
      const int r = e / dk, d = e % dk;
      sq[r * qs + d] = to_f32(q[base_qk + t0 * dk + e]);
      sk[r * qs + d] = to_f32(k[base_qk + t0 * dk + e]);
    }
    for (int e = tid; e < L * kBV; e += kThreads) {
      const int r = e / kBV, c = e % kBV;
      sv[e] = c < bv ? to_f32(v[base_v + (t0 + r) * dv + v0 + c]) : 0.f;
    }
    if (tid < 32) {  // warp 0: b = inclusive cumsum of log_sigmoid(f)
      float carry = 0.f;
      for (int s = 0; s < L; s += 32) {
        const int r = s + tid;
        float x = r < L ? log_sigmoid(to_f32(fg[base_g + t0 + r])) : 0.f;
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, x, off);
          if (tid >= off) x += y;
        }
        x += carry;
        if (r < L) {
          sb[r] = x;
          si[r] = to_f32(ig[base_g + t0 + r]);
        }
        carry = __shfl_sync(0xffffffffu, x, 31);
      }
    }
    __syncthreads();

    // qk_ij = q_i . k_j on and below the diagonal.
    for (int e = tid; e < L * L; e += kThreads) {
      const int i = e / L, j = e % L;
      float acc = 0.f;
      if (j <= i) {
        const float* qi = sq + i * qs;
        const float* kj = sk + j * qs;
        for (int d = 0; d < dk; ++d) acc += qi[d] * kj[d];
      }
      sP[i * ps + j] = acc;
    }
    __syncthreads();

    // Row i: m_i, inter_w_i, P_ij = exp(D_ij - m_i) qk_ij, normaliser.
    const float m = sm[0];
    for (int i = tid; i < L; i += kThreads) {
      const float bi = sb[i];
      const float log_a = bi + m;
      float mx = log_a;
      for (int j = 0; j <= i; ++j) mx = fmaxf(mx, bi - sb[j] + si[j]);
      const float m_i = fmaxf(mx, kFloor);
      const float inter_w = expf(log_a - m_i);
      float den = 0.f;
      for (int j = 0; j <= i; ++j) {
        const float p = expf(bi - sb[j] + si[j] - m_i) * sP[i * ps + j];
        sP[i * ps + j] = p;
        den += p;
      }
      if (have_state) {
        float qn = 0.f;
        for (int d = 0; d < dk; ++d) qn += sq[i * qs + d] * sn[d];
        den += inter_w * qn;
      }
      sinter[i] = inter_w;
      snorm[i] = fmaxf(fabsf(den), expf(-m_i));
    }
    __syncthreads();

    // h_ic = (inter_w_i q_i.C_c + sum_j P_ij v_jc) / norm_i.
    for (int e = tid; e < L * kBV; e += kThreads) {
      const int i = e / kBV, c = e % kBV;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra += sP[i * ps + j] * sv[j * kBV + c];
      float inter = 0.f;
      if (have_state) {
        for (int d = 0; d < dk; ++d) inter += sq[i * qs + d] * sC[d * kBV + c];
      }
      if (c < bv)
        store(h + base_v + (t0 + i) * dv + v0 + c,
              (sinter[i] * inter + intra) / snorm[i]);
    }
    if (!update) break;

    // State update.
    if (tid == 0) {
      const float g = sb[L - 1];
      float mx = g + m;
      for (int j = 0; j < L; ++j) mx = fmaxf(mx, g - sb[j] + si[j]);
      const float m_new = fmaxf(mx, kFloor);
      sm[1] = m_new;
      sm[2] = expf(g + m - m_new);
    }
    __syncthreads();  // also: every reader of C above is done
    const float g = sb[L - 1];
    const float m_new = sm[1];
    const float scale_old = sm[2];
    for (int j = tid; j < L; j += kThreads)
      sw[j] = expf(g - sb[j] + si[j] - m_new);
    __syncthreads();
    for (int e = tid; e < dk * kBV; e += kThreads) {
      const int d = e / kBV, c = e % kBV;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc += sw[j] * sk[j * qs + d] * sv[j * kBV + c];
      sC[e] = scale_old * sC[e] + acc;
    }
    for (int d = tid; d < dk; d += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc += sw[j] * sk[j * qs + d];
      sn[d] = scale_old * sn[d] + acc;
    }
    if (tid == 0) sm[0] = m_new;
    have_state = true;
  }

  if (want_state) {
    __syncthreads();
    for (int e = tid; e < dk * kBV; e += kThreads) {
      const int d = e / kBV, c = e % kBV;
      if (c < bv) C_out[(bh * dk + d) * dv + v0 + c] = sC[e];
    }
    if (blockIdx.y == 0) {
      for (int d = tid; d < dk; d += kThreads) n_out[bh * dk + d] = sn[d];
      if (tid == 0) m_out[bh] = sm[0];
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, const void* C0, const void* n0, const void* m0,
           void* h, void* C_out, void* n_out, void* m_out, int64_t bh,
           int64_t t_len, int64_t L, int64_t dk, int64_t dv,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats(L, dk)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlstm_chunkwise_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((dv + kBV - 1) / kBV));
  mlstm_chunkwise_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(ig),
      static_cast<const T*>(fg), static_cast<const float*>(C0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<T*>(h), static_cast<float*>(C_out),
      static_cast<float*>(n_out), static_cast<float*>(m_out),
      static_cast<int>(t_len), static_cast<int>(L), static_cast<int>(dk),
      static_cast<int>(dv));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.  The
// state pointers C0/n0/m0 are all null (start from m = -inf) or all set;
// C_out/n_out/m_out likewise (null: do not write the final state).
// dtype: 0 float32, 1 bfloat16.
extern "C" int mlstm_chunkwise_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* C0, const void* n0, const void* m0, void* h,
    void* C_out, void* n_out, void* m_out, int64_t bh, int64_t t_len,
    int64_t L, int64_t dk, int64_t dv, int dtype, void* stream) {
  if (bh == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, ig, fg, C0, n0, m0, h, C_out, n_out, m_out,
                         bh, t_len, L, dk, dv, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, ig, fg, C0, n0, m0, h, C_out,
                                 n_out, m_out, bh, t_len, L, dk, dv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
