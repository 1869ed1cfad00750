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
// float32.  All arithmetic is float32 on the CUDA cores.  Built without
// --use_fast_math (expf, log1pf and division stay IEEE-accurate); FMA
// contraction is allowed, the path being float32 with a tolerance.
//
// Bound: the cell reads q, k, v and the gates once and writes h once.
// At the forecaster's shape (B = 8668, H = 2, T = L = 16, dk = dv = 32,
// float32, no state in or out) that is 144.2 MB, 43.1 us at 3.35 TB/s,
// against 0.30 G operations (q.k and P.v over the 136 pairs j <= i of
// each chunk; chip_smoke.py _mlstm_work), 4.5 us at 67 TFLOP/s of
// float32: it is bound by bytes, by about tenfold.
//
// Two kernels; the wrapper (kernels/mlstm_chunkwise.py) picks one by
// shape:
//
// mlstm_rows (the forecaster's envelope: L <= 32, dk, dv <= 64, L, dk
// and dv whole 16-byte rows, 16-byte-aligned inputs).  Design: bytes in
// flight, and no block-wide barrier.  A lane owns one row i of a chunk,
// and a warp owns one (batch, head) for L > 16, or two for L <= 16 (a
// half-warp each): the gate prefix sum is a shuffle loop, m_i and the
// normaliser are registers, q_i and the row's h accumulator are
// registers, k_j and v_j rows are shared-memory broadcasts, and each lane
// takes its own exponentials (at most L).  Blocks are persistent (as many
// as are resident, each of up to 4 warps), and each warp walks many
// (batch, head) chunks with its own ring of 2-3 stages in shared memory,
// filled by 16-byte cp.async copies of each chunk's contiguous q, k, v
// and gate rows one or two chunks ahead (about 100 KB in flight per SM at
// the forecaster's shape) while the current chunk computes; the walk
// keeps cursors, so nothing in it divides.  q rows, which lanes read one
// a lane, and h, staged in the stage's v rows and written one row a lane,
// keep their 16-byte pieces XOR-swizzled by row; h goes out in coalesced
// 16-byte stores.  C and n, when a state is carried (more than one chunk,
// a state in or out), live in the warp's shared memory: lanes own columns
// of C for the update.  What bounds it at the forecaster's shape is its
// own issue: each lane reads every k_j and v_j row of its (b, h) from
// shared memory (16 KB a chunk, against 6 KB from device memory), and the
// arithmetic hides device-memory latency only partly.
//
// mlstm_chunkwise (everything else up to L <= 64, dk <= 384, any dv:
// xLSTM-125M's heads are 384 wide): grid (B*H, ceil(dv/32)), 256 threads;
// each block owns one (b, h) and a 32-column slice of C and v, holds its C
// slice (dk x 32) and n in shared memory for the whole walk, and
// recomputes everything that does not depend on the slice (gate prefix, D,
// m_i, q.k, row sums, q.n, the n update), so blocks never talk to each
// other.  q and k pass through shared memory in panels of 128 columns
// (rows padded by one float, so that the q.k loop, where neighbouring
// threads read neighbouring rows of k, is free of bank conflicts): per
// chunk, each panel of q and k adds its part of q.k, q.C and q.n to
// registers (each sum still runs over d in order), and the C and n update
// walks the k panels again from the last, which is still in shared memory,
// down (at dk <= 128 there is one panel and nothing is read twice).
// Shared memory: 143 KB at L = 64, dk = 384 (q and k whole would need 197
// KB in float32 alone), opted in above 48 KB.  At the forecaster's shape
// an earlier 128-thread version with q and k whole in shared memory ran at
// 28-30 % of the bound (five phases a chunk between __syncthreads, a row
// phase on 16 of 128 threads, 4-byte loads, no overlap of a block's loads
// with its compute); this one holds 2 blocks an SM there and is slower,
// but that shape goes to mlstm_rows.  At xLSTM-125M's prefill (B*H = 4, dk
// = dv = 384, L = 64) it is bound by operations (about 7.8 G float32
// operations at T = 3072), and its 48 blocks recompute q.k once per column
// slice, 12 times over, on 48 of 132 SMs: a simple kernel, far from that
// bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (repro_torch/_build.py)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBV = 32;           // columns of C (and of v and h) per block
constexpr int kDP = 128;          // columns of q and k per shared-memory panel
constexpr int kMaxL = 64;         // the block kernel's limits
constexpr int kMaxDk = 384;
static_assert(kThreads == 256 && kMaxL == 64 && kBV == 32 && kDP == 128,
              "the register tiles assume a 16 x 16 thread grid over rows "
              "of 64, 32 columns and panels of 128");
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

// Shared floats a block needs for chunk length L and key width dk: one
// panel of q and of k (rows padded by one), the v slice, P, the C slice,
// n, and the per-row scalars.
__host__ __device__ inline int64_t smem_floats(int64_t L, int64_t dk) {
  const int64_t dp = dk < kDP ? dk : kDP;
  return 2 * L * (dp + 1)   // q, k panels
         + L * kBV          // v slice
         + L * (L + 1)      // P = S o qk (rows padded by one)
         + dk * kBV         // C slice
         + dk               // n
         + 6 * L            // b, i, w, inter_w, norm, q.n
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
  const int qs = min(dk, kDP) + 1;
  const int ps = L + 1;
  const int n_panels = (dk + kDP - 1) / kDP;
  const int ti = tid / 16, tj = tid % 16;  // the register tiles' owner
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
  float* sqn = snorm + L;
  float* sm = sqn + L;  // [0] m, [1] m', [2] scale_old

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

  // Columns d0 .. d0 + w of the chunk's rows of x into a panel.
  auto load_panel = [&](float* dst, const T* x, int64_t t0, int d0, int w) {
    for (int e = tid; e < L * w; e += kThreads) {
      const int r = e / w, d = e % w;
      dst[r * qs + d] = to_f32(x[base_qk + (t0 + r) * dk + d0 + d]);
    }
  };

  const int n_chunks = T_len / L;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int64_t t0 = static_cast<int64_t>(ch) * L;
    const bool update = ch + 1 < n_chunks || want_state;
    __syncthreads();  // the previous chunk is done with every buffer

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

    // Over the dk panels: qk_ij = q_i . k_j on and below the diagonal,
    // q_i . C_c and q_i . n, each summed over d in order in registers.
    // Thread (ti, tj) owns rows i = ti + 16a (a < 4), key rows
    // j = tj + 16b (b <= a) and columns c = tj + 16b (b < 2): per d it
    // reads 4 q, 4 k, 2 C and one n value for 10 + 8 + 4 products.
    float qk[4][4], qc[4][2], qn[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qn[a] = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) qk[a][b] = 0.f;
#pragma unroll
      for (int b = 0; b < 2; ++b) qc[a][b] = 0.f;
    }
    for (int p = 0; p < n_panels; ++p) {
      const int d0 = p * kDP, w = min(kDP, dk - d0);
      if (p > 0) __syncthreads();  // the previous panel's readers are done
      load_panel(sq, q, t0, d0, w);
      load_panel(sk, k, t0, d0, w);
      __syncthreads();
      for (int d = 0; d < w; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          qv[a] = ti + 16 * a < L ? sq[(ti + 16 * a) * qs + d] : 0.f;
          kv[a] = tj + 16 * a < L ? sk[(tj + 16 * a) * qs + d] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b <= a; ++b) qk[a][b] += qv[a] * kv[b];
        if (have_state) {
          const float* Cd = sC + (d0 + d) * kBV + tj;
          const float c0 = Cd[0], c1 = Cd[16], nd = sn[d0 + d];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            qc[a][0] += qv[a] * c0;
            qc[a][1] += qv[a] * c1;
            qn[a] += qv[a] * nd;
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + 16 * a;
      if (i >= L) continue;
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        const int j = tj + 16 * b;
        if (j < L) sP[i * ps + j] = qk[a][b];
      }
      if (tj == 0) sqn[i] = qn[a];
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
      if (have_state) den += inter_w * sqn[i];
      sinter[i] = inter_w;
      snorm[i] = fmaxf(fabsf(den), expf(-m_i));
    }
    __syncthreads();

    // h_ic = (inter_w_i q_i.C_c + sum_j P_ij v_jc) / norm_i, for the
    // thread's rows i = ti + 16a and columns c = tj + 16b.
    {
      float intra[4][2];
#pragma unroll
      for (int a = 0; a < 4; ++a) intra[a][0] = intra[a][1] = 0.f;
      const int last = min(ti + 48, L - 1);
      for (int j = 0; j <= last; ++j) {
        const float v0j = sv[j * kBV + tj], v1j = sv[j * kBV + tj + 16];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ti + 16 * a;
          if (i < L && j <= i) {
            const float pij = sP[i * ps + j];
            intra[a][0] += pij * v0j;
            intra[a][1] += pij * v1j;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ti + 16 * a;
        if (i >= L) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int c = tj + 16 * b;
          if (c < bv)
            store(h + base_v + (t0 + i) * dv + v0 + c,
                  (sinter[i] * qc[a][b] + intra[a][b]) / snorm[i]);
        }
      }
    }
    if (!update) break;

    // State update, panel by panel from the last (still in sk) down.
    if (tid == 0) {
      const float g = sb[L - 1];
      float mx = g + m;
      for (int j = 0; j < L; ++j) mx = fmaxf(mx, g - sb[j] + si[j]);
      const float m_new = fmaxf(mx, kFloor);
      sm[1] = m_new;
      sm[2] = expf(g + m - m_new);
    }
    __syncthreads();
    const float g = sb[L - 1];
    const float m_new = sm[1];
    const float scale_old = sm[2];
    for (int j = tid; j < L; j += kThreads)
      sw[j] = expf(g - sb[j] + si[j] - m_new);
    __syncthreads();
    for (int p = n_panels - 1; p >= 0; --p) {
      const int d0 = p * kDP, w = min(kDP, dk - d0);
      if (p < n_panels - 1) {
        __syncthreads();  // the previous panel's readers are done
        load_panel(sk, k, t0, d0, w);
        __syncthreads();
      }
      // Thread (ti, tj) owns rows d = ti + 16a (a < 8) of the panel and
      // columns c = tj + 16b (b < 2) of the C slice.
      float acc[8][2];
#pragma unroll
      for (int a = 0; a < 8; ++a) acc[a][0] = acc[a][1] = 0.f;
      for (int j = 0; j < L; ++j) {
        const float wj = sw[j];
        const float v0j = sv[j * kBV + tj], v1j = sv[j * kBV + tj + 16];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int d = ti + 16 * a;
          const float wk = d < w ? wj * sk[j * qs + d] : 0.f;
          acc[a][0] += wk * v0j;
          acc[a][1] += wk * v1j;
        }
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int d = ti + 16 * a;
        if (d >= w) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          float* Cdc = sC + (d0 + d) * kBV + tj + 16 * b;
          *Cdc = scale_old * *Cdc + acc[a][b];
        }
      }
      for (int d = tid; d < w; d += kThreads) {
        float acc = 0.f;
        for (int j = 0; j < L; ++j) acc += sw[j] * sk[j * qs + d];
        sn[d0 + d] = scale_old * sn[d0 + d] + acc;
      }
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
  if (L < 1 || L > kMaxL || dk < 1 || dk > kMaxDk || dv < 1 || t_len % L ||
      t_len > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
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

// ---------------------------------------------------------------------------
// mlstm_rows: one lane per row of a chunk (see the note at the top).

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowThreadsMax = 128;  // at most 4 warps a block
constexpr int kScratch = 64;         // floats a (b, h) keeps: b_j, w_j

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most `pending` of this thread's cp.async groups are in
// flight (the ring has 2 or 3 stages).
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else
    asm volatile("cp.async.wait_group 1;\n" ::);
}

// 16 bytes of shared memory as floats (4 float32 or 8 bfloat16 values).
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* x) {
  uint4 out;
  unsigned* w = reinterpret_cast<unsigned*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 y = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
    w[e] = *reinterpret_cast<const unsigned*>(&y);
  }
  *reinterpret_cast<uint4*>(p) = out;
}

// Rows that lanes read (q) or write (h) one lane a row keep their
// 16-byte piece `c` at piece c ^ (row & 7): rows are whole multiples of
// 128 bytes, so eight lanes on eight neighbouring rows hit eight distinct
// 16-byte bank groups.  k and v rows, read as broadcasts, are not
// swizzled.
__device__ __forceinline__ int swz(int c, int row) { return c ^ (row & 7); }

// Layout of one (b, h)'s chunk in a ring stage, in elements of the
// input type: q and k rows (pitch pk), v rows (pitch pv), i, f.
struct RowLayout {
  int pk, pv;          // row pitches, whole multiples of 128 bytes
  int off_k, off_v, off_i, off_f, item;
};

struct RowArgs {
  const void *q, *k, *v, *ig, *fg;
  const float *C0, *n0, *m0;
  void* h;
  float *C_out, *n_out, *m_out;
  int64_t n_items;         // B * H
  int T, L, dk, dv;
  int stages;              // ring depth, 2 or 3
  int warp_bytes;          // shared memory of one warp
  int ring_bytes;          // of which the ring
  int carry_state;         // C and n live in shared memory
  RowLayout lay;
};

template <typename T, int kRows, int kD>
__global__ void __launch_bounds__(kRowThreadsMax) mlstm_rows_kernel(
    const RowArgs p) {
  constexpr int G = 32 / kRows;  // (b, h) per warp
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kPieces = kD / kPer;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int r = lane % kRows, g = lane / kRows;
  const int L = p.L, dk = p.dk, dv = p.dv, T_len = p.T, S = p.stages;
  const RowLayout lay = p.lay;
  const int stage_elems = G * lay.item;
  unsigned char* mine = smem_raw + static_cast<size_t>(warp) * p.warp_bytes;
  T* ring = reinterpret_cast<T*>(mine);
  float* sC = reinterpret_cast<float*>(mine + p.ring_bytes) + g * dk * dv;
  float* sn = reinterpret_cast<float*>(mine + p.ring_bytes) + G * dk * dv
              + g * ((dk + 3) & ~3);
  float* sx = reinterpret_cast<float*>(
      mine + p.warp_bytes - G * kScratch * sizeof(float)) + g * kScratch;
  float* sb = sx;        // b_j of the chunk
  float* sw = sx + 32;   // i_j, then the update weights w_j
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* ig = static_cast<const T*>(p.ig);
  const T* fg = static_cast<const T*>(p.fg);
  T* h = static_cast<T*>(p.h);
  const int ck = dk / kPer, cv = dv / kPer, cg = L / kPer;
  const int64_t n_units = (p.n_items + G - 1) / G;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * n_warps + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * n_warps;
  const int NC = T_len / L;
  const bool want_state = p.C_out != nullptr;

  // This lane's first 16-byte piece of an L-row block of q (or k) and of
  // v, as (row, piece), and the step to its piece 32 pieces on, so that
  // the copy loops divide nothing.
  const int qk_row0 = lane / ck, qk_c0 = lane % ck;
  const int qk_drow = 32 / ck, qk_dc = 32 % ck;
  const int v_row0 = lane / cv, v_c0 = lane % cv;
  const int v_drow = 32 / cv, v_dc = 32 % cv;

  // The next work item to copy: chunk `ich` of unit `iu` into stage
  // `ist`.  Each call closes one cp.async group, a copy or none, so that
  // the groups and the work items stay in step.
  int64_t iu = first;
  int ich = 0, ist = 0;
  auto issue = [&]() {
    if (iu < n_units) {
      T* st = ring + ist * stage_elems;
      const int64_t t0 = static_cast<int64_t>(ich) * L;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int64_t item = iu * G + gi;
        if (item >= p.n_items) break;
        T* dst = st + gi * lay.item;
        const int64_t row0 = item * T_len + t0;
        const T* qb = q + row0 * dk;
        const T* kb = k + row0 * dk;
        const T* vb = v + row0 * dv;
        for (int row = qk_row0, c = qk_c0; row < L;) {
          const int src = row * dk + c * kPer;
          cp_async16(dst + row * lay.pk + swz(c, row) * kPer, qb + src);
          cp_async16(dst + lay.off_k + row * lay.pk + c * kPer, kb + src);
          row += qk_drow;
          c += qk_dc;
          if (c >= ck) {
            c -= ck;
            ++row;
          }
        }
        for (int row = v_row0, c = v_c0; row < L;) {
          cp_async16(dst + lay.off_v + row * lay.pv + c * kPer,
                     vb + row * dv + c * kPer);
          row += v_drow;
          c += v_dc;
          if (c >= cv) {
            c -= cv;
            ++row;
          }
        }
        if (lane < cg)
          cp_async16(dst + lay.off_i + lane * kPer, ig + row0 + lane * kPer);
        else if (lane < 2 * cg)
          cp_async16(dst + lay.off_f + (lane - cg) * kPer,
                     fg + row0 + (lane - cg) * kPer);
      }
      if (++ich == NC) {
        ich = 0;
        iu += stride;
      }
    }
    cp_async_commit();
    if (++ist == S) ist = 0;
  };

  for (int s = 0; s < S - 1; ++s) issue();
  int cur = 0;  // the stage of the work item being computed
  for (int64_t unit = first; unit < n_units; unit += stride) {
    const int64_t item = unit * G + g;
    const bool item_ok = item < p.n_items;
    // The starting state of this lane's (b, h).
    bool have_state = p.C0 != nullptr;  // C and n may be nonzero
    float m = have_state && item_ok ? p.m0[item] : -INFINITY;
    for (int ch = 0; ch < NC; ++ch) {
      cp_async_wait(S - 2);  // this lane's copies of the chunk landed
      __syncwarp();  // every lane's did; the previous chunk left its stage
      issue();       // into the stage the previous chunk used
      T* st_base = ring + cur * stage_elems;
      if (++cur == S) cur = 0;
      T* st = st_base + g * lay.item;
      const int64_t t0 = static_cast<int64_t>(ch) * L;
      const bool live = item_ok && r < L;
      if (ch == 0 && p.carry_state) {
        for (int e = r; e < dk * dv; e += kRows)
          sC[e] = have_state && item_ok ? p.C0[item * dk * dv + e] : 0.f;
        for (int d = r; d < dk; d += kRows)
          sn[d] = have_state && item_ok ? p.n0[item * dk + d] : 0.f;
      }

      // Gates: b_r = sum_{j <= r} log_sigmoid(f_j), summed in order.
      const float f_r = live ? to_f32(st[lay.off_f + r]) : 0.f;
      const float i_r = live ? to_f32(st[lay.off_i + r]) : 0.f;
      const float x_r = live ? log_sigmoid(f_r) : 0.f;
      float b_r = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float x_j = __shfl_sync(kFull, x_r, j, kRows);
        if (j <= r && j < L) b_r += x_j;
      }
      if (r < L) {
        sb[r] = b_r;
        sw[r] = i_r;
      }
      __syncwarp();  // also: C and n of a new (b, h) are in place

      const float log_a = b_r + m;
      float mx = log_a;
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (j <= r && j < L) mx = fmaxf(mx, b_r - sb[j] + sw[j]);
      const float m_i = fmaxf(mx, kFloor);

      float qr[kD];
#pragma unroll
      for (int c = 0; c < kPieces; ++c) {
        if (c < ck && live) {
          load16(st + r * lay.pk + swz(c, r) * kPer, qr + c * kPer);
        } else {
#pragma unroll
          for (int e = 0; e < kPer; ++e) qr[c * kPer + e] = 0.f;
        }
      }

      float acc[kD];
#pragma unroll
      for (int c = 0; c < kD; ++c) acc[c] = 0.f;
      float den = 0.f;
      if (have_state) {  // inter-chunk terms: inter_w * (q_i.C, q_i.n)
        const float inter_w = expf(log_a - m_i);
        float qn = 0.f;
        for (int d = 0; d < dk; ++d) {
          const float q_d = to_f32(st[r * lay.pk + swz(d / kPer, r) * kPer
                                      + d % kPer]);
          qn += q_d * sn[d];
          const float* row = sC + d * dv;
#pragma unroll
          for (int c = 0; c < kD / 4; ++c) {
            if (c * 4 < dv) {
              const float4 x = *reinterpret_cast<const float4*>(row + 4 * c);
              acc[4 * c] += q_d * x.x;
              acc[4 * c + 1] += q_d * x.y;
              acc[4 * c + 2] += q_d * x.z;
              acc[4 * c + 3] += q_d * x.w;
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kD; ++c) acc[c] *= inter_w;
        den = inter_w * qn;
      }

      // Intra-chunk terms: P_ij = e^{D_ij - m_i} (q_i.k_j), h_i += P_ij v_j.
      // k_j and v_j rows are broadcasts within a (b, h)'s lanes.
      const T* kj = st + lay.off_k;
      const T* vj = st + lay.off_v;
#pragma unroll 2
      for (int j = 0; j < L; ++j, kj += lay.pk, vj += lay.pv) {
        float x[kD];
#pragma unroll
        for (int c = 0; c < kPieces; ++c)
          if (c < ck) load16(kj + c * kPer, x + c * kPer);
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < kPieces; ++c)
          if (c < ck)
#pragma unroll
            for (int e = 0; e < kPer; ++e)
              s[e % 4] += qr[c * kPer + e] * x[c * kPer + e];
        const float qk = (s[0] + s[1]) + (s[2] + s[3]);
        const float pij =
            j <= r ? expf(b_r - sb[j] + sw[j] - m_i) * qk : 0.f;
        den += pij;
#pragma unroll
        for (int c = 0; c < kPieces; ++c)
          if (c < cv) load16(vj + c * kPer, x + c * kPer);
#pragma unroll
        for (int c = 0; c < kPieces; ++c)
          if (c < cv)
#pragma unroll
            for (int e = 0; e < kPer; ++e)
              acc[c * kPer + e] += pij * x[c * kPer + e];
      }
      const float inv_norm = 1.f / fmaxf(fabsf(den), expf(-m_i));

      // State update, when another chunk follows or the state is
      // returned.
      if (ch + 1 < NC || want_state) {
        const float g_ch = __shfl_sync(kFull, b_r, L - 1, kRows);
        const float w_r = live ? g_ch - b_r + i_r : -INFINITY;
        float w_max = w_r;
#pragma unroll
        for (int off = kRows / 2; off > 0; off >>= 1)
          w_max = fmaxf(w_max, __shfl_xor_sync(kFull, w_max, off, kRows));
        const float m_new = fmaxf(fmaxf(g_ch + m, w_max), kFloor);
        const float scale_old = expf(g_ch + m - m_new);
        __syncwarp();  // every lane is done reading sw as i_j
        if (r < L) sw[r] = live ? expf(w_r - m_new) : 0.f;
        __syncwarp();
        const T* sk = st + lay.off_k;
        const T* sv = st + lay.off_v;
        for (int d = r; d < dk; d += kRows) {
          float acc_n = scale_old * sn[d];
          for (int j = 0; j < L; ++j)
            acc_n += sw[j] * to_f32(sk[j * lay.pk + d]);
          sn[d] = acc_n;
        }
        for (int c = r; c < dv; c += kRows) {
          for (int d = 0; d < dk; ++d) {
            float acc_c = scale_old * sC[d * dv + c];
            for (int j = 0; j < L; ++j)
              acc_c += sw[j] * to_f32(sk[j * lay.pk + d])
                       * to_f32(sv[j * lay.pv + c]);
            sC[d * dv + c] = acc_c;
          }
        }
        m = m_new;
        have_state = true;
        __syncwarp();
        if (ch == NC - 1 && want_state && item_ok) {
          for (int e = r; e < dk * dv; e += kRows)
            p.C_out[item * dk * dv + e] = sC[e];
          for (int d = r; d < dk; d += kRows) p.n_out[item * dk + d] = sn[d];
          if (r == 0) p.m_out[item] = m;
        }
      }

      // h_i into row i of the stage's v (its pieces swizzled: each lane
      // writes its own row), then out in coalesced 16-byte pieces.
      __syncwarp();  // every lane is done reading v
      if (live) {
#pragma unroll
        for (int c = 0; c < kPieces; ++c) {
          if (c < cv) {
            float x[kPer];
#pragma unroll
            for (int e = 0; e < kPer; ++e) x[e] = acc[c * kPer + e] * inv_norm;
            store16(st + lay.off_v + r * lay.pv + swz(c, r) * kPer, x);
          }
        }
      }
      __syncwarp();
      for (int row = v_row0, c = v_c0; row < L;) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const int64_t it = unit * G + gi;
          if (it < p.n_items)
            *reinterpret_cast<uint4*>(h + ((it * T_len + t0 + row) * dv
                                           + c * kPer)) =
                *reinterpret_cast<const uint4*>(
                    st_base + gi * lay.item + lay.off_v + row * lay.pv
                    + swz(c, row) * kPer);
        }
        row += v_drow;
        c += v_dc;
        if (c >= cv) {
          c -= cv;
          ++row;
        }
      }
    }
  }
}

constexpr int kMaxSmem = 232448;  // shared memory a block may opt into

template <typename T, int kRows, int kD>
int launch_rows(RowArgs p, cudaStream_t stream) {
  constexpr int G = 32 / kRows;
  constexpr int kRowElems = 128 / static_cast<int>(sizeof(T));
  RowLayout& lay = p.lay;
  lay.pk = (p.dk + kRowElems - 1) / kRowElems * kRowElems;
  lay.pv = (p.dv + kRowElems - 1) / kRowElems * kRowElems;
  lay.off_k = p.L * lay.pk;
  lay.off_v = 2 * p.L * lay.pk;
  lay.off_i = lay.off_v + p.L * lay.pv;
  lay.off_f = lay.off_i + p.L;
  lay.item = lay.off_f + p.L;
  const int stage_bytes = G * lay.item * static_cast<int>(sizeof(T));
  const int state_bytes =
      p.carry_state ? G * (p.dk * p.dv + ((p.dk + 3) & ~3)) * 4 : 0;
  p.stages = stage_bytes >= 8192 ? 2 : 3;
  p.ring_bytes = p.stages * stage_bytes;
  p.warp_bytes = p.ring_bytes + state_bytes + G * kScratch * 4;
  int warps = kRowThreadsMax / 32;
  while (warps > 1 && warps * p.warp_bytes > kMaxSmem) warps /= 2;
  if (warps * p.warp_bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(warps) * p.warp_bytes;
  const auto kernel = mlstm_rows_kernel<T, kRows, kD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, warps * 32, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t n_units = (p.n_items + G - 1) / G;
  const int64_t wanted = (n_units + warps - 1) / warps;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const unsigned blocks =
      static_cast<unsigned>(wanted < resident ? wanted : resident);
  kernel<<<blocks, warps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows_for(const RowArgs& p, cudaStream_t s) {
  const bool narrow = p.dk <= 32 && p.dv <= 32;
  if (p.L <= 16)
    return narrow ? launch_rows<T, 16, 32>(p, s)
                  : launch_rows<T, 16, 64>(p, s);
  return narrow ? launch_rows<T, 32, 32>(p, s)
                : launch_rows<T, 32, 64>(p, s);
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

// The row kernel: the same arguments and return as
// mlstm_chunkwise_launch, for its envelope only: 1 <= L <= 32,
// dk, dv <= 64, L, dk and dv multiples of 16 bytes' worth of elements
// (4 float32, 8 bfloat16), every input 16-byte aligned (the wrapper
// checks); anything else returns cudaErrorInvalidValue.
extern "C" int mlstm_rows_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* C0, const void* n0, const void* m0, void* h,
    void* C_out, void* n_out, void* m_out, int64_t bh, int64_t t_len,
    int64_t L, int64_t dk, int64_t dv, int dtype, void* stream) {
  if (bh == 0) return 0;
  const int per = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || L < 1 || L > 32 || dk < 1 || dk > 64 ||
      dv < 1 || dv > 64 || t_len % L || L % per || dk % per || dv % per ||
      t_len > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  RowArgs p{};
  p.q = q; p.k = k; p.v = v; p.ig = ig; p.fg = fg;
  p.C0 = static_cast<const float*>(C0);
  p.n0 = static_cast<const float*>(n0);
  p.m0 = static_cast<const float*>(m0);
  p.h = h;
  p.C_out = static_cast<float*>(C_out);
  p.n_out = static_cast<float*>(n_out);
  p.m_out = static_cast<float*>(m_out);
  p.n_items = bh;
  p.T = static_cast<int>(t_len);
  p.L = static_cast<int>(L);
  p.dk = static_cast<int>(dk);
  p.dv = static_cast<int>(dv);
  p.carry_state = C0 != nullptr || C_out != nullptr || t_len > L;
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_rows_for<float>(p, s)
                    : launch_rows_for<__nv_bfloat16>(p, s);
}
