// Chunk-parallel stabilised mLSTM cell on the tensor cores, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mlstm_chunkwise.py:31
// _mlstm_kernel (called through :85 mlstm_chunkwise) for bfloat16 calls
// with chunk length L = 64 and dk, dv multiples of 64 up to 384
// (xLSTM-125M's prefill), and computes what its oracle
// src/repro/models/xlstm.py:69 _mlstm_chunkwise computes; the sequential
// kernels of mlstm_chunkwise.cu take every other call.  Per (b, h) with
// chunks c = 0 .. NC-1, b = cumsum(log_sigmoid(f)) within a chunk,
// g_c = b_{L-1} and w_{c,j} = g_c - b_j + i_j, three kernels run in
// order:
//
// 1. mlstm_gate_kernel, a warp per (b, h, chunk): b, g_c, w_{c,j} and
//    max_j w_{c,j}, everything of the gates that does not depend on the
//    stabiliser of earlier chunks.
// 2. mlstm_state_kernel, one block (a warpgroup) per (b, h, 64 x 64 tile
//    of C), walks the chunks and keeps its tile of C (and, in the blocks
//    of the first column tile, its rows of n) in wgmma accumulator
//    registers.  Per chunk it takes the stabiliser step
//      m_c = max(g_c + m_{c-1}, max_j w_{c,j}), floored at -1e30,
//      a_c = exp(g_c + m_{c-1} - m_c)       (m_{-1} = -inf or the given m)
//    in the same order as the sequential kernel, writes the state that
//    enters chunk c (C_{c-1} to scratch as a pair of bfloat16 tiles
//    hi + lo, n_{c-1} and m_{c-1} in float32), and updates
//      C_c = a_c C_{c-1} + sum_j (exp(w_{c,j} - m_c) k_j) v_j^T
//    with the product on the tensor cores (k scaled in float32 and split
//    into hi + lo bfloat16, times v, into the float32 accumulators); n_c
//    likewise, as a product with a tile of ones.  The final C, n, m go
//    out in float32.
// 3. mlstm_output_kernel, one block (a warpgroup) per (b, h, chunk,
//    64-column tile of h): the chunk's 64 rows are the 64 rows of a wgmma.
//      S   = q k^T                               (wgmma, float32)
//      H   = q C_{c-1} = q C_hi + q C_lo          (wgmma)
//      m_i = max(b_i + m_{c-1}, max_{j<=i} b_i - b_j + i_j), floored
//      P   = exp(b_i - b_j + i_j - m_i) S on j <= i, else 0
//      den = exp(b_i + m_{c-1} - m_i) q.n_{c-1} + sum_j P   (float32)
//      h   = (exp(b_i + m_{c-1} - m_i) H + P_hi V + P_lo V)
//            / max(|den|, exp(-m_i))
//    q.n on the CUDA cores while the tensor cores run S and H.
//
// Numerics.  q, k and v are bfloat16 inputs and exact as wgmma operands;
// products of two bfloat16 values are exact in float32.  The three
// float32 operands of the products (k exp(w - m), C_{c-1} and P) go in as
// pairs of bfloat16 values hi + lo (hi = bf16(x), lo = bf16(x - hi)),
// which keep about 16 bits of x: one bfloat16 value each was not enough.
// h is a ratio whose numerator can cancel and whose denominator can sit
// near its floor exp(-m_i), which magnifies an operand's rounding: one
// bfloat16 value each moved h by up to 1.50 times MLSTM_TOL["bfloat16"]
// at xLSTM's shape (C alone 1.23, P alone 1.06), the pairs by 0.14 times
// (scripts/mlstm_parallel_rounding_torch.py).  The row sums of P, q.n,
// the gates and the stabiliser stay float32 on the CUDA cores (expf and
// log1pf, IEEE; no fast math).
//
// Bound: at xLSTM-125M's prefill (B*H = 4, T = 3072, dk = dv = 384,
// bfloat16, state out) the cell reads q, k, v and the gates once and
// writes h and the final state once: 40,163,344 B, 0.0120 ms at 3.35
// TB/s, against 7.79 G operations of the function (chip_smoke.py
// _mlstm_work), 0.0079 ms at 989 TFLOP/s of bf16 tensor-core work: bound
// by bytes.  The design moves more than that: the per-chunk states (two
// bfloat16 tiles a float, 113 MB at that shape) go out to scratch and
// back, q and k are read by each of a chunk's dv/64 output blocks (from
// L2), and the hi/lo pairs double the products on C and P.
//
// Design.  Of the sequential kernel's walk of NC chunks per (b, h) only
// the state kernel's walk is left, and it is a 64 x 64 x 64 product per
// chunk and tile (BH * (dk/64) * (dv/64) blocks, 144 at xLSTM's shape,
// all resident, two an SM at 85 KB); the next chunk's k, v and w tiles
// are copied by cp.async while the current one computes, and the state
// entering each chunk is staged in shared memory and written by bulk
// asynchronous copies (cp.async.bulk), so no thread waits on its stores.
// The output kernel has no walk at all: BH * NC * (dv/64) blocks (1,152
// at T 3072), each walking dk in 64-wide panels (q and k columns, C's hi
// and lo rows: 32 KB a panel, pre-swizzled by the state kernel so that
// C's are linear copies) through two cp.async stages into the
// 128-byte-swizzled layout that wgmma's descriptors name; 75 KB at dk 384,
// up to three blocks an SM.  S's accumulator is P's A fragment, as in
// flash_attention.cu, so P never goes to shared memory.  The state
// kernel's walk takes most of the time, bound by each chunk's per-thread
// work on its one warpgroup (scripts/mlstm_parallel_split_torch.py times
// each kernel alone; PERF.md section 6).  Measured slower on the card and
// not kept: a 3-stage k/v ring in the state kernel, 64 x 128 state tiles
// (72 blocks, one an SM), the gate work inside the walk, and an output
// kernel holding q, k and C whole (199 KB, one block an SM, its loads not
// overlapped with its products).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (repro_torch/_build.py)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;     // one warpgroup a block
constexpr int kL = 64;            // chunk length: the 64 rows of a wgmma
constexpr int kMaxD = 384;        // dk and dv: multiples of 64 up to this
constexpr float kFloor = -1e30f;  // stabiliser floor, as the oracle's
constexpr uint32_t kTileBytes = 64 * 128;  // 64 rows x 64 bfloat16

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// A 16-row step of a tile whose rows are the product's K dimension and
// whose 128-byte rows hold the M or N dimension (MN-major): rows
// 16 ks .. 16 ks + 15, in 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int ks) {
  return descriptor(tile + ks * 2048, kTileBytes, 1024);
}
// A 16-column step of a tile of 64 rows whose columns are the product's
// K dimension (K-major): 64-column blocks are 64 x 128 bytes apart, and a
// step moves 32 bytes within a block.
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int ks) {
  return descriptor(tile + (ks >> 2) * kTileBytes + (ks & 3) * 32, 16,
                    1024);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}
// x0, x1 as bfloat16 pairs: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

#define F8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),      \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 64, f32) = (scale_d ? D : 0) + A (64 x 16) B (16 x 64), both
// bf16 in shared memory; TA / TB 0 for K-major, 1 for MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers: the A fragment,
// which is the f32 accumulator layout packed in pairs) B (16 x 64, bf16
// in shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
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

#undef F8

// Rows 0..63 of a row-major bf16 matrix (row stride ld elements), columns
// 0 .. cols - 1 (a multiple of 64), into a swizzled tile of 64 rows.
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t ld, int cols) {
  const int chunks = cols / 8;
  for (int e = threadIdx.x; e < kL * chunks; e += kThreads) {
    const int r = e / chunks, c = e % chunks;
    cp_async16(dst + swizzled(kL, r, c), src + r * ld + c * 8);
  }
}

// `bytes` (a multiple of 16) copied as they are.
__device__ __forceinline__ void load_linear(uint32_t dst, const void* src,
                                            int bytes) {
  const char* s = static_cast<const char*>(src);
  for (int e = threadIdx.x * 16; e < bytes; e += kThreads * 16)
    cp_async16(dst + e, s + e);
}

// b = inclusive cumsum of log_sigmoid(f) over a chunk's 64 gates, for
// one warp: the lane holds j = lane (x0 -> b0) and j = lane + 32 (x1 ->
// b1).
__device__ __forceinline__ void chunk_prefix(float x0, float x1, int lane,
                                             float& b0, float& b1) {
  x0 = log_sigmoid(x0);
  x1 = log_sigmoid(x1);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y0 = __shfl_up_sync(0xffffffffu, x0, off);
    const float y1 = __shfl_up_sync(0xffffffffu, x1, off);
    if (lane >= off) {
      x0 += y0;
      x1 += y1;
    }
  }
  b0 = x0;
  b1 = x1 + __shfl_sync(0xffffffffu, x0, 31);
}

// Scratch: the state entering chunk c of (b, h), for the tile of columns
// 64 ev .. 64 ev + 63, is two bf16 tiles (hi, then lo) of dk rows x 128
// bytes, already in the swizzled layout of the output kernel's shared
// memory.
__device__ __forceinline__ int64_t scratch_tile(int64_t bh, int c, int ev,
                                                int n_chunks, int n_ev,
                                                int dk) {
  return ((bh * n_chunks + c) * n_ev + ev) * 2 * dk * 64;
}

// Bulk asynchronous copy of `bytes` (a multiple of 16) from shared memory
// to global memory (the async proxy: no registers, no per-thread stores),
// issued by one thread; wait_read<N> returns once all but the newest N
// groups have read their source, wait_done<0> once all have landed.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// D (64 x 8, f32) += A (64 x 16, bf16 in shared memory, MN-major) B
// (16 x 8): the state kernel's n update, with B a tile of ones, so any
// layout reads the same (a no-swizzle K-major descriptor).
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// The gate pass: one warp per (b, h, chunk), all at once.  The chunk's
// prefix b = cumsum(log_sigmoid(f)), g = b_{L-1} and w_j = g - b_j + i_j
// (float32, to gw[bh * T + t]), and (g, max_j w_j) to gm[bh * NC + c]:
// what the stabiliser scan needs of each chunk.
__global__ void __launch_bounds__(kThreads) mlstm_gate_kernel(
    const __nv_bfloat16* __restrict__ ig,
    const __nv_bfloat16* __restrict__ fg, float* __restrict__ gw,
    float2* __restrict__ gm, int64_t n_items) {
  const int64_t item = static_cast<int64_t>(blockIdx.x) * (kThreads / 32)
                       + threadIdx.x / 32;
  if (item >= n_items) return;
  const int lane = threadIdx.x % 32;
  const int64_t t0 = item * kL;  // (bh, c) -> bh * T + c * L
  float b0, b1;
  chunk_prefix(__bfloat162float(fg[t0 + lane]),
               __bfloat162float(fg[t0 + lane + 32]), lane, b0, b1);
  const float g = __shfl_sync(0xffffffffu, b1, 31);
  const float w0 = g - b0 + __bfloat162float(ig[t0 + lane]);
  const float w1 = g - b1 + __bfloat162float(ig[t0 + lane + 32]);
  gw[t0 + lane] = w0;
  gw[t0 + lane + 32] = w1;
  float wmax = fmaxf(w0, w1);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
  if (lane == 0) gm[item] = make_float2(g, wmax);
}

// ---------------------------------------------------------------------------
// The state pass.  Block (bh, kd, ev) owns rows 64 kd .. 64 kd + 63 and
// columns 64 ev .. 64 ev + 63 of C (and, when ev = 0, those rows of n).
// In the wgmma accumulator layout a thread (warp wp, lane) holds, of a
// 64 x N tile, rows 16 wp + lane / 4 (elements 4 b + 0, 1) and that + 8
// (elements 4 b + 2, 3), columns 8 b + 2 (lane % 4) + {0, 1}.  Per chunk
// the serial work is the stabiliser step (a max and an add on the gate
// pass's (g, max w)), the scaled-k split and the product: the next
// chunk's k, v and w are copied by cp.async meanwhile, and the state that
// enters the chunk goes out through a shared-memory staging tile by bulk
// copy.
__global__ void __launch_bounds__(kThreads) mlstm_state_kernel(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ gw, const float2* __restrict__ gm,
    const float* __restrict__ C0, const float* __restrict__ n0,
    const float* __restrict__ m0, __nv_bfloat16* __restrict__ Cs,
    float* __restrict__ ns, float* __restrict__ ms, float* __restrict__ C_out,
    float* __restrict__ n_out, float* __restrict__ m_out, int n_chunks,
    int dk, int dv) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  // Two stages of (k tile, v tile); the scaled k as hi and lo tiles; two
  // staging buffers of (hi, lo) tiles of C; 2 KB of ones; two stages of
  // the chunk's w.
  const uint32_t sStage = base;  // stage s: k at + 2 s kTileBytes, v after
  const uint32_t sKH = base + 4 * kTileBytes, sKL = sKH + kTileBytes;
  const uint32_t sStg = base + 6 * kTileBytes;  // buffer b at + 2 b tiles
  const uint32_t sOnes = base + 10 * kTileBytes;
  const uint32_t sW = sOnes + 2048;  // stage s at + s * kL * 4
  const float* w_st = reinterpret_cast<const float*>(gbase + (sW - base));

  const int n_kd = dk / 64, n_ev = dv / 64;
  const int64_t lin = blockIdx.x;
  const int ev = static_cast<int>(lin % n_ev);
  const int kd = static_cast<int>((lin / n_ev) % n_kd);
  const int64_t bh = lin / (static_cast<int64_t>(n_ev) * n_kd);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4, col = 2 * (lane % 4);
  const int64_t T = static_cast<int64_t>(n_chunks) * kL;
  const __nv_bfloat16* kp = k + bh * T * dk + 64 * kd;
  const __nv_bfloat16* vp = v + bh * T * dv + 64 * ev;
  const float* wp = gw + bh * T;
  const float2* gmp = gm + bh * n_chunks;
  const bool want_state = C_out != nullptr;
  const bool owns_n = ev == 0;              // blocks that carry n
  const bool owns_m = ev == 0 && kd == 0;   // the block that writes m

  float acc[32], accn[4];  // C's tile; n of the tile's rows (8 equal columns)
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = row0 + 8 * ((i >> 1) & 1), cc = 8 * (i >> 2) + col;
    float2 x = make_float2(0.f, 0.f);
    if (C0 != nullptr)
      x = *reinterpret_cast<const float2*>(
          C0 + (bh * dk + 64 * kd + r) * dv + 64 * ev + cc);
    acc[i] = x.x;
    acc[i + 1] = x.y;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    accn[i] = owns_n && n0 != nullptr
                  ? n0[bh * dk + 64 * kd + row0 + 8 * (i >> 1)] : 0.f;
  float m = m0 != nullptr ? m0[bh] : -INFINITY;
  if (owns_n)
    for (int e = tid * 16; e < 2048; e += kThreads * 16)
      *reinterpret_cast<uint4*>(gbase + 10 * kTileBytes + e) =
          make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);

  // Copies chunk t's k, v and w into stage st.
  auto load_chunk = [&](int t, int st) {
    const int64_t t1 = static_cast<int64_t>(t) * kL;
    load_rows(sStage + st * 2 * kTileBytes, kp + t1 * dk, dk, 64);
    load_rows(sStage + (st * 2 + 1) * kTileBytes, vp + t1 * dv, dv, 64);
    if (tid < kL / 4)
      cp_async16(sW + st * kL * 4 + tid * 16, wp + t1 + tid * 4);
  };
  load_chunk(0, 0);
  cp_async_commit();
  // The stabiliser step, m_c = max(g_c + m_{c-1}, max_j w_{c,j}) floored
  // and a_c = exp(g_c + m_{c-1} - m_c), in every thread alike.
  float2 gmc = gmp[0];
  float m_c = fmaxf(fmaxf(gmc.x + m, gmc.y), kFloor);
  float a_c = expf(gmc.x + m - m_c);
  if (n_chunks > 1) gmc = gmp[1];

  for (int c = 0; c < n_chunks; ++c) {
    const uint32_t sK = sStage + (c & 1) * 2 * kTileBytes;
    const uint32_t sV = sK + kTileBytes;
    const uint32_t sHi = sStg + (c & 1) * 2 * kTileBytes;
    const uint32_t sLo = sHi + kTileBytes;
    const float* w_c = w_st + (c & 1) * kL;
    const bool update = c + 1 < n_chunks || want_state;
    cp_async_wait_all();
    if (tid == 0) bulk_wait_read<1>();  // staging buffer c & 1 is free
    // Chunk c's tiles and weights are in shared memory, and every thread
    // is done with chunk c - 1 (whose stage the next copy refills).
    __syncthreads();
    if (c + 1 < n_chunks) {
      load_chunk(c + 1, (c + 1) & 1);
      cp_async_commit();
    }
    // The state entering chunk c: C's tile as hi and lo into the staging
    // buffer (the scratch's swizzled layout: row d's 16-byte piece p at
    // p ^ (d & 7)), n and m straight out.
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = row0 + 8 * ((i >> 1) & 1);
      const int cc = 8 * (i >> 2) + col;
      const uint32_t off =
          r * 128 + (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2;
      uint32_t h32, l32;
      split2(acc[i], acc[i + 1], h32, l32);
      *reinterpret_cast<uint32_t*>(gbase + (sHi - base) + off) = h32;
      *reinterpret_cast<uint32_t*>(gbase + (sLo - base) + off) = l32;
    }
    if (owns_n && lane % 4 == 0) {
      float* nrow = ns + (bh * n_chunks + c) * dk + 64 * kd + row0;
      nrow[0] = accn[0];
      nrow[8] = accn[2];
    }
    if (owns_m && tid == 0) ms[bh * n_chunks + c] = m;
    if (update) {
      // k_j exp(w_j - m_c) in float32, split into the hi and lo tiles.
      for (int e = tid; e < kL * 8; e += kThreads) {
        const int r = e / 8;
        const uint32_t off = swizzled(kL, r, e % 8);
        const float wr = expf(w_c[r] - m_c);
        const uint4 x =
            *reinterpret_cast<const uint4*>(gbase + (sK - base) + off);
        const __nv_bfloat162* x2 =
            reinterpret_cast<const __nv_bfloat162*>(&x);
        uint32_t h[4], l[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float2 f = __bfloat1622float2(x2[p]);
          split2(f.x * wr, f.y * wr, h[p], l[p]);
        }
        *reinterpret_cast<uint4*>(gbase + (sKH - base) + off) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(gbase + (sKL - base) + off) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      uint8_t* tile = reinterpret_cast<uint8_t*>(
          Cs + scratch_tile(bh, c, ev, n_chunks, n_ev, dk));
      bulk_store(tile + kd * kTileBytes, sHi, kTileBytes);
      bulk_store(tile + dk * 128 + kd * kTileBytes, sLo, kTileBytes);
      bulk_commit();
    }
    if (!update) break;

    // C = a C + (k exp(w - m))^T v and n = a n + (k exp(w - m))^T 1: A is
    // the scaled k tile read transposed (rows j are K), B the v tile.
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= a_c;
#pragma unroll
    for (int i = 0; i < 4; ++i) accn[i] *= a_c;
    pin(acc);
    pin(accn);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kL / 16; ++ks)
      wgmma_ss<1, 1>(acc, mn_major(sKH, ks), mn_major(sV, ks), 1);
#pragma unroll
    for (int ks = 0; ks < kL / 16; ++ks)
      wgmma_ss<1, 1>(acc, mn_major(sKL, ks), mn_major(sV, ks), 1);
    if (owns_n) {
      const uint64_t ones = descriptor(sOnes, 128, 256) & ~(3ull << 62);
#pragma unroll
      for (int ks = 0; ks < kL / 16; ++ks) {
        wgmma_n8(accn, mn_major(sKH, ks), ones);
        wgmma_n8(accn, mn_major(sKL, ks), ones);
      }
    }
    wgmma_commit();
    // Meanwhile the next chunk's stabiliser step.
    m = m_c;
    if (c + 1 < n_chunks) {
      m_c = fmaxf(fmaxf(gmc.x + m, gmc.y), kFloor);
      a_c = expf(gmc.x + m - m_c);
      if (c + 2 < n_chunks) gmc = gmp[c + 2];
    }
    wgmma_wait_all();
    pin(acc);
    pin(accn);
  }

  if (want_state) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = row0 + 8 * ((i >> 1) & 1), cc = 8 * (i >> 2) + col;
      *reinterpret_cast<float2*>(
          C_out + (bh * dk + 64 * kd + r) * dv + 64 * ev + cc) =
          make_float2(acc[i], acc[i + 1]);
    }
    if (owns_n && lane % 4 == 0) {
      n_out[bh * dk + 64 * kd + row0] = accn[0];
      n_out[bh * dk + 64 * kd + row0 + 8] = accn[2];
    }
    if (owns_m && tid == 0) m_out[bh] = m;
  }
  if (tid == 0) bulk_wait_done();
}

// ---------------------------------------------------------------------------
// The output pass.  Block (bh, c, ev): rows t = 64 c .. 64 c + 63 of h,
// columns 64 ev .. 64 ev + 63; a thread holds rows row0 and row0 + 8 of
// the accumulator layout above.  The products over dk walk it in panels
// of 64: each panel's q and k columns and C's hi and lo rows (32 KB) are
// copied by cp.async into one of two stages while the previous panel's
// products run, so a block holds 75 KB at dk 384 and up to three run on
// an SM.  DK = dk, so that the loops unroll.
template <int DK>
__global__ void __launch_bounds__(kThreads) mlstm_output_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ ig,
    const __nv_bfloat16* __restrict__ fg,
    const __nv_bfloat16* __restrict__ Cs, const float* __restrict__ ns,
    const float* __restrict__ ms, __nv_bfloat16* __restrict__ h,
    int n_chunks, int dv) {
  constexpr int dk = DK, n_panels = DK / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  // Stage s: q, k, C hi and C lo panels at base + 4 s kTileBytes.
  const uint32_t sV = base + 8 * kTileBytes;
  float* sn = reinterpret_cast<float*>(gbase + 9 * kTileBytes);
  float* sb = sn + dk;
  float* si = sb + kL;

  const int n_ev = dv / 64;
  const int64_t lin = blockIdx.x;
  const int ev = static_cast<int>(lin % n_ev);
  const int c = static_cast<int>((lin / n_ev) % n_chunks);
  const int64_t bh = lin / (static_cast<int64_t>(n_ev) * n_chunks);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4, col = 2 * (lane % 4);
  const int64_t T = static_cast<int64_t>(n_chunks) * kL;
  const int64_t t0 = static_cast<int64_t>(c) * kL;
  const __nv_bfloat16* qp = q + (bh * T + t0) * dk;
  const __nv_bfloat16* kp = k + (bh * T + t0) * dk;
  const uint8_t* tile = reinterpret_cast<const uint8_t*>(
      Cs + scratch_tile(bh, c, ev, n_chunks, n_ev, dk));
  auto load_panel = [&](int p) {
    const uint32_t st = base + (p & 1) * 4 * kTileBytes;
    load_rows(st, qp + 64 * p, dk, 64);
    load_rows(st + kTileBytes, kp + 64 * p, dk, 64);
    load_linear(st + 2 * kTileBytes, tile + p * kTileBytes, kTileBytes);
    load_linear(st + 3 * kTileBytes, tile + dk * 128 + p * kTileBytes,
                kTileBytes);
  };

  load_panel(0);
  load_rows(sV, v + (bh * T + t0) * dv + 64 * ev, dv, 64);
  load_linear(smem_addr(sn), ns + (bh * n_chunks + c) * dk, dk * 4);
  cp_async_commit();
  const float m_prev = ms[bh * n_chunks + c];
  if (warp == 0) {
    const __nv_bfloat16* fp = fg + bh * T + t0;
    const __nv_bfloat16* ip = ig + bh * T + t0;
    float b0, b1;
    chunk_prefix(__bfloat162float(fp[lane]), __bfloat162float(fp[lane + 32]),
                 lane, b0, b1);
    sb[lane] = b0;
    sb[lane + 32] = b1;
    si[lane] = __bfloat162float(ip[lane]);
    si[lane + 32] = __bfloat162float(ip[lane + 32]);
  }

  // S = q k^T and H = q C_hi + q C_lo, panel by panel; q . n_{c-1} in
  // float32 on the CUDA cores meanwhile (the four lanes of a row take
  // 16-byte pieces lane % 4 and lane % 4 + 4 of each panel).
  float s[32], acc[32], qn[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = acc[i] = 0.f;
#pragma unroll
  for (int p = 0; p < n_panels; ++p) {
    const uint32_t sQ = base + (p & 1) * 4 * kTileBytes;
    const uint32_t sK = sQ + kTileBytes, sCh = sK + kTileBytes;
    const uint32_t sCl = sCh + kTileBytes;
    cp_async_wait_all();
    fence_proxy_async();
    // Panel p is in shared memory, and every thread is done with panel
    // p - 1, whose stage the next copy refills.
    __syncthreads();
    if (p + 1 < n_panels) {
      load_panel(p + 1);
      cp_async_commit();
    }
    pin(s);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<0, 0>(s, k_major(sQ, ks), k_major(sK, ks), p > 0 || ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<0, 1>(acc, k_major(sQ, ks), mn_major(sCh, ks),
                     p > 0 || ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<0, 1>(acc, k_major(sQ, ks), mn_major(sCl, ks), 1);
    wgmma_commit();
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int cc = (lane & 3) + 4 * h8;
      const float4 na = *reinterpret_cast<const float4*>(sn + 64 * p + 8 * cc);
      const float4 nb =
          *reinterpret_cast<const float4*>(sn + 64 * p + 8 * cc + 4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint4 x = *reinterpret_cast<const uint4*>(
            gbase + (sQ - base) + swizzled(kL, row0 + 8 * r, cc));
        const __nv_bfloat162* x2 =
            reinterpret_cast<const __nv_bfloat162*>(&x);
        const float2 p0 = __bfloat1622float2(x2[0]);
        const float2 p1 = __bfloat1622float2(x2[1]);
        const float2 p2 = __bfloat1622float2(x2[2]);
        const float2 p3 = __bfloat1622float2(x2[3]);
        qn[r] += p0.x * na.x + p0.y * na.y + p1.x * na.z + p1.y * na.w
                 + p2.x * nb.x + p2.y * nb.y + p3.x * nb.z + p3.y * nb.w;
      }
    }
    wgmma_wait_all();
    pin(s);
    pin(acc);
  }

  float bi[2], log_a[2], mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], 1);
    qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], 2);
    bi[r] = sb[row0 + 8 * r];
    log_a[r] = bi[r] + m_prev;
    mx[r] = log_a[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1, j = 8 * (i >> 2) + col + (i & 1);
    if (j <= row0 + 8 * r) mx[r] = fmaxf(mx[r], bi[r] - sb[j] + si[j]);
  }
  float m_i[2], inter_w[2], den[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_i[r] = fmaxf(mx[r], kFloor);
    inter_w[r] = expf(log_a[r] - m_i[r]);
  }
  // P = exp(D - m_i) S on and below the diagonal; its row sums in float32.
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1, j = 8 * (i >> 2) + col + (i & 1);
    const float p = j <= row0 + 8 * r
                        ? expf(bi[r] - sb[j] + si[j] - m_i[r]) * s[i]
                        : 0.f;
    s[i] = p;
    den[r] += p;
  }
  float norm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
    den[r] = inter_w[r] * qn[r] + den[r];
    norm[r] = fmaxf(fabsf(den[r]), expf(-m_i[r]));
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= inter_w[(i >> 1) & 1];

  // acc += P_hi V + P_lo V: keys 16 ks .. 16 ks + 15 are accumulator
  // elements 8 ks .. 8 ks + 7, packed in pairs as A fragments.
  uint32_t phi[16], plo[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) split2(s[2 * i], s[2 * i + 1], phi[i], plo[i]);
  pin(acc);
  pin(phi);
  pin(plo);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kL / 16; ++ks) {
    const uint32_t a[4] = {phi[4 * ks], phi[4 * ks + 1], phi[4 * ks + 2],
                           phi[4 * ks + 3]};
    wgmma_rs(acc, a, mn_major(sV, ks));
  }
#pragma unroll
  for (int ks = 0; ks < kL / 16; ++ks) {
    const uint32_t a[4] = {plo[4 * ks], plo[4 * ks + 1], plo[4 * ks + 2],
                           plo[4 * ks + 3]};
    wgmma_rs(acc, a, mn_major(sV, ks));
  }
  wgmma_commit();
  wgmma_wait_all();
  pin(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* hrow = h + (bh * T + t0 + row0 + 8 * r) * dv + 64 * ev;
#pragma unroll
    for (int bc = 0; bc < 8; ++bc)
      *reinterpret_cast<__nv_bfloat162*>(hrow + 8 * bc + col) =
          __floats2bfloat162_rn(acc[4 * bc + 2 * r] / norm[r],
                                acc[4 * bc + 2 * r + 1] / norm[r]);
  }
}

int state_smem_bytes() { return 1024 + 10 * kTileBytes + 2048 + 2 * kL * 4; }
int output_smem_bytes(int dk) {
  return 1024 + 9 * kTileBytes + dk * 4 + 2 * kL * 4;
}

template <int DK>
cudaError_t launch_output(unsigned blocks, const void* q, const void* k,
                          const void* v, const void* ig, const void* fg,
                          const void* Cs, const void* ns, const void* ms,
                          void* h, int n_chunks, int dv, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const int bytes = output_smem_bytes(DK);
  const cudaError_t err = cudaFuncSetAttribute(
      mlstm_output_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  mlstm_output_kernel<DK><<<blocks, kThreads, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(ig),
      static_cast<const bf16*>(fg), static_cast<const bf16*>(Cs),
      static_cast<const float*>(ns), static_cast<const float*>(ms),
      static_cast<bf16*>(h), n_chunks, dv);
  return cudaGetLastError();
}

}  // namespace

// The chunk-parallel kernel, for bfloat16 q, k, v and gates with chunk
// length 64 (t_len a multiple of 64) and dk, dv multiples of 64 up to 384,
// every pointer 16-byte aligned (the wrapper checks); anything else
// returns cudaErrorInvalidValue.  The state pointers C0/n0/m0 are all
// null (start from m = -inf) or all set; C_out/n_out/m_out likewise (null:
// do not write the final state).  Scratch from the caller: Cs bf16 of
// bh * (t_len / 64) * (dv / 64) * 2 * dk * 64 elements, ns float32 of
// bh * (t_len / 64) * dk, ms float32 of bh * (t_len / 64), gs float32 of
// bh * t_len + 2 * bh * (t_len / 64).  Launches the gate, state and
// output kernels in that order on `stream`; returns cudaGetLastError()
// of the launches.
extern "C" int mlstm_parallel_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* C0, const void* n0, const void* m0, void* h,
    void* C_out, void* n_out, void* m_out, void* Cs, void* ns, void* ms,
    void* gs, int64_t bh, int64_t t_len, int64_t dk, int64_t dv,
    void* stream) {
  if (bh == 0) return 0;
  if (t_len < kL || t_len % kL || t_len > 2147483647LL || dk < 64 ||
      dk > kMaxD || dk % 64 || dv < 64 || dv > kMaxD || dv % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_chunks = t_len / kL;
  const int64_t state_blocks = bh * (dk / 64) * (dv / 64);
  const int64_t output_blocks = bh * n_chunks * (dv / 64);
  const int64_t gate_blocks = (bh * n_chunks + 3) / 4;
  if (state_blocks > 0x7fffffff || output_blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int s_bytes = state_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      s_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  float* gw = static_cast<float*>(gs);
  float2* gm = reinterpret_cast<float2*>(gw + bh * t_len);
  mlstm_gate_kernel<<<static_cast<unsigned>(gate_blocks), kThreads, 0, s>>>(
      static_cast<const bf16*>(ig), static_cast<const bf16*>(fg), gw, gm,
      bh * n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_state_kernel<<<static_cast<unsigned>(state_blocks), kThreads,
                       s_bytes, s>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), gw, gm,
      static_cast<const float*>(C0), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<bf16*>(Cs),
      static_cast<float*>(ns), static_cast<float*>(ms),
      static_cast<float*>(C_out), static_cast<float*>(n_out),
      static_cast<float*>(m_out), static_cast<int>(n_chunks),
      static_cast<int>(dk), static_cast<int>(dv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto blocks = static_cast<unsigned>(output_blocks);
  const int nc = static_cast<int>(n_chunks), w = static_cast<int>(dv);
  switch (dk) {
    case 64:
      return launch_output<64>(blocks, q, k, v, ig, fg, Cs, ns, ms, h, nc,
                               w, s);
    case 128:
      return launch_output<128>(blocks, q, k, v, ig, fg, Cs, ns, ms, h, nc,
                                w, s);
    case 192:
      return launch_output<192>(blocks, q, k, v, ig, fg, Cs, ns, ms, h, nc,
                                w, s);
    case 256:
      return launch_output<256>(blocks, q, k, v, ig, fg, Cs, ns, ms, h, nc,
                                w, s);
    case 320:
      return launch_output<320>(blocks, q, k, v, ig, fg, Cs, ns, ms, h, nc,
                                w, s);
    default:
      return launch_output<384>(blocks, q, k, v, ig, fg, Cs, ns, ms, h, nc,
                                w, s);
  }
}
