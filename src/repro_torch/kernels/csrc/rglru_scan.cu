// RG-LRU diagonal linear recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py:35
// _rglru_kernel (called through :53 rglru_scan) and computes what its
// oracle src/repro/kernels/ref.py:40 rglru_scan_ref computes: for every
// (batch, channel), h_t = a_t * h_{t-1} + b_t from h = 0, in float32,
// over the whole time axis.  a, b are (B, T, R), float32 or bfloat16,
// contiguous; h is written as (B, T, R) in float32 or bfloat16.  Any B,
// T and R.
//
// Bound: the scan must read a and b once and write h once.  At the
// serving path's shape (B = 1, T = 3072, R = 4096, float32 in, bfloat16
// out) that is 125.8 MB, 37.6 us at 3.35 TB/s; one multiply and one add
// per element is nothing beside it, so it is bound by bytes.  The
// chunked design below walked each time chunk twice; once the two input
// slabs outgrow L2 (100 MB at the serving shape, against 50 MB), its
// second walk reads device memory again, about 226 MB in all.
//
// Two kernels, one C entry point each; the wrapper
// (repro_torch/kernels/rglru_scan.py, takes_chunked_kernel) picks one by
// input size:
//
// The ring kernel (rglru_scan_launch; inputs over 24 MB): every byte
// once, and no time-axis reassociation.  A block owns 32 neighbouring
// channels of one batch row and streams its whole slab through shared
// memory in tiles of 64 steps, in a ring of 4 stages.  Warps are
// specialised: seven copier warps keep the next three tiles in flight
// with 16-byte cp.async copies (on Hopper a thread's cp.async issue
// stalls on the memory queue, so the copy rate grows with the number of
// copying threads) and write each walked tile of h out in 16-byte
// pieces, while warp 0 walks the current tile, one lane per channel,
// carrying h in a register from tile to tile and keeping the tile's h in
// shared memory.  The walk reads 16 steps of a and b ahead, then runs
// the oracle's own sequence of float32 operations, a multiply then an
// add (__fmul_rn, __fadd_rn, no FMA contraction), so h equals the
// sequential walk bit for bit.  One block per SM at the serving shape
// (128 blocks); rows that are not 16-byte multiples, or unaligned
// inputs, fill the same ring with element loads and write h by elements.
//
// The chunked kernel (rglru_chunked_launch; inputs up to 24 MB, so short
// prompts): a block owns 32 channels and cuts T into 16 chunks, one warp
// each, walks each chunk twice and chains the chunks' carries between
// the walks.  At these sizes its second walk finds a and b in the 50 MB
// L2, and its 16 time-parallel warps keep the latency of a short
// sequence low, where the ring kernel's single walking warp would set
// it.  Its carries are chained in another order than the sequential walk
// (float32 rounding, FMA contraction allowed).

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (repro_torch/_build.py)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 32;  // channels per block: the walking warp's lanes
constexpr int kWarps = 8;      // warp 0 walks, the others copy
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;      // time steps per ring stage
constexpr int kStages = 4;     // ring depth: kStages - 1 tiles in flight
constexpr int kBatch = 16;     // steps read ahead of the walk
constexpr int kChunks = 16;    // the chunked kernel's time chunks (warps)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// A volatile shared-memory load, as float.
__device__ __forceinline__ float lds(const float* p) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n"
               : "=f"(x)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return x;
}
__device__ __forceinline__ float lds(const __nv_bfloat16* p) {
  unsigned short x;
  asm volatile("ld.shared.u16 %0, [%1];\n"
               : "=h"(x)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return __bfloat162float(__ushort_as_bfloat16(x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage holds a tile of a then a tile of b: [2][kTile][kChannels].
constexpr int kStageElems = 2 * kTile * kChannels;

template <typename Tin, typename Tout, bool kVec>
__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const Tin* __restrict__ a, const Tin* __restrict__ b,
    Tout* __restrict__ h, int64_t T, int64_t R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tin* ring = reinterpret_cast<Tin*>(smem_raw);
  // h of the tile being walked and of the one being written out.
  Tout* out_tiles = reinterpret_cast<Tout*>(
      smem_raw + kStages * kStageElems * sizeof(Tin));
  const int tid = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kChannels;
  const int width =
      static_cast<int>(R - r0 < kChannels ? R - r0 : kChannels);
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * T;
  const int64_t n_tiles = (T + kTile - 1) / kTile;
  constexpr int kPerIn = 16 / sizeof(Tin);    // elements a 16-byte copy
  constexpr int kPerOut = 16 / sizeof(Tout);
  // 16-byte stores of h need whole 16-byte row segments.
  const bool vec_out = (R * static_cast<int64_t>(sizeof(Tout))) % 16 == 0;

  // Warp 0 walks; warps 1.. (the copiers) copy tiles in and write h out.
  const int ctid = tid - 32;
  constexpr int kCopiers = kThreads - 32;

  // A copier copies its part of tile `tile` (if there is one) into the
  // tile's stage and closes one cp.async group either way, so that its
  // group i is tile i.
  auto issue = [&](int64_t tile) {
    if (tile < n_tiles) {
      Tin* stage = ring + (tile % kStages) * kStageElems;
      const int64_t t0 = tile * kTile;
      const int rows = static_cast<int>(T - t0 < kTile ? T - t0 : kTile);
      if constexpr (kVec) {
        constexpr int kCopies = kChannels / kPerIn;   // copies a row
        const int live = width / kPerIn;  // width is a multiple of kPerIn
        for (int e = ctid; e < 2 * kTile * kCopies; e += kCopiers) {
          const int x = e / (kTile * kCopies);        // 0: a, 1: b
          const int row = (e / kCopies) % kTile;
          const int c = e % kCopies;
          if (row < rows && c < live)
            cp_async16(stage + (x * kTile + row) * kChannels + c * kPerIn,
                       (x ? b : a) + (row0 + t0 + row) * R + r0
                           + c * kPerIn);
        }
      } else {
        for (int e = ctid; e < 2 * kTile * kChannels; e += kCopiers) {
          const int x = e / (kTile * kChannels);
          const int row = (e / kChannels) % kTile;
          const int c = e % kChannels;
          if (row < rows && c < width)
            stage[(x * kTile + row) * kChannels + c] =
                (x ? b : a)[(row0 + t0 + row) * R + r0 + c];
        }
      }
    }
    cp_async_commit();
  };

  // Writes the walked tile `tile` from its output buffer to h, by the
  // threads from `first` on, in 16-byte pieces where rows allow.
  auto write_out = [&](int64_t tile, int first) {
    const Tout* src = out_tiles + (tile & 1) * kTile * kChannels;
    const int64_t t0 = tile * kTile;
    const int rows = static_cast<int>(T - t0 < kTile ? T - t0 : kTile);
    Tout* dst = h + (row0 + t0) * R + r0;
    if (vec_out) {
      constexpr int kPieces = kChannels / kPerOut;
      const int live = (width + kPerOut - 1) / kPerOut;
      for (int e = tid - first; e < rows * kPieces; e += kThreads - first) {
        const int row = e / kPieces, c = e % kPieces;
        if (c < live)
          *reinterpret_cast<uint4*>(dst + row * R + c * kPerOut) =
              *reinterpret_cast<const uint4*>(src + row * kChannels
                                              + c * kPerOut);
      }
    } else {
      for (int e = tid - first; e < rows * kChannels; e += kThreads - first) {
        const int row = e / kChannels, c = e % kChannels;
        if (c < width) dst[row * R + c] = src[row * kChannels + c];
      }
    }
  };

  if (tid >= 32)
    for (int s = 0; s < kStages - 1; ++s) issue(s);
  float state = 0.f;
  for (int64_t i = 0; i < n_tiles; ++i) {
    if (tid >= 32) cp_async_wait<kStages - 2>();  // its copies of tile i
    __syncthreads();  // every copier's landed; the walk of tile i-1 is done
    if (tid >= 32) {
      issue(i + kStages - 1);           // into the stage tile i-1 used
      if (i > 0) write_out(i - 1, 32);  // while warp 0 walks tile i
    } else {
      const Tin* sa = ring + (i % kStages) * kStageElems + tid;
      const Tin* sb = sa + kTile * kChannels;
      Tout* out = out_tiles + (i & 1) * kTile * kChannels + tid;
      const int64_t t0 = i * kTile;
      const int rows = static_cast<int>(T - t0 < kTile ? T - t0 : kTile);
      // kBatch steps' a and b are read (volatile, so that the compiler
      // keeps them ahead) before the walk over them: the dependent chain
      // is then the multiply and the add alone.
      int j = 0;
      for (; j + kBatch <= rows; j += kBatch) {
        float av[kBatch], bv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          av[u] = lds(sa + (j + u) * kChannels);
          bv[u] = lds(sb + (j + u) * kChannels);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
          store(out + (j + u) * kChannels, state);
        }
      }
      for (; j < rows; ++j) {
        state = __fadd_rn(__fmul_rn(lds(sa + j * kChannels), state),
                          lds(sb + j * kChannels));
        store(out + j * kChannels, state);
      }
    }
  }
  __syncthreads();
  write_out(n_tiles - 1, 0);
}

// The chunked kernel (for inputs that fit in L2): a block owns 32
// channels of one batch row and cuts T into kChunks chunks, one warp
// each.  Pass 1 walks each chunk from h = 0 for its product of a and its
// local end value; one warp chains the chunks' carries; pass 2 re-walks
// each chunk from its true carry and writes h.  The second walk reads a
// and b from L2.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kChannels * kChunks) rglru_chunked_kernel(
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
           int64_t R, bool chunked, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((R + kChannels - 1) / kChannels),
                  static_cast<unsigned>(B));
  if (chunked) {
    rglru_chunked_kernel<Tin, Tout><<<grid, dim3(kChannels, kChunks), 0,
                                      stream>>>(
        static_cast<const Tin*>(a), static_cast<const Tin*>(b),
        static_cast<Tout*>(h), T, R);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   (R * static_cast<int64_t>(sizeof(Tin))) % 16 == 0;
  const auto kernel = vec ? rglru_scan_kernel<Tin, Tout, true>
                          : rglru_scan_kernel<Tin, Tout, false>;
  constexpr size_t smem = kStages * kStageElems * sizeof(Tin)
                          + 2 * kTile * kChannels * sizeof(Tout);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Tin*>(a), static_cast<const Tin*>(b),
      static_cast<Tout*>(h), T, R);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* a, const void* b, void* h, int64_t B, int64_t T,
             int64_t R, int in_dtype, int out_dtype, bool chunked,
             void* stream) {
  if (B == 0 || T == 0 || R == 0) return 0;
  if (B > 65535 || (R + kChannels - 1) / kChannels > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(a, b, h, B, T, R, chunked, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(a, b, h, B, T, R, chunked, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(a, b, h, B, T, R, chunked, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, b, h, B, T, R, chunked,
                                                s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  Launches on `stream`; returns
// cudaGetLastError() of the launch (or cudaErrorInvalidValue for a
// shape the grid cannot hold).  rglru_scan_launch launches the ring
// kernel, rglru_chunked_launch the chunked kernel, at any size.
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h,
                                 int64_t B, int64_t T, int64_t R,
                                 int in_dtype, int out_dtype, void* stream) {
  return dispatch(a, b, h, B, T, R, in_dtype, out_dtype, false, stream);
}

extern "C" int rglru_chunked_launch(const void* a, const void* b, void* h,
                                    int64_t B, int64_t T, int64_t R,
                                    int in_dtype, int out_dtype,
                                    void* stream) {
  return dispatch(a, b, h, B, T, R, in_dtype, out_dtype, true, stream);
}
