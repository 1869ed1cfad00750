// Masked argmin for the many-world lane engine, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/manyworld/select.py:65
// _pallas_argmin_kernel (called through :81 _pallas_call and
// :101 _pallas_argmin).  For each lane row of scores (L, N) float64 and
// mask (L, N) one byte per entry, it writes the FIRST index of the minimum
// of where(mask, scores, +inf) as int32 (L,).  A row whose minimum is +inf
// (every entry masked, or every unmasked score +inf) gives 0, as the
// Pallas kernel does.  -0.0 and +0.0 compare equal, so their tie goes to
// the lower index.  NaN scores are not supported (the lane scores are
// always finite).
//
// Bound: the kernel reads 9 bytes per entry and writes 4 per lane,
// 9*L*N + 4*L bytes; at the main path's L=2048, N=64 that is 1.18 MB,
// about 0.35 us at 3.35 TB/s, so at those shapes a launch costs more than
// the traffic.  Design: one warp per lane, so a row needs no
// inter-block step; threads walk the row with a stride of 32, so
// neighbouring threads read neighbouring addresses; each keeps the first
// strict minimum it sees, and a __shfl_down_sync reduction, lexicographic
// on (value, index), picks the row's first minimum.  The kernel does no
// arithmetic on the scores, so FMA contraction cannot change a result.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (repro_torch/manyworld/_build.py)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

__global__ void masked_argmin_kernel(const double* __restrict__ scores,
                                     const uint8_t* __restrict__ mask,
                                     int32_t* __restrict__ out,
                                     int64_t n_lanes, int64_t n) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock
                      + threadIdx.x / kWarp;
  const int t = threadIdx.x % kWarp;
  if (row >= n_lanes) return;  // uniform across the warp
  const double* s = scores + row * n;
  const uint8_t* m = mask + row * n;

  // A thread starts from its first entry, so an all-+inf row still yields
  // its lowest index; threads past the row's end hold (+inf, INT32_MAX).
  double best = __longlong_as_double(0x7ff0000000000000LL);  // +inf
  int32_t best_i = INT32_MAX;
  for (int64_t j = t; j < n; j += kWarp) {
    const double v = m[j] ? s[j] : __longlong_as_double(0x7ff0000000000000LL);
    if (best_i == INT32_MAX || v < best) {
      best = v;
      best_i = static_cast<int32_t>(j);
    }
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const double ov = __shfl_down_sync(0xffffffffu, best, off);
    const int32_t oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (ov < best || (ov == best && oi < best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  if (t == 0) out[row] = best_i;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int masked_argmin_launch(const void* scores, const void* mask,
                                    void* out, int64_t n_lanes, int64_t n,
                                    void* stream) {
  if (n_lanes == 0) return 0;
  const int64_t blocks = (n_lanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  masked_argmin_kernel<<<static_cast<unsigned>(blocks),
                         kWarpsPerBlock * kWarp, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(scores), static_cast<const uint8_t*>(mask),
      static_cast<int32_t*>(out), n_lanes, n);
  return static_cast<int>(cudaGetLastError());
}
