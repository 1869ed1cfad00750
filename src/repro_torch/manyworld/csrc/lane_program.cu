// The many-world lane program as one persistent kernel, for Hopper (sm_90a).
//
// Replaces the TPU program src/repro/manyworld/lanes.py:196 run (built by
// :186 _program_factory: the three lax.while_loops at :253, :324, :391)
// together with its select kernel src/repro/manyworld/select.py:65
// _pallas_argmin_kernel (through :81 _pallas_call, :101 _pallas_argmin).
// The JAX program advances every lane in lockstep because XLA has no
// per-lane control flow; lanes are independent, so here ONE WARP RUNS ONE
// LANE'S WHOLE CYCLE LOOP, k = 0 .. max_cycles, for as long as the lane is
// active, with the three phases of each cycle in the reference's order:
//   1. completions in (done_t, bind_seq) order, each followed by the
//      _done() check at the completion's time;
//   2. the FIFO wave: for each arrived, unbound row in row order, the
//      feasibility mask, the scheduler's score (negated for max-mode), the
//      first masked argmin (the select kernel's lexicographic
//      (value, index) __shfl_down_sync reduction, inlined) and the bind;
//   3. the done, stuck and quiescent checks.
// The outputs are bit-identical to the lockstep program
// (repro_torch/manyworld/lanes.py run_lane_batch_lockstep) and to the JAX
// program.  n_cycles, the lockstep loop's count, is the largest number of
// cycles any lane ran (lane_stats[:, 0]; the host takes the max).
//
// What bounds it: not bytes (the batch in and out is ~1e8 B, ~0.03 ms at
// 3.35 TB/s) but the longest lane's chain of dependent steps: every bind
// changes the node columns the next select reads, every completion the
// state the next one reads.  So the design keeps each step short:
// * node columns (used_cpu, used_mem, pcount) live in shared memory, one
//   region per warp; a select over n_pad 64 nodes is two entries a thread
//   and a 5-step shuffle reduction;
// * exact per-lane counters replace the O(P) scans of the lockstep
//   program: the latest valid arrival (all arrived by td <=> max_arr <=
//   td), the uncommitted batch rows, the unbound service rows, the running
//   batch pods; pending_after is blocked > 0 (every row pending at the
//   wave's start is attempted, and ends bound or blocked);
// * the running batch pods sit in a per-lane list (scratch, swap-removed);
//   a completion step is a warp reduction over it, lexicographic on
//   (done_t, bind_seq);
// * the wave walks rows from `lo`, the first valid unbound row (rows
//   before it never become candidates again), 32 at a time with a ballot;
//   when the lane's valid rows are a prefix with non-decreasing arrivals,
//   it stops at the first chunk holding a row not yet arrived.
// Each lane's scalars are kept, identical, in all 32 threads; lane 0 of
// the warp writes the state and __syncwarp() orders it before the next
// read.  No step waits on the host: one launch runs the whole batch.
//
// Float discipline: the score formulas use __dmul_rn / __dadd_rn /
// __dsub_rn, which nvcc never contracts into a fused multiply-add, and
// IEEE division, in the eager program's operation order; the results equal
// NumPy's, XLA's and eager PyTorch's bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (repro_torch/_build.py)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxNodes = 8192;          // node columns of one lane: 160 KB
constexpr int kBytesPerNode = 8 + 8 + 4; // used_cpu, used_mem, pcount

enum Sched { kBestFit = 0, kWorstFit, kFirstFit, kK8sDefault, kWeighted };

// Pointer table, in the order of lane_kernel.py's _ARGS.
struct Args {
  const double* arrival_t;      // (L, P)
  const double* cpu_m;          // (L, P)
  const double* mem_mb;         // (L, P)
  const double* duration_s;     // (L, P)
  const uint8_t* is_batch;      // (L, P)
  const uint8_t* valid;         // (L, P)
  const int32_t* n_nodes;       // (L,)
  const double* alloc_cpu;      // (L,)
  const double* alloc_mem;      // (L,)
  const double* weights;        // (L, 3)
  uint8_t* bound;               // (L, P)
  uint8_t* done_committed;      // (L, P)
  int32_t* bind_node;           // (L, P)
  int32_t* bind_seq;            // (L, P)
  int32_t* bind_cycle;          // (L, P)
  double* done_t;               // (L, P)
  uint8_t* completed;           // (L,)
  double* done_time;            // (L,)
  uint8_t* done_is_cycle;       // (L,)
  int32_t* scale_outs;          // (L,)
  double* used_cpu;             // (L, n_pad)
  double* used_mem;             // (L, n_pad)
  int32_t* pcount;              // (L, n_pad)
  int64_t* lane_stats;          // (L, 3): cycles, completions, attempts
  int32_t* running;             // (L, P) scratch: the running batch pods
};
constexpr int kNumArgs = 25;
static_assert(sizeof(Args) == kNumArgs * sizeof(void*), "pointer table");

__device__ __forceinline__ double inf() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// lanes.py _wave_scores for one node, operation by operation.
__device__ __forceinline__ double wave_score(int sched, double fc, double fm,
                                             double pc, double pm,
                                             double den_cpu, double den_mem,
                                             double w0, double w1,
                                             double w2) {
  if (sched == kBestFit) return fm;
  if (sched == kWorstFit) return -fm;
  if (sched == kFirstFit) return 0.0;
  const double cpu_frac = __dsub_rn(fc, pc) / den_cpu;
  const double mem_frac = __dsub_rn(fm, pm) / den_mem;
  const double lr = __dmul_rn(10.0, __dadd_rn(cpu_frac, mem_frac)) / 2.0;
  const double bal =
      __dmul_rn(10.0, __dsub_rn(1.0, fabs(__dsub_rn(cpu_frac, mem_frac))));
  if (sched == kK8sDefault) return -(__dadd_rn(lr, bal) / 2.0);
  const double pack = __dmul_rn(10.0, __dsub_rn(1.0, mem_frac));
  const double s = __dadd_rn(__dadd_rn(__dmul_rn(w0, pack), __dmul_rn(w1, lr)),
                             __dmul_rn(w2, bal));
  return -s;
}

// Lexicographic (value, index) minimum across the warp; every thread gets
// the winner.  Threads holding nothing carry (+inf, INT32_MAX).
__device__ __forceinline__ void warp_argmin(double& v, int32_t& i) {
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const double ov = __shfl_down_sync(kFull, v, off);
    const int32_t oi = __shfl_down_sync(kFull, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  v = __shfl_sync(kFull, v, 0);
  i = __shfl_sync(kFull, i, 0);
}

__global__ void lane_program_kernel(Args a, int64_t n_lanes, int64_t P,
                                    int n_pad, int sched, int max_cycles,
                                    double period, double horizon) {
  extern __shared__ double smem[];
  const int warps = blockDim.x / kWarp;
  const int w = threadIdx.x / kWarp;
  const int t = threadIdx.x % kWarp;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * warps + w;
  if (lane >= n_lanes) return;  // uniform across the warp

  double* ucpu = smem + static_cast<int64_t>(w) * n_pad;
  double* umem = smem + static_cast<int64_t>(warps + w) * n_pad;
  int32_t* pcnt = reinterpret_cast<int32_t*>(smem + 2LL * warps * n_pad)
                  + static_cast<int64_t>(w) * n_pad;

  const int64_t row0 = lane * P;
  const double* arr = a.arrival_t + row0;
  const double* cpu = a.cpu_m + row0;
  const double* mem = a.mem_mb + row0;
  const double* dur = a.duration_s + row0;
  const uint8_t* isb = a.is_batch + row0;
  const uint8_t* valid = a.valid + row0;
  uint8_t* bound = a.bound + row0;
  uint8_t* done_c = a.done_committed + row0;
  int32_t* bind_node = a.bind_node + row0;
  int32_t* bind_seq = a.bind_seq + row0;
  int32_t* bind_cycle = a.bind_cycle + row0;
  double* done_t = a.done_t + row0;
  int32_t* running = a.running + row0;

  const double ac = a.alloc_cpu[lane];
  const double am = a.alloc_mem[lane];
  const double den_cpu = ac < 1.0 ? 1.0 : ac;      // torch.clamp_min
  const double den_mem = am < 1e-9 ? 1e-9 : am;
  const double w0 = a.weights[lane * 3 + 0];
  const double w1 = a.weights[lane * 3 + 1];
  const double w2 = a.weights[lane * 3 + 2];
  const int nn = min(static_cast<int>(a.n_nodes[lane]), n_pad);

  // -- initial state and the lane's constants --------------------------
  int n_valid = 0, n_batch = 0;
  double max_arr = -inf();
  int64_t last_valid = -1;
  bool unsorted = false;
  for (int64_t base = 0; base < P; base += kWarp) {
    const int64_t j = base + t;
    const bool in = j < P;
    bool v = false, b = false;
    if (in) {
      bound[j] = 0;
      done_c[j] = 0;
      bind_node[j] = -1;
      bind_seq[j] = -1;
      bind_cycle[j] = -1;
      done_t[j] = inf();
      v = valid[j] != 0;
      b = isb[j] != 0;
      if (v) {
        const double x = arr[j];
        max_arr = (x > max_arr || x != x) ? x : max_arr;   // NaN sticks
        last_valid = j;
        // Valid rows must be a prefix with non-decreasing arrivals for
        // the wave's early stop (NaN counts as out of order).
        if (j > 0 && !(valid[j - 1] && arr[j - 1] <= x)) unsorted = true;
      }
    }
    n_valid += __popc(__ballot_sync(kFull, v));
    n_batch += __popc(__ballot_sync(kFull, v && b));
  }
  for (int j = t; j < n_pad; j += kWarp) {
    ucpu[j] = 0.0;
    umem[j] = 0.0;
    pcnt[j] = 0;
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const double om = __shfl_down_sync(kFull, max_arr, off);
    const int64_t ol = __shfl_down_sync(kFull, last_valid, off);
    max_arr = (om > max_arr || om != om) ? om : max_arr;
    last_valid = ol > last_valid ? ol : last_valid;
  }
  max_arr = __shfl_sync(kFull, max_arr, 0);
  const int64_t hi = __shfl_sync(kFull, last_valid, 0) + 1;
  const bool sorted = !__any_sync(kFull, unsorted);
  __syncwarp();

  int n_unc = n_batch;                // valid batch rows not committed
  int n_svc = n_valid - n_batch;      // valid service rows not bound
  int n_run = 0;                      // batch pods bound, not committed
  int32_t seq = 0, scale_outs = 0;
  bool active = n_valid > 0, completed = false, is_cycle = false;
  double done_time = horizon;
  int64_t lo = 0, commits = 0, attempts = 0;
  int k = 0;
  int cycles = 0;

  while (active && k <= max_cycles) {
    cycles = k + 1;
    const double tt = __dmul_rn(static_cast<double>(k), period);

    // -- 1. completions: the running pod with the least (done_t,
    // bind_seq), while its time is <= tt.
    while (n_run > 0) {
      double bv = inf();
      int32_t bs = INT32_MAX;
      int32_t bi = -1, bp = -1;
      for (int i = t; i < n_run; i += kWarp) {
        const int32_t p = running[i];
        const double d = done_t[p];
        const int32_t s = bind_seq[p];
        if (d < bv || (d == bv && s < bs)) {
          bv = d;
          bs = s;
          bi = i;
          bp = p;
        }
      }
      for (int off = kWarp / 2; off > 0; off /= 2) {
        const double ov = __shfl_down_sync(kFull, bv, off);
        const int32_t os = __shfl_down_sync(kFull, bs, off);
        const int32_t oi = __shfl_down_sync(kFull, bi, off);
        const int32_t op = __shfl_down_sync(kFull, bp, off);
        if (ov < bv || (ov == bv && os < bs)) {
          bv = ov;
          bs = os;
          bi = oi;
          bp = op;
        }
      }
      bv = __shfl_sync(kFull, bv, 0);
      bi = __shfl_sync(kFull, bi, 0);
      const int32_t p = __shfl_sync(kFull, bp, 0);
      if (!(bv <= tt)) break;
      if (t == 0) {
        const int32_t node = bind_node[p];
        ucpu[node] = __dadd_rn(ucpu[node], -cpu[p]);
        umem[node] = __dadd_rn(umem[node], -mem[p]);
        pcnt[node] -= 1;
        done_c[p] = 1;
        running[bi] = running[n_run - 1];
      }
      __syncwarp();
      n_run -= 1;
      n_unc -= 1;
      commits += 1;
      // _done() after this POD_DONE: all arrived by its time, every batch
      // row committed, every service bound.
      if (max_arr <= bv && n_unc == 0 && n_svc == 0) {
        completed = true;
        done_time = bv;
        active = false;
        break;
      }
    }
    if (!active) break;

    // -- 2. the wave: rows arrived by tt and unbound, in row order.
    int placed = 0, blocked = 0;
    for (int64_t base = lo & ~static_cast<int64_t>(kWarp - 1); base < hi;
         base += kWarp) {
      const int64_t j = base + t;
      bool cand = false, late = false;
      if (j >= lo && j < hi && valid[j]) {
        const bool arrived = arr[j] <= tt;
        cand = arrived && !bound[j];
        late = !arrived;
      }
      unsigned bits = __ballot_sync(kFull, cand);
      const bool stop = sorted && __any_sync(kFull, late);
      while (bits) {
        const int64_t p = base + __ffs(bits) - 1;
        bits &= bits - 1;
        attempts += 1;
        const double pc = cpu[p];
        const double pm = mem[p];
        double best = inf();
        int32_t best_i = INT32_MAX;
        bool feas = false;
        for (int n = t; n < nn; n += kWarp) {
          const double fc = __dsub_rn(ac, ucpu[n]);
          const double fm = __dsub_rn(am, umem[n]);
          const bool ok = fc >= pc && __dadd_rn(fm, 1e-9) >= pm;
          feas |= ok;
          const double v = ok ? wave_score(sched, fc, fm, pc, pm, den_cpu,
                                           den_mem, w0, w1, w2)
                              : inf();
          if (best_i == INT32_MAX || v < best) {
            best = v;
            best_i = n;
          }
        }
        warp_argmin(best, best_i);
        if (__any_sync(kFull, feas)) {
          if (t == 0) {
            const int32_t r = best_i;
            ucpu[r] = __dadd_rn(ucpu[r], pc);
            umem[r] = __dadd_rn(umem[r], pm);
            pcnt[r] += 1;
            bound[p] = 1;
            bind_node[p] = r;
            bind_seq[p] = seq;
            bind_cycle[p] = k;
            if (isb[p]) {
              done_t[p] = __dadd_rn(tt, dur[p]);
              running[n_run] = static_cast<int32_t>(p);
            }
          }
          if (isb[p]) {
            n_run += 1;
          } else {
            n_svc -= 1;
          }
          seq += 1;
          placed += 1;
        } else {
          blocked += 1;
        }
        __syncwarp();
      }
      if (stop) break;
    }
    scale_outs += blocked;

    // -- 3. post-cycle checks (serial order: done, stuck, quiescent).
    const bool all_arrived = max_arr <= tt;
    const bool pending_after = blocked > 0;
    const bool running_batch = n_run > 0;
    if (all_arrived && n_unc == 0 && n_svc == 0) {
      completed = true;
      done_time = tt;
      is_cycle = true;
      active = false;
    } else if (all_arrived && placed == 0 && blocked > 0 && !running_batch
               && pending_after) {
      active = false;                              // permanently stuck
    } else if (all_arrived && !pending_after && !running_batch) {
      active = false;                              // quiescent
    }
    // Advance lo to the first valid unbound row.
    while (lo < hi) {
      const int64_t base = lo & ~static_cast<int64_t>(kWarp - 1);
      const int64_t j = base + t;
      const bool open = j >= lo && j < hi && valid[j] && !bound[j];
      const unsigned b = __ballot_sync(kFull, open);
      if (b) {
        lo = base + __ffs(b) - 1;
        break;
      }
      lo = base + kWarp;
    }
    k += 1;
  }

  // -- write back ------------------------------------------------------
  const int64_t node0 = lane * n_pad;
  for (int j = t; j < n_pad; j += kWarp) {
    a.used_cpu[node0 + j] = ucpu[j];
    a.used_mem[node0 + j] = umem[j];
    a.pcount[node0 + j] = pcnt[j];
  }
  if (t == 0) {
    a.completed[lane] = completed;
    a.done_time[lane] = done_time;
    a.done_is_cycle[lane] = is_cycle;
    a.scale_outs[lane] = scale_outs;
    a.lane_stats[lane * 3 + 0] = cycles;
    a.lane_stats[lane * 3 + 1] = commits;
    a.lane_stats[lane * 3 + 2] = attempts;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int lane_program_launch(const void* const* ptrs, int64_t n_lanes,
                                   int64_t P, int64_t n_pad, int sched,
                                   int max_cycles, double period,
                                   double horizon, void* stream) {
  if (n_lanes == 0) return 0;
  if (n_pad < 1 || n_pad > kMaxNodes || P < 0 || P > INT32_MAX
      || sched < kBestFit || sched > kWeighted)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  const void** slots = reinterpret_cast<const void**>(&args);
  for (int i = 0; i < kNumArgs; ++i) slots[i] = ptrs[i];
  const int64_t per_warp = n_pad * kBytesPerNode;
  int warps = static_cast<int>((48 * 1024) / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarpsPerBlock ? kMaxWarpsPerBlock
                                                     : warps);
  const size_t smem = static_cast<size_t>(per_warp) * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lane_program_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = (n_lanes + warps - 1) / warps;
  lane_program_kernel<<<static_cast<unsigned>(blocks), warps * kWarp, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      args, n_lanes, P, static_cast<int>(n_pad), sched, max_cycles, period,
      horizon);
  return static_cast<int>(cudaGetLastError());
}
