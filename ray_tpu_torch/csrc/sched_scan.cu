// Batched lease scheduling scan (the cuda_batched backend) for Hopper,
// CUDA C++.
//
// Replaces ray_tpu/_private/scheduler/tpu_batched.py:_compiled_kernel
// (line 124), which in the reference is one XLA program (a gather of the
// slot-ordered request rows by perm, then a lax.scan over tasks), not a
// Pallas kernel. It computes the same function: for each scan position t
// in arrival order, over every node n, feasibility (totals + 1e-9 >= d),
// readiness (avail + 1e-9 >= d), the fixed-point utilisation
// ceil(((totals - avail) + d) * (1 / totals) * 2^20) clipped to
// [0, UTIL_MAX] and maxed over resources, the (hi, lo) key of
// scheduling/scoring.py, the lexicographic minimum over ready nodes, the
// hybrid rule (the local node wins while its utilisation is under the
// spread threshold), the frontier gate (a local grant waits for its
// dependencies), and then the chosen node's availability loses d, so
// each task sees the grants before it. local_idx is argmax(is_local):
// node 0 when no node is local, as in the reference.
//
// Rounding: every fp32 operation is written with an explicitly rounded
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), so no FMA
// contraction under the shared -fmad=true flags can move a bit, and the
// decisions equal the reference's XLA scan (and the port's scan_reference)
// exactly. Locality is int32 and shifted arithmetically, as jnp does.
//
// Design: one thread block; thread i owns nodes i, i + blockDim, ... and
// keeps their running availability and 1 / totals in two scratch arrays
// that only it reads and writes, so no synchronisation guards them. Per
// task every thread reads the task's demand row (one address across the
// block, an L1 broadcast) and its nodes' locality (coalesced), scores its
// nodes, and the block reduces any-feasible, any-ready and the minimum
// key (hi, lo packed into 64 bits; the low 15 bits of lo are the node
// index) with warp shuffles, then across warps through shared memory
// double-buffered by task, so one __syncthreads per task suffices.
// Invalid (padding) positions are WAIT and take nothing, as in the
// reference; they cost no synchronisation.
//
// Bound on the H100: the scan reads each valid task's locality row
// (n_bucket int32) and demand row once, ~105 MB for 100,000 tasks over
// 256 nodes, ~0.03 ms at 3.35 TB/s; its fp32 work (~5 operations per
// task, node and resource) is ~0.015 ms at 67 TFLOP/s. This simple
// design is far from that: the scan is sequential over tasks, so one
// block on one SM walks them in order, and each task costs a dependent
// global read (perm, then the rows) and a block-wide reduction.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWait = -1;
constexpr int kInfeasible = -2;
constexpr float kUtilScale = 1048576.0f;    // 2^20, scoring.UTIL_SCALE
constexpr float kUtilMax = 2097151.0f;      // 2^21 - 1, scoring.UTIL_MAX
constexpr int kLocMax = (1 << 20) - 1;      // scoring.LOC_MAX
constexpr int kHiLocShift = 11;             // scoring.HI_LOC_SHIFT
constexpr int kLoLocMask = (1 << 11) - 1;   // scoring.LO_LOC_MASK
constexpr int kNodeBits = 15;               // scoring.NODE_MAX = 2^15 - 1
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned long long kNotReady = ~0ull;
// float32(1e-9): the reference's weakly typed 1e-9 on fp32 arrays
constexpr float kEps = 0x1.12e0bep-30f;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, offset);
    v = o < v ? o : v;
  }
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
sched_scan_kernel(const float* __restrict__ demands,
                  const int* __restrict__ locality,
                  const bool* __restrict__ dep_ready,
                  const int* __restrict__ perm,
                  const float* __restrict__ totals,
                  const float* __restrict__ avail0,
                  const bool* __restrict__ is_local,
                  const bool* __restrict__ valid_task,
                  const bool* __restrict__ valid_node,
                  float* __restrict__ avail, float* __restrict__ inv,
                  int* __restrict__ actions, int spread_fp, int positions,
                  int nb, int rb) {
  __shared__ unsigned long long s_key[2][kMaxWarps];
  __shared__ unsigned s_flags[2][kMaxWarps];
  __shared__ int s_local_ok[2];
  __shared__ int s_local_idx;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // This thread's nodes: working availability and 1 / max(totals, 1e-9)
  // (0 where totals <= 0); and the first local node.
  if (tid == 0) s_local_idx = INT_MAX;
  __syncthreads();
  int first_local = INT_MAX;
  for (int n = tid; n < nb; n += blockDim.x) {
    for (int r = 0; r < rb; ++r) {
      const float tot = totals[n * rb + r];
      avail[n * rb + r] = avail0[n * rb + r];
      inv[n * rb + r] = tot > 0.f ? __fdiv_rn(1.f, fmaxf(tot, kEps)) : 0.f;
    }
    if (is_local[n] && n < first_local) first_local = n;
  }
  if (first_local != INT_MAX) atomicMin(&s_local_idx, first_local);
  __syncthreads();
  const int local_idx = s_local_idx == INT_MAX ? 0 : s_local_idx;

  int step = 0;  // valid positions so far: picks the shared buffer
  for (int t = 0; t < positions; ++t) {
    if (!valid_task[t]) {  // uniform across the block
      if (tid == 0) actions[t] = kWait;
      continue;
    }
    const int buf = step++ & 1;
    const long long slot = perm[t];
    const float* d = demands + slot * rb;
    const int* loc = locality + slot * nb;

    unsigned long long key = kNotReady;
    bool any_feasible = false, any_ready = false;
    for (int n = tid; n < nb; n += blockDim.x) {
      bool feasible = valid_node[n];
      bool ready = true;
      int util = 0;
      for (int r = 0; r < rb; ++r) {
        const float dr = d[r];
        const float tot = totals[n * rb + r];
        const float av = avail[n * rb + r];
        feasible = feasible && __fadd_rn(tot, kEps) >= dr;
        ready = ready && __fadd_rn(av, kEps) >= dr;
        const float used = __fadd_rn(__fsub_rn(tot, av), dr);
        const float c = ceilf(__fmul_rn(__fmul_rn(used, inv[n * rb + r]),
                                        kUtilScale));
        // The reference casts to int32, then clips to [0, UTIL_MAX].
        // Clamping the float first gives the same value wherever it can
        // reach a decision: at a ready node avail >= d, so used <= totals
        // and c is in range. Out of int32 range it occurs only at nodes
        // that are not ready, whose utilisation no decision reads; the
        // clamp keeps the conversion defined there.
        const int fp = tot > 0.f ? static_cast<int>(
                                       fminf(fmaxf(c, 0.f), kUtilMax))
                                 : 0;
        util = max(util, fp);
      }
      ready = ready && feasible;
      const int anti = (1 << 20) - min(loc[n] >> 10, kLocMax);
      const unsigned hi = (static_cast<unsigned>(util) << 10) |
                          static_cast<unsigned>(anti >> kHiLocShift);
      const unsigned lo = (static_cast<unsigned>(anti & kLoLocMask) << 16) |
                          ((is_local[n] ? 0u : 1u) << kNodeBits) |
                          static_cast<unsigned>(n);
      if (ready) {
        const unsigned long long k =
            (static_cast<unsigned long long>(hi) << 32) | lo;
        key = k < key ? k : key;
      }
      any_feasible = any_feasible || feasible;
      any_ready = any_ready || ready;
      if (n == local_idx) s_local_ok[buf] = ready && util <= spread_fp;
    }
    key = warp_min(key);
    const unsigned flags = (__any_sync(0xffffffffu, any_feasible) ? 1u : 0u) |
                           (__any_sync(0xffffffffu, any_ready) ? 2u : 0u);
    if (lane == 0) {
      s_key[buf][warp] = key;
      s_flags[buf][warp] = flags;
    }
    __syncthreads();
    // Every thread reduces the per-warp results itself. A thread reaches
    // the next task's writes, into the other buffer, only after this
    // sync, and a buffer is written again only after the next sync,
    // which no thread passes before all have read it.
    unsigned long long best_key = kNotReady;
    unsigned all_flags = 0;
    for (int w = 0; w < nwarps; ++w) {
      const unsigned long long k = s_key[buf][w];
      best_key = k < best_key ? k : best_key;
      all_flags |= s_flags[buf][w];
    }
    const int best = static_cast<int>(best_key & ((1u << kNodeBits) - 1));
    // Hybrid rule: the local node wins while under the spread threshold.
    const int chosen = s_local_ok[buf] ? local_idx : best;
    // Frontier gate: a local grant waits for its dependencies.
    const bool blocked = chosen == local_idx && !dep_ready[slot];
    int action = kWait;
    if (!(all_flags & 1u)) {
      action = kInfeasible;
    } else if ((all_flags & 2u) && !blocked) {
      action = chosen;
    }
    if (tid == 0) actions[t] = action;
    if (action >= 0 && action % blockDim.x == tid) {
      for (int r = 0; r < rb; ++r)
        avail[action * rb + r] = __fsub_rn(avail[action * rb + r], d[r]);
    }
  }
}

}  // namespace

extern "C" int sched_scan(const void* demands, const void* locality,
                          const void* dep_ready, const void* perm,
                          const void* totals, const void* avail0,
                          const void* is_local, const void* valid_task,
                          const void* valid_node, void* avail, void* inv,
                          void* actions, int spread_fp, int positions,
                          int n_bucket, int r_bucket, void* stream) {
  if (positions < 1 || n_bucket < 1 || r_bucket < 1 ||
      n_bucket > (1 << kNodeBits))
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = n_bucket < kMaxThreads ? n_bucket : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  sched_scan_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(demands), static_cast<const int*>(locality),
      static_cast<const bool*>(dep_ready), static_cast<const int*>(perm),
      static_cast<const float*>(totals), static_cast<const float*>(avail0),
      static_cast<const bool*>(is_local),
      static_cast<const bool*>(valid_task),
      static_cast<const bool*>(valid_node), static_cast<float*>(avail),
      static_cast<float*>(inv), static_cast<int*>(actions), spread_fp,
      positions, n_bucket, r_bucket);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sched_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
