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
// Design. Most positions of a large tick never place. Only a placement
// changes availability, and a position can place only where it is
// ready. So once no valid node is ready for the componentwise minimum
// of the demands of the positions left, none of them can place, nothing
// changes availability again, and every later action is final (WAIT, or
// INFEASIBLE where no node's totals hold the demand). That holds
// whatever the demands' signs. Two kernels run on the caller's stream:
//
// * sched_prepass_kernel, over the whole grid, one warp per position:
//   gathers each position's demand row through perm (scan order), writes
//   the walk's defaults (INFEASIBLE where no valid node's totals hold
//   the demand, WAIT elsewhere), a 16-byte header (slot, valid,
//   dependencies ready) and the minimum demand per kind of each chunk of
//   positions.
// * sched_walk_kernel, one block: the running availability and what
//   scoring reads of it, the totals, 1 / totals and the node flags in
//   shared memory (the "shared" route), or in global memory where they
//   do not fit (the "global" route, chosen by shape); kinds that no
//   demand and no node's totals touch are left out. It first turns the
//   chunk minima into suffix minima. Then it walks one position at a
//   time, scored by G warps, lanes over nodes, with warp reductions
//   only. After a barrier, warp 0 decides the position and commits its
//   placement; a second barrier opens the next. Beside the scoring warps
//   a producer warp streams the header, demand row and locality row of
//   the positions ahead into a ring in shared memory by cp.async, kDepth
//   groups in flight, and an exit warp tests the suffix minimum from the
//   position's chunk against the state and stops the walk.
//
// Bound on the H100: what the output needs is every position's demand,
// perm, valid and dependency entries, the locality rows of the positions
// ready on some node at their turn and the node table: ~3.5 MB for the
// first tick of 100,000 tasks over 256 nodes, ~1 us at 3.35 TB/s. The
// walk is a serial chain of placements, each depending on the
// availability the one before left, and a position is a chain of
// dependent shared-memory loads, warp reductions and two barriers: it
// is bound by latency, not by bytes or operations. The walk kernel
// reads the global timer at its start, before its loop and after it
// (WALK_COUNTERS's init_ns and walk_ns).

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
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNotReady = ~0ull;
// float32(1e-9): the reference's weakly typed 1e-9 on fp32 arrays
constexpr float kEps = 0x1.12e0bep-30f;
constexpr int kValid = 1, kDepReady = 2;    // header flags
constexpr int kMaxGroup = 8;       // G scoring warps: a power of two
// G scoring warps, a producer warp and an exit warp
constexpr int kMaxWalkWarps = kMaxGroup + 2;
constexpr int kDepth = 3;   // cp.async groups in flight; ring of kDepth + 1
constexpr int kPrepassThreads = 256;
constexpr int kScanKinds = 8;               // kinds per suffix-scan pass
// the walk's static shared memory, beside the dynamic WalkSmem
constexpr int kStaticSmem = 1024;
constexpr int kStateArrays = 6;   // av, totals, av + eps, totals + eps,
                                  // totals - av, 1 / totals

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The warp's minimum of a 64-bit key: the high words' minimum, then the
// low words' among the lanes that hold it.
__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  const unsigned hi = __reduce_min_sync(kFull, static_cast<unsigned>(v >> 32));
  const unsigned lo = __reduce_min_sync(
      kFull, static_cast<unsigned>(v >> 32) == hi ? static_cast<unsigned>(v)
                                                  : 0xffffffffu);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

__device__ __forceinline__ int elapsed_ns(unsigned long long t0,
                                          unsigned long long t1) {
  return static_cast<int>(min(t1 - t0, static_cast<unsigned long long>(INT_MAX)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ inline int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// One ring slot: the 16-byte header, the demand row, and on the shared
// route the locality row.
__host__ __device__ inline int slot_bytes(bool shared, int nb, int rb) {
  return 16 + round16(rb * 4) + (shared ? round16(nb * 4) : 0);
}

// The walk's dynamic shared memory, as byte offsets.
struct WalkSmem {
  int state;   // shared route: [kStateArrays][rb][nb]
  int flags;   // shared route: valid_node, is_local, ready for the
               // suffix minimum, [3][nb] bytes
  int ring;    // kDepth + 1 slots
  int scan;    // the init's suffix scan, [kScanKinds][threads]
  int min;     // the exit warp's suffix minimum, [rb]
  int kinds;   // the active kinds, [rb] ints
  int total;
};

__host__ __device__ inline WalkSmem walk_smem(bool shared, int nb, int rb,
                                              int threads) {
  WalkSmem s;
  int off = 0;
  s.state = off;
  off += shared ? round16(kStateArrays * rb * nb * 4) : 0;
  s.flags = off;
  off += round16(3 * nb);
  s.ring = off;
  off += (kDepth + 1) * slot_bytes(shared, nb, rb);
  s.scan = off;
  off += kScanKinds * threads * 4;
  s.min = off;
  off += round16(rb * 4);
  s.kinds = off;
  off += round16(rb * 4);
  s.total = off;
  return s;
}

__global__ void __launch_bounds__(kPrepassThreads)
sched_prepass_kernel(const float* __restrict__ demands,
                     const bool* __restrict__ dep_ready,
                     const int* __restrict__ perm,
                     const float* __restrict__ totals,
                     const bool* __restrict__ valid_task,
                     const bool* __restrict__ valid_node,
                     float* __restrict__ dem, int4* __restrict__ hdr,
                     float* __restrict__ cmin, int* __restrict__ cnz, int* __restrict__ actions,
                     int positions, int nb, int rb, int chunk) {
  extern __shared__ float s_min[];   // [warps][rb], then s_nz
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int* s_nz = reinterpret_cast<int*>(s_min + nwarps * rb);   // [warps][rb]
  for (int r = lane; r < rb; r += 32) {
    s_min[warp * rb + r] = inf_f();
    s_nz[warp * rb + r] = 0;
  }
  const int t1 = min(positions, (blockIdx.x + 1) * chunk);
  for (int t = blockIdx.x * chunk + warp; t < t1; t += nwarps) {
    const int slot = perm[t];
    if (!valid_task[t]) {   // WAIT, and the walk takes nothing from it
      if (lane == 0) {
        hdr[t] = make_int4(slot, 0, 0, 0);
        actions[t] = kWait;
      }
      continue;
    }
    const float* d = demands + static_cast<long long>(slot) * rb;
    for (int r = lane; r < rb; r += 32) {
      const float v = d[r];
      dem[static_cast<long long>(t) * rb + r] = v;
      s_min[warp * rb + r] = fminf(s_min[warp * rb + r], v);
      s_nz[warp * rb + r] |= v != 0.f;   // NaN too
    }
    bool feasible = false;
    for (int n0 = 0; n0 < nb && !feasible; n0 += 32) {
      const int n = n0 + lane;
      bool f = n < nb && valid_node[n];
      for (int r = 0; r < rb && f; ++r)
        f = __fadd_rn(totals[n * rb + r], kEps) >= d[r];
      feasible = __any_sync(kFull, f);
    }
    if (lane == 0) {
      hdr[t] = make_int4(slot, kValid | (dep_ready[slot] ? kDepReady : 0),
                         0, 0);
      actions[t] = feasible ? kWait : kInfeasible;
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rb; r += blockDim.x) {
    float m = inf_f();
    int nz = 0;
    for (int w = 0; w < nwarps; ++w) {
      m = fminf(m, s_min[w * rb + r]);
      nz |= s_nz[w * rb + r];
    }
    cmin[static_cast<long long>(blockIdx.x) * rb + r] = m;
    cnz[static_cast<long long>(blockIdx.x) * rb + r] = nz;
  }
}

// cmin[c][r] <- min over chunks c' >= c; row n_chunks is +inf. Each
// thread takes a segment of chunks; the segments' minima are combined in
// reverse by a Hillis-Steele scan in shared memory, kScanKinds kinds at
// a time.
__device__ void suffix_min(float* cmin, int n_chunks, int rb, float* s_scan) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int seg = (n_chunks + nthreads - 1) / nthreads;
  const int c0 = min(n_chunks, tid * seg), c1 = min(n_chunks, c0 + seg);
  for (int r0 = 0; r0 < rb; r0 += kScanKinds) {
    const int nk = min(kScanKinds, rb - r0);
    for (int k = 0; k < nk; ++k) {
      float m = inf_f();
      for (int c = c0; c < c1; ++c) m = fminf(m, cmin[c * rb + r0 + k]);
      s_scan[k * nthreads + tid] = m;
    }
    __syncthreads();
    for (int off = 1; off < nthreads; off <<= 1) {
      float v[kScanKinds];
#pragma unroll
      for (int k = 0; k < kScanKinds; ++k)
        v[k] = k < nk && tid + off < nthreads
                   ? s_scan[k * nthreads + tid + off] : inf_f();
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kScanKinds; ++k)
        if (k < nk)
          s_scan[k * nthreads + tid] = fminf(s_scan[k * nthreads + tid], v[k]);
      __syncthreads();
    }
    for (int k = 0; k < nk; ++k) {
      float carry = tid + 1 < nthreads ? s_scan[k * nthreads + tid + 1]
                                       : inf_f();
      for (int c = c1 - 1; c >= c0; --c) {
        carry = fminf(carry, cmin[c * rb + r0 + k]);
        cmin[c * rb + r0 + k] = carry;
      }
    }
    __syncthreads();
  }
  for (int r = tid; r < rb; r += nthreads) cmin[n_chunks * rb + r] = inf_f();
}

struct Walk {
  const int* locality;
  const bool* is_local;
  const bool* valid_node;
  const float* totals;
  const float* avail0;
  const float* dem;
  const int4* hdr;
  float* cmin;
  const int* cnz;
  float* state;   // global route: [kStateArrays][rb][nb]
  int* actions;
  int* stats;
  int spread_fp, positions, nb, rb, group, chunk_log2, n_chunks;
  bool vec16;     // 16-byte copies into the ring (else 4-byte ones)
};

// Copy the header, demand row and (shared route) locality row of
// positions [from, to) into their ring slots (position & ring_mask) by
// cp.async, 16- (or 4-) byte units over the lanes of one warp, the
// walk's producer; padding positions get their header only. Lane l
// keeps the header of position hbase + l in h, reloaded when the
// positions asked for pass hbase + 31 (at most once in 32 positions,
// since the first fill asks for kDepth + 1 positions and each position
// after it for one), so no copy waits on a load of its source address.
template <bool kShared>
__device__ void fetch_ahead(const Walk& a, unsigned char* ring,
                            int ring_mask, int from, int to, int rb, int sb,
                            int& hbase, int2& h) {
  const int lane = threadIdx.x & 31;
  const int u = a.vec16 ? 16 : 4;
  const int hdr_units = 16 / u, dem_units = rb * 4 / u;
  const int upp = hdr_units + dem_units + (kShared ? a.nb * 4 / u : 0);
  const int dem_pad = round16(rb * 4);
  const auto copy = [&](unsigned char* dst, const unsigned char* src) {
    if (a.vec16) cp_async16(dst, src);
    else cp_async4(dst, src);
  };
  if (to > hbase + 32) {
    hbase = from;
    h = hbase + lane < a.positions
            ? __ldg(reinterpret_cast<const int2*>(a.hdr + hbase + lane))
            : make_int2(0, 0);
  }
  for (int pos = from; pos < to; ++pos) {
    const int slot = __shfl_sync(kFull, h.x, pos - hbase);
    const int flags = __shfl_sync(kFull, h.y, pos - hbase);
    unsigned char* const dst = ring + (pos & ring_mask) * sb;
    const int units = (flags & kValid) ? upp : hdr_units;
    for (int k = lane; k < units; k += 32) {
      if (k < hdr_units) {
        copy(dst + k * u,
             reinterpret_cast<const unsigned char*>(a.hdr + pos) + k * u);
      } else if (k < hdr_units + dem_units) {
        const int o = (k - hdr_units) * u;
        copy(dst + 16 + o, reinterpret_cast<const unsigned char*>(
                               a.dem + static_cast<long long>(pos) * rb) + o);
      } else {
        const int o = (k - hdr_units - dem_units) * u;
        copy(dst + 16 + dem_pad + o,
             reinterpret_cast<const unsigned char*>(
                 a.locality + static_cast<long long>(slot) * a.nb) + o);
      }
    }
  }
  cp_async_commit();
}

// What the walk's loop reads besides the kernel's arguments: the state
// and the shared arrays set up by the kernel's first part.
struct WalkCtx {
  float *av, *tot, *avp, *totp, *base, *inv;
  const bool *vnode, *isloc;
  bool* ready_min;
  unsigned char* ring;
  float* s_min;
  const int* kinds;
  unsigned long long* s_key;
  int *s_part, *s_exit, *s_nready, *s_last;
  int rb, ka, local_idx, ring_mask, sb, dem_pad;
};

// The walk, with kKa (1 to 4) active kinds unrolled, or any number (0).
//
// Warp g of the G scoring warps scores nodes g * 32 + lane, + 32 G, ...
// of position p and leaves its nodes' minimum key and flags in shared
// memory. Warp G streams the rows ahead into the ring, warp G + 1 runs
// the exit test. After the first barrier warp 0 alone decides the
// position and commits its placement; the second barrier opens the
// next position.
template <bool kShared, int kKa>
__device__ __forceinline__ void walk_loop(const Walk& a, const WalkCtx& c,
                                          int* counters) {
  const int nb = a.nb, G = a.group, P = a.positions, rb = c.rb, ka = c.ka;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ring_slots = c.ring_mask + 1;
  int p = 0, scored = 0, placements = 0;
  int chunk_loaded = -1, last_node = -1, fetched = min(ring_slots, P);
  int hbase = -64;   // the producer's cached headers
  int2 h = make_int2(0, 0);
  if (warp == G) {   // the first kDepth + 1 positions
    fetch_ahead<kShared>(a, c.ring, c.ring_mask, 0, fetched, rb, c.sb,
                         hbase, h);
    cp_async_wait<0>();
  }
  __syncthreads();
  int kreg[kKa > 0 ? kKa : 1];   // the active kinds, in registers
#pragma unroll
  for (int k = 0; k < kKa; ++k) kreg[k] = c.kinds[k];
  for (; p < P; ++p) {
    const unsigned char* slotp = c.ring + (p & c.ring_mask) * c.sb;
    const float* d = reinterpret_cast<const float*>(slotp + 16);
    int hf = 0;   // the position's header flags, in the scoring warps
    if (warp < G) {
      hf = reinterpret_cast<const int4*>(slotp)->y;
      unsigned long long key = kNotReady;
      bool any_ready = false, local_ok = false;
      if (hf & kValid) {
        const int* loc =
            kShared ? reinterpret_cast<const int*>(slotp + 16 + c.dem_pad)
                    : a.locality +
                          static_cast<long long>(
                              reinterpret_cast<const int4*>(slotp)->x) * nb;
        float dk[kKa > 0 ? kKa : 1];
#pragma unroll
        for (int k = 0; k < kKa; ++k) dk[k] = d[kreg[k]];
#pragma unroll 2
        for (int n = (warp << 5) + lane; n < nb; n += G << 5) {
          bool ready = c.vnode[n];
          // The utilisation is max over kinds of clip(ceil(used * (1 /
          // totals) * 2^20)): ceil, the exact scaling by 2^20 and the
          // clip are monotone, so they are taken once, on the largest
          // used * (1 / totals); a NaN term (where the reference's clip
          // of the cast gives 0) drops out of fmaxf.
          float y = 0.f;
#pragma unroll 4
          for (int k = 0; k < (kKa > 0 ? kKa : ka); ++k) {
            const int i = k * nb + n;
            const float dr = kKa > 0 ? dk[k] : d[c.kinds[k]];
            ready = ready & (c.totp[i] >= dr) & (c.avp[i] >= dr);
            y = fmaxf(y, __fmul_rn(__fadd_rn(c.base[i], dr), c.inv[i]));
          }
          // At a ready node avail >= d, so used <= totals and the value
          // is in range; the clip keeps the cast defined elsewhere.
          const int util = static_cast<int>(
              fminf(ceilf(__fmul_rn(y, kUtilScale)), kUtilMax));
          const int l = kShared ? loc[n] : __ldg(loc + n);
          const int anti = (1 << 20) - min(l >> 10, kLocMax);
          const unsigned hi = (static_cast<unsigned>(util) << 10) |
                              static_cast<unsigned>(anti >> kHiLocShift);
          const unsigned lo =
              (static_cast<unsigned>(anti & kLoLocMask) << 16) |
              ((c.isloc[n] ? 0u : 1u) << kNodeBits) |
              static_cast<unsigned>(n);
          const unsigned long long key_n =
              (static_cast<unsigned long long>(hi) << 32) | lo;
          key = ready && key_n < key ? key_n : key;
          local_ok = local_ok || (n == c.local_idx && ready &&
                                  util <= a.spread_fp);
          any_ready = any_ready || ready;
        }
        key = warp_min(key);
        any_ready = __any_sync(kFull, any_ready);
        local_ok = __any_sync(kFull, local_ok);
      }
      if (lane == 0) {
        c.s_key[warp] = key;
        c.s_part[warp] = (any_ready ? 1 : 0) | (local_ok ? 2 : 0);
      }
    } else if (warp == G) {
      // The positions entering the lookahead [p, p + ring_slots): the
      // next one's was asked for two positions ago or earlier.
      const int to = min(p + ring_slots, P);
      fetch_ahead<kShared>(a, c.ring, c.ring_mask, fetched, to, rb, c.sb,
                           hbase, h);
      fetched = to;
    } else {
      // The exit test: is any valid node ready for the minimum demand
      // of the positions from p's chunk on? Only a placement moves
      // availability, and only at its node, so after one only that node
      // is tested again. A node not ready for the minimum is ready for
      // none of those positions, so it takes no placement before it is
      // tested again: one found not ready stays so within the chunk.
      const int ch = p >> a.chunk_log2;
      if (ch != chunk_loaded) {
        for (int k = lane; k < ka; k += 32)
          c.s_min[k] = a.cmin[ch * rb + c.kinds[k]];
        __syncwarp();
        int count = 0;
        for (int n0 = 0; n0 < nb; n0 += 32) {
          const int n = n0 + lane;
          bool ok = n < nb && c.vnode[n];
          for (int k = 0; k < ka && ok; ++k)
            ok = c.avp[k * nb + n] >= c.s_min[k];
          if (n < nb) c.ready_min[n] = ok;
          count += __popc(__ballot_sync(kFull, ok));
        }
        chunk_loaded = ch;
        if (lane == 0) *c.s_nready = count;
      } else if (last_node >= 0 && lane == 0 && c.ready_min[last_node]) {
        bool ok = true;
        for (int k = 0; k < ka; ++k)
          ok = ok & (c.avp[k * nb + last_node] >= c.s_min[k]);
        c.ready_min[last_node] = ok;
        *c.s_nready -= ok ? 0 : 1;
      }
      __syncwarp();
      if (lane == 0) *c.s_exit = *c.s_nready == 0;
    }
    __syncthreads();
    if (*c.s_exit) break;   // nothing from p on can place

    if (warp == 0) {
      // Lanes below G hold the scoring warps' partial results.
      const unsigned long long key =
          warp_min(lane < G ? c.s_key[lane] : kNotReady);
      const int part =
          __reduce_or_sync(kFull, lane < G ? c.s_part[lane] : 0);
      const int best = static_cast<int>(key & ((1u << kNodeBits) - 1));
      // Hybrid rule: the local node wins while under the spread
      // threshold. Frontier gate: a local grant waits for its
      // dependencies.
      const int chosen = (part & 2) ? c.local_idx : best;
      const bool blocked = chosen == c.local_idx && !(hf & kDepReady);
      scored += hf & kValid ? 1 : 0;
      int node = -1;
      if ((part & 1) && !blocked) {
        // Commit the placement: its demand leaves the chosen node.
        node = chosen;
        for (int k = lane; k < ka; k += 32) {
          const int i = k * nb + node;
          const float v = __fsub_rn(c.av[i], d[c.kinds[k]]);
          c.av[i] = v;
          c.avp[i] = __fadd_rn(v, kEps);
          c.base[i] = __fsub_rn(c.tot[i], v);
        }
        if (lane == 0) a.actions[p] = node;
        ++placements;
      }
      if (lane == 0) *c.s_last = node;
    } else if (warp == G) {
      cp_async_wait<kDepth - 1>();
    }
    __syncthreads();
    last_node = *c.s_last;
  }
  cp_async_wait<0>();
  counters[0] = scored;
  counters[1] = min(p, P);
  counters[2] = placements;
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxWalkWarps * 32)
sched_walk_kernel(const Walk a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // per scoring warp: its nodes' minimum key and whether one is ready
  // (bit 0) or the local node is ready under the threshold (bit 1)
  __shared__ unsigned long long s_key[kMaxGroup];
  __shared__ int s_part[kMaxGroup];
  __shared__ int s_local_idx, s_exit, s_nready, s_ka, s_last;

  const int tid = threadIdx.x;
  const unsigned long long t_start = tid == 0 ? global_ns() : 0;
  const int rb = a.rb, nb = a.nb;
  const WalkSmem L = walk_smem(kShared, nb, rb, blockDim.x);
  WalkCtx c;
  // The state of the active kinds, kind-major ([k][n]: consecutive lanes,
  // consecutive banks): availability, totals, and what scoring reads of
  // them, kept up to date so a cell costs four loads: av + 1e-9,
  // totals + 1e-9, totals - av, and 1 / max(totals, 1e-9) (0 where
  // totals <= 0, which makes the utilisation term 0 as the reference's
  // where(totals > 0, ., 0) does).
  c.av = kShared ? reinterpret_cast<float*>(smem + L.state) : a.state;
  c.tot = c.av + rb * nb;
  c.avp = c.tot + rb * nb;
  c.totp = c.avp + rb * nb;
  c.base = c.totp + rb * nb;
  c.inv = c.base + rb * nb;
  bool* const flags = reinterpret_cast<bool*>(smem + L.flags);
  c.vnode = kShared ? flags : a.valid_node;
  c.isloc = kShared ? flags + nb : a.is_local;
  c.ready_min = flags + 2 * nb;   // ready for the suffix minimum
  c.ring = smem + L.ring;
  c.s_min = reinterpret_cast<float*>(smem + L.min);
  int* const kinds = reinterpret_cast<int*>(smem + L.kinds);
  c.kinds = kinds;
  c.s_key = s_key;
  c.s_part = s_part;
  c.s_exit = &s_exit;
  c.s_nready = &s_nready;
  c.s_last = &s_last;
  c.rb = rb;
  c.ring_mask = kDepth;   // kDepth + 1 slots, a power of two
  c.sb = slot_bytes(kShared, nb, rb);
  c.dem_pad = round16(rb * 4);

  // A kind is inert, and left out, where every valid demand of it is 0
  // and every valid node holds no totals of it and is feasible and ready
  // for 0: its cells are then (feasible, ready, utilisation 0) for every
  // task, and no grant moves its availability.
  if (tid == 0) {
    s_local_idx = INT_MAX;
    s_exit = 0;
    s_nready = 0;
  }
  for (int r = tid; r < rb; r += blockDim.x) kinds[r] = 0;
  __syncthreads();
  for (int i = tid; i < a.n_chunks * rb; i += blockDim.x)
    if (a.cnz[i]) kinds[i % rb] = 1;
  for (int i = tid; i < rb * nb; i += blockDim.x) {
    const int n = i / rb;
    const float t = a.totals[i], v = a.avail0[i];
    if (a.valid_node[n] && (t > 0.f || !(__fadd_rn(t, kEps) >= 0.f) ||
                            !(__fadd_rn(v, kEps) >= 0.f)))
      kinds[i - n * rb] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    int ka = 0;
    for (int r = 0; r < rb; ++r)
      if (kinds[r]) kinds[ka++] = r;
    s_ka = ka;
  }
  __syncthreads();
  c.ka = s_ka;
  for (int i = tid; i < c.ka * nb; i += blockDim.x) {
    const int k = i / nb, n = i - k * nb, r = kinds[k];
    const float t = a.totals[n * rb + r], v = a.avail0[n * rb + r];
    c.tot[i] = t;
    c.av[i] = v;
    c.avp[i] = __fadd_rn(v, kEps);
    c.totp[i] = __fadd_rn(t, kEps);
    c.base[i] = __fsub_rn(t, v);
    c.inv[i] = t > 0.f ? __fdiv_rn(1.f, fmaxf(t, kEps)) : 0.f;
  }
  int first_local = INT_MAX;
  for (int n = tid; n < nb; n += blockDim.x) {
    if (kShared) {
      flags[n] = a.valid_node[n];
      flags[nb + n] = a.is_local[n];
    }
    if (a.is_local[n] && n < first_local) first_local = n;
  }
  if (first_local != INT_MAX) atomicMin(&s_local_idx, first_local);
  suffix_min(a.cmin, a.n_chunks, rb,
             reinterpret_cast<float*>(smem + L.scan));
  __syncthreads();
  c.local_idx = s_local_idx == INT_MAX ? 0 : s_local_idx;
  const unsigned long long t_walk = tid == 0 ? global_ns() : 0;

  int counters[3];
  switch (c.ka) {
    case 1: walk_loop<kShared, 1>(a, c, counters); break;
    case 2: walk_loop<kShared, 2>(a, c, counters); break;
    case 3: walk_loop<kShared, 3>(a, c, counters); break;
    case 4: walk_loop<kShared, 4>(a, c, counters); break;
    default: walk_loop<kShared, 0>(a, c, counters); break;
  }
  __syncthreads();
  if (tid == 0) {   // cuda_batched.WALK_COUNTERS
    const unsigned long long t_end = global_ns();
    for (int i = 0; i < 3; ++i) a.stats[i] = counters[i];
    a.stats[3] = kShared ? 1 : 0;
    a.stats[4] = elapsed_ns(t_start, t_walk);
    a.stats[5] = elapsed_ns(t_walk, t_end);
  }
}

template <bool kShared>
int launch_walk(const Walk& a, int threads, int smem_bytes,
                cudaStream_t stream) {
  auto kernel = sched_walk_kernel<kShared>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, threads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sched_scan(const void* demands, const void* locality,
                          const void* dep_ready, const void* perm,
                          const void* totals, const void* avail0,
                          const void* is_local, const void* valid_task,
                          const void* valid_node, void* dem, void* hdr,
                          void* cmin, void* cnz, void* state, void* stats,
                          void* actions, int spread_fp, int positions,
                          int n_bucket, int r_bucket, int chunk,
                          void* stream) {
  if (positions < 1 || n_bucket < 1 || r_bucket < 1 ||
      n_bucket > (1 << kNodeBits) || chunk < 1 || (chunk & (chunk - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (positions + chunk - 1) / chunk;
  sched_prepass_kernel<<<n_chunks, kPrepassThreads,
                         kPrepassThreads / 32 * r_bucket * 8, s>>>(
      static_cast<const float*>(demands), static_cast<const bool*>(dep_ready),
      static_cast<const int*>(perm), static_cast<const float*>(totals),
      static_cast<const bool*>(valid_task),
      static_cast<const bool*>(valid_node), static_cast<float*>(dem),
      static_cast<int4*>(hdr), static_cast<float*>(cmin),
      static_cast<int*>(cnz), static_cast<int*>(actions), positions,
      n_bucket, r_bucket, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  int device = 0, smem_max = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
          cudaSuccess)
    return static_cast<int>(err);
  // G warps score a position: the largest power of two up to 8 that
  // leaves each lane a node.
  int group = 1;
  while (group < kMaxGroup && 64 * group <= n_bucket) group *= 2;
  const int threads = (group + 2) * 32;
  Walk a;
  a.locality = static_cast<const int*>(locality);
  a.is_local = static_cast<const bool*>(is_local);
  a.valid_node = static_cast<const bool*>(valid_node);
  a.totals = static_cast<const float*>(totals);
  a.avail0 = static_cast<const float*>(avail0);
  a.dem = static_cast<const float*>(dem);
  a.hdr = static_cast<const int4*>(hdr);
  a.cmin = static_cast<float*>(cmin);
  a.cnz = static_cast<const int*>(cnz);
  a.state = static_cast<float*>(state);
  a.actions = static_cast<int*>(actions);
  a.stats = static_cast<int*>(stats);
  a.spread_fp = spread_fp;
  a.positions = positions;
  a.nb = n_bucket;
  a.rb = r_bucket;
  a.group = group;
  a.chunk_log2 = 0;
  while ((1 << a.chunk_log2) < chunk) ++a.chunk_log2;
  a.n_chunks = n_chunks;
  // The route follows the shape: the state in shared memory where it and
  // the ring fit, else in global memory.
  const int shared_bytes = walk_smem(true, n_bucket, r_bucket, threads).total;
  if (shared_bytes + kStaticSmem <= smem_max) {
    a.vec16 = n_bucket % 4 == 0 && r_bucket % 4 == 0 &&
              reinterpret_cast<unsigned long long>(locality) % 16 == 0;
    return launch_walk<true>(a, threads, shared_bytes, s);
  }
  const int global_bytes =
      walk_smem(false, n_bucket, r_bucket, threads).total;
  if (global_bytes + kStaticSmem > smem_max)
    return static_cast<int>(cudaErrorInvalidValue);
  a.vec16 = r_bucket % 4 == 0;
  return launch_walk<false>(a, threads, global_bytes, s);
}

extern "C" const char* sched_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
