// Flash-attention backward for Hopper on the tensor cores (wgmma), bf16:
// K2 (dK, dV) and K3 (dQ).
//
// Replaces the TPU kernels ray_tpu/ops/attention.py:_flash_bwd_dkv_kernel
// (K2) and _flash_bwd_dq_kernel (K3), both launched by _flash_backward
// through pl.pallas_call, with their shared recompute _bwd_tiles. They
// compute the same function as those and as csrc/flash_bwd.cu (which
// keeps the fp32 route): s = q.k^T * scale with masked scores giving
// p = 0; p = exp(s - lse); dp = dO.v^T; ds = p * (dp - delta) * scale;
// dV = p^T.dO and dK = ds^T.q (K2), dQ = ds.k (K3), summed in fp32 and
// written in bf16. lse (from K1) and delta = rowsum(dO * O) are fp32
// [B, H, T, 1].
//
// Layout: q, k, v, dO, dQ, dK, dV are bf16 [B, T, H, D] read and written
// through their (b, t, h) strides with unit stride on D; D is 8, 16, 32,
// 64 or 128 (under 64, tiles are padded to 64 columns in shared memory).
// The caller guarantees 16-byte aligned base pointers and (b, t, h)
// strides that are multiples of 8 elements (cp.async copies 16 bytes).
//
// Numerics. The plain version and the TPU kernel keep p and ds in fp32.
// One bf16 rounding of p and ds before the products that take them (as
// FlashAttention-2/3 do) moves dQ, dK, dV by ~10-40x a two-ulp
// allowance; so each is split as x ~ hi + lo, hi = bf16(x), lo =
// bf16(x - hi) (about 16 significant bits), and each of those products
// runs twice, once on hi and once on lo, into the same fp32 sums. The
// other operands (q, k, v, dO) are bf16 already, so their products are
// exact in fp32. K2 runs 6 tensor-core products where the function has
// 4, K3 4 where it has 3.
//
// Design (one warpgroup of 128 threads per block, 64-row tiles):
//  * Products are wgmma.mma_async m64n64k16, bf16 in, fp32 accumulate,
//    on [64][D] tiles in wgmma's 128-byte swizzled layout (sm90.cuh,
//    whose helpers K1 shares), read K-major for the score products and
//    MN-major for the gradient products.
//  * K2 owns (b, h, 64-row k-tile) and works in the transposed frame:
//    S^T = K.Q^T and dP^T = V.dO^T (A = K or V, B = Q or dO, both
//    K-major from shared memory), so P^T and dS^T come out in the
//    accumulator layout, which is the register layout of wgmma's A
//    operand. dV += P^T.dO and dK += dS^T.Q then take A from registers
//    (hi and lo fragments) and B (dO or Q) MN-major: no tile goes back
//    through shared memory. lse and delta are per column there.
//  * K3 owns (b, h, 64-row q-tile): S = Q.K^T and dP = dO.V^T, dS in
//    registers, dQ += dS.K with K MN-major.
//  * The streamed tiles (Q, dO, lse, delta in K2; K, V in K3) are double
//    buffered with cp.async (16-byte copies; rows past T zero-filled by
//    the copy's source size), so the next tile's load overlaps this
//    tile's products. Nothing crosses blocks: no atomics, deterministic
//    sums. Heavy causal tiles are scheduled first.
//
// Ragged T: rows >= T of q, k, v and dO are zero-filled, pairs with
// qpos >= T or kpos >= T get p = ds = 0, lse and delta are never read
// past T (K1 does not write those rows), and no row >= T is written.
//
// Bound on the H100: at the training shape (16 x 1024 x 16 x 64, bf16,
// causal) K2's function is ~69 GFLOP (0.070 ms at 989 TFLOP/s) on ~203 MB
// (0.061 ms at 3.35 TB/s), K3's ~52 GFLOP (0.052 ms) on ~170 MB: both are
// bound by operations. The hi/lo split runs 1.5x (K2) and 1.33x (K3) the
// function's tensor-core work. Not done here (later work): warp
// specialisation with TMA producers, persistent blocks, clusters, and
// fusing K2 with K3 (dQ by atomics) so the recompute runs once.

#include "sm90.cuh"

namespace {

constexpr int kRowBytes = 2 * kBlock * 4;     // lse and delta of a tile

struct Inputs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // [B, H, T] (the trailing 1 of [B, H, T, 1])
  const float* delta;  // [B, H, T]
  Strides sq, sk, sv, sdo;
  int seq, heads;
  float sm_scale;
  int causal;
};

// lse then delta of rows [t0, t0 + 64) of one head (64 floats each) at
// dst; 0 past seq (the masks zero every pair of those rows).
__device__ __forceinline__ void load_rows(uint32_t dst, const float* lse,
                                          const float* delta, int t0,
                                          int seq) {
  const int t = t0 + threadIdx.x % kBlock;
  const bool valid = t < seq;
  const float* src = threadIdx.x < kBlock ? lse : delta;
  cp_async_4(dst + threadIdx.x * 4, src + (valid ? t : 0), valid);
}

// ---- K2: dK, dV ----------------------------------------------------------

template <int D>
struct DkvSmem {  // byte offsets from a 1024-aligned base
  static constexpr int kTile = kBlock * padded(D) * 2;
  static constexpr int K = 0, V = kTile;
  static constexpr int Q = 2 * kTile;   // two buffers
  static constexpr int DO = 4 * kTile;  // two buffers
  static constexpr int ROWS = 6 * kTile;  // two buffers of lse, delta
  static constexpr int kBytes = ROWS + 2 * kRowBytes + 1024;
};

// One block per (b * H + h, k-tile); the k-tile loops over the q-tiles
// from the causal diagonal on.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_sm90_kernel(Inputs in, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, Strides sdk,
                          Strides sdv) {
  using S = DkvSmem<D>;
  constexpr int kHalves = padded(D) / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* rows = reinterpret_cast<const float*>(smem_raw + (base - raw) +
                                                     S::ROWS);

  const int b = blockIdx.x / in.heads, h = blockIdx.x % in.heads;
  const int kt = blockIdx.y;  // causal: k-tile 0 has the most q-tiles
  const int k0 = kt * kBlock;
  const int seq = in.seq;
  const long long row0 = ((long long)b * in.heads + h) * seq;
  const float* lse = in.lse + row0;
  const float* delta = in.delta + row0;
  const bf16* qh = in.q + b * in.sq.b + h * in.sq.h;
  const bf16* doh = in.dout + b * in.sdo.b + h * in.sdo.h;

  // Causal: q-tiles that end before k0 see none of this k-tile (the TPU
  // kernel's `run` predicate); the tiles are aligned, so start at k0's.
  const int qt0 = in.causal ? kt : 0;
  const int n_q = (seq + kBlock - 1) / kBlock;
  load_tile<D>(base + S::K, in.k + b * in.sk.b + h * in.sk.h, in.sk.t, k0,
               seq);
  load_tile<D>(base + S::V, in.v + b * in.sv.b + h * in.sv.h, in.sv.t, k0,
               seq);
  load_tile<D>(base + S::Q, qh, in.sq.t, qt0 * kBlock, seq);
  load_tile<D>(base + S::DO, doh, in.sdo.t, qt0 * kBlock, seq);
  load_rows(base + S::ROWS, lse, delta, qt0 * kBlock, seq);
  cp_async_commit();

  float dk_acc[kHalves][32], dv_acc[kHalves][32];
#pragma unroll
  for (int x = 0; x < kHalves; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[x][i] = dv_acc[x][i] = 0.f;

  const float scale_log2 = in.sm_scale * kLog2e;
  for (int qt = qt0, s = 0; qt < n_q; ++qt, s ^= 1) {
    const int q0 = qt * kBlock;
    if (qt + 1 < n_q) {  // the next q-tile into the other buffer
      const int n = s ^ 1;
      load_tile<D>(base + S::Q + n * S::kTile, qh, in.sq.t, q0 + kBlock, seq);
      load_tile<D>(base + S::DO + n * S::kTile, doh, in.sdo.t, q0 + kBlock,
                   seq);
      load_rows(base + S::ROWS + n * kRowBytes, lse, delta, q0 + kBlock, seq);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this q-tile has landed
    __syncthreads();
    const uint32_t qs = base + S::Q + s * S::kTile;
    const uint32_t dos = base + S::DO + s * S::kTile;

    // S^T = K.Q^T and dP^T = V.dO^T: rows are keys, columns queries.
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_acc(st);
    fence_acc(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk) {
      wgmma_ss(st, kmajor(base + S::K, kk), kmajor(qs, kk));
      wgmma_ss(dpt, kmajor(base + S::V, kk), kmajor(dos, kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_acc(st);
    fence_acc(dpt);

    // P^T and dS^T in place; lse and delta are per column (query).
    const float* lse_s = rows + s * (kRowBytes / 4);
    const float* delta_s = lse_s + kBlock;
    const bool edge = (in.causal && q0 == k0) || q0 + kBlock > seq ||
                      k0 + kBlock > seq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + acc_col(j, 0));
      const float2 dl =
          *reinterpret_cast<const float2*>(delta_s + acc_col(j, 0));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float lse_log2 = (e % 2 ? l.y : l.x) * kLog2e;
        float p = exp2f(fmaf(st[i], scale_log2, -lse_log2));
        if (edge) {
          const int qpos = q0 + acc_col(j, e), kpos = k0 + acc_row(e);
          // the TPU kernel masks a score to -1e30, and exp(-1e30 - lse)
          // is exactly 0
          if (qpos >= seq || kpos >= seq || (in.causal && qpos < kpos))
            p = 0.f;
        }
        st[i] = p;
        dpt[i] = p * (dpt[i] - (e % 2 ? dl.y : dl.x)) * in.sm_scale;
      }
    }

    // dV += P^T.dO and dK += dS^T.Q, each as hi + lo, contracting over
    // the 64 queries in four k16 steps.
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_fragments(st, kk, p_hi[kk], p_lo[kk]);
      a_fragments(dpt, kk, ds_hi[kk], ds_lo[kk]);
    }
#pragma unroll
    for (int x = 0; x < kHalves; ++x) {
      fence_acc(dv_acc[x]);
      fence_acc(dk_acc[x]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < kHalves; ++x) {
        wgmma_rs(dv_acc[x], p_hi[kk], mnmajor(dos, x, kk));
        wgmma_rs(dv_acc[x], p_lo[kk], mnmajor(dos, x, kk));
        wgmma_rs(dk_acc[x], ds_hi[kk], mnmajor(qs, x, kk));
        wgmma_rs(dk_acc[x], ds_lo[kk], mnmajor(qs, x, kk));
      }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int x = 0; x < kHalves; ++x) {
      fence_acc(dv_acc[x]);
      fence_acc(dk_acc[x]);
    }
    __syncthreads();  // every warp is done with buffer s
  }

  bf16* dkh = dk + b * sdk.b + h * sdk.h;
  bf16* dvh = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int x = 0; x < kHalves; ++x) {
    store_acc<D>(dk_acc[x], dkh, sdk.t, k0, x, seq);
    store_acc<D>(dv_acc[x], dvh, sdv.t, k0, x, seq);
  }
}

// ---- K3: dQ --------------------------------------------------------------

template <int D>
struct DqSmem {  // byte offsets from a 1024-aligned base
  static constexpr int kTile = kBlock * padded(D) * 2;
  static constexpr int Q = 0, DO = kTile;
  static constexpr int K = 2 * kTile;  // two buffers
  static constexpr int V = 4 * kTile;  // two buffers
  static constexpr int kBytes = 6 * kTile + 1024;
};

// One block per (b * H + h, q-tile); the q-tile loops over the k-tiles up
// to the causal diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_sm90_kernel(Inputs in, bf16* __restrict__ dq, Strides sdq) {
  using S = DqSmem<D>;
  constexpr int kHalves = padded(D) / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int b = blockIdx.x / in.heads, h = blockIdx.x % in.heads;
  const int qt = gridDim.y - 1 - blockIdx.y;  // causal: heavy q-tiles first
  const int q0 = qt * kBlock;
  const int seq = in.seq;
  const long long row0 = ((long long)b * in.heads + h) * seq;
  const bf16* kh = in.k + b * in.sk.b + h * in.sk.h;
  const bf16* vh = in.v + b * in.sv.b + h * in.sv.h;

  // Causal: k-tiles that start past the q-tile's last row contribute
  // nothing.
  const int n_k = in.causal ? qt + 1 : (seq + kBlock - 1) / kBlock;
  load_tile<D>(base + S::Q, in.q + b * in.sq.b + h * in.sq.h, in.sq.t, q0,
               seq);
  load_tile<D>(base + S::DO, in.dout + b * in.sdo.b + h * in.sdo.h, in.sdo.t,
               q0, seq);
  load_tile<D>(base + S::K, kh, in.sk.t, 0, seq);
  load_tile<D>(base + S::V, vh, in.sv.t, 0, seq);
  cp_async_commit();

  // lse and delta of this thread's two accumulator rows (0 past seq).
  float lse_log2[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = q0 + acc_row(2 * e);
    lse_log2[e] = t < seq ? in.lse[row0 + t] * kLog2e : 0.f;
    dl[e] = t < seq ? in.delta[row0 + t] : 0.f;
  }

  float dq_acc[kHalves][32];
#pragma unroll
  for (int x = 0; x < kHalves; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[x][i] = 0.f;

  const float scale_log2 = in.sm_scale * kLog2e;
  for (int kt = 0, s = 0; kt < n_k; ++kt, s ^= 1) {
    const int k0 = kt * kBlock;
    if (kt + 1 < n_k) {  // the next k-tile into the other buffer
      const int n = s ^ 1;
      load_tile<D>(base + S::K + n * S::kTile, kh, in.sk.t, k0 + kBlock, seq);
      load_tile<D>(base + S::V + n * S::kTile, vh, in.sv.t, k0 + kBlock, seq);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this k-tile has landed
    __syncthreads();
    const uint32_t ks = base + S::K + s * S::kTile;
    const uint32_t vs = base + S::V + s * S::kTile;

    // S = Q.K^T and dP = dO.V^T: rows are queries, columns keys.
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_acc(sc);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk) {
      wgmma_ss(sc, kmajor(base + S::Q, kk), kmajor(ks, kk));
      wgmma_ss(dp, kmajor(base + S::DO, kk), kmajor(vs, kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_acc(sc);
    fence_acc(dp);

    // dS in place of dP; lse and delta are per row (query).
    const bool edge = (in.causal && kt == qt) || q0 + kBlock > seq ||
                      k0 + kBlock > seq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = exp2f(fmaf(sc[i], scale_log2, -lse_log2[e / 2]));
        if (edge) {
          const int qpos = q0 + acc_row(e), kpos = k0 + acc_col(j, e);
          if (qpos >= seq || kpos >= seq || (in.causal && qpos < kpos))
            p = 0.f;
        }
        dp[i] = p * (dp[i] - dl[e / 2]) * in.sm_scale;
      }

    // dQ += dS.K as hi + lo, contracting over the 64 keys.
    uint32_t ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_fragments(dp, kk, ds_hi[kk], ds_lo[kk]);
#pragma unroll
    for (int x = 0; x < kHalves; ++x) fence_acc(dq_acc[x]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < kHalves; ++x) {
        wgmma_rs(dq_acc[x], ds_hi[kk], mnmajor(ks, x, kk));
        wgmma_rs(dq_acc[x], ds_lo[kk], mnmajor(ks, x, kk));
      }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int x = 0; x < kHalves; ++x) fence_acc(dq_acc[x]);
    __syncthreads();  // every warp is done with buffer s
  }

  bf16* dqh = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int x = 0; x < kHalves; ++x)
    store_acc<D>(dq_acc[x], dqh, sdq.t, q0, x, seq);
}

Inputs make_inputs(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   int seq, int heads, const long long* s, float sm_scale,
                   int causal) {
  return Inputs{static_cast<const bf16*>(q),
                static_cast<const bf16*>(k),
                static_cast<const bf16*>(v),
                static_cast<const bf16*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta),
                Strides{s[0], s[1], s[2]},
                Strides{s[3], s[4], s[5]},
                Strides{s[6], s[7], s[8]},
                Strides{s[9], s[10], s[11]},
                seq,
                heads,
                sm_scale,
                causal};
}

template <int D>
cudaError_t launch_dkv(const Inputs& in, void* dk, void* dv, Strides sdk,
                       Strides sdv, int batch, cudaStream_t stream) {
  constexpr int smem = DkvSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * in.heads, (in.seq + kBlock - 1) / kBlock);
  flash_bwd_dkv_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      in, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sdk, sdv);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Inputs& in, void* dq, Strides sdq, int batch,
                      cudaStream_t stream) {
  constexpr int smem = DqSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * in.heads, (in.seq + kBlock - 1) / kBlock);
  flash_bwd_dq_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      in, static_cast<bf16*>(dq), sdq);
  return cudaGetLastError();
}

}  // namespace

// Both entry points take bf16 tensors only. `in_strides` holds the
// (b, t, h) strides, in elements, of q, k, v and dO in that order (12
// values); lse and delta are contiguous fp32 [B, H, T, 1]. Each returns a
// cudaError_t (0 on success); the caller raises on anything else.

// K2: dK and dV.
extern "C" int flash_bwd_dkv_sm90(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int batch, int seq,
                                  int heads, int head_dim,
                                  const long long* in_strides,
                                  long long sdkb, long long sdkt,
                                  long long sdkh, long long sdvb,
                                  long long sdvt, long long sdvh,
                                  float sm_scale, int causal, void* stream) {
  const Inputs in = make_inputs(q, k, v, dout, lse, delta, seq, heads,
                                in_strides, sm_scale, causal);
  const Strides sdk{sdkb, sdkt, sdkh}, sdv{sdvb, sdvt, sdvh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define RTT_CASE(D) \
  case D:           \
    return static_cast<int>(launch_dkv<D>(in, dk, dv, sdk, sdv, batch, st));
    RTT_CASE(8) RTT_CASE(16) RTT_CASE(32) RTT_CASE(64) RTT_CASE(128)
#undef RTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3: dQ.
extern "C" int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int batch,
                                 int seq, int heads, int head_dim,
                                 const long long* in_strides, long long sdqb,
                                 long long sdqt, long long sdqh,
                                 float sm_scale, int causal, void* stream) {
  const Inputs in = make_inputs(q, k, v, dout, lse, delta, seq, heads,
                                in_strides, sm_scale, causal);
  const Strides sdq{sdqb, sdqt, sdqh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define RTT_CASE(D) \
  case D:           \
    return static_cast<int>(launch_dq<D>(in, dq, sdq, batch, st));
    RTT_CASE(8) RTT_CASE(16) RTT_CASE(32) RTT_CASE(64) RTT_CASE(128)
#undef RTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
