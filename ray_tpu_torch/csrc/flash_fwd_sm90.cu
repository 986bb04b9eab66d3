// Flash-attention forward (K1) for Hopper on the tensor cores (wgmma),
// bf16.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_kernel
// (launched by _flash_forward through pl.pallas_call). It computes the
// same function as that kernel and as csrc/flash_fwd.cu (which keeps the
// fp32 route): s = q.k^T * scale, masked scores at -1e30 (keys past T,
// and above the diagonal when causal); an online softmax over k-tiles
// with the running max m, the denominator l and the output sum in fp32;
// tiles above the causal diagonal skipped; l == 0 guarded; O = sum / l
// written in bf16 and lse = m + log(l) as fp32 [B, H, T, 1], the layout
// K2, K3 and ring attention read.
//
// Layout: q, k, v, o are bf16 [B, T, H, D] read and written through
// their (b, t, h) strides with unit stride on D; D is 8, 16, 32, 64 or
// 128 (under 64, tiles are padded to 64 columns in shared memory). The
// caller guarantees 16-byte aligned base pointers and (b, t, h) strides
// that are multiples of 8 elements (cp.async copies 16 bytes).
//
// Numerics. The plain version and the TPU kernel keep p in fp32 and run
// P.V in fp32. One bf16 rounding of p before P.V (as FlashAttention-2/3
// do) moves O by ~10x a two-ulp bf16 allowance; so p is split as p ~ hi
// + lo, hi = bf16(p), lo = bf16(p - hi) (about 16 significant bits), and
// P.V runs on both into the same fp32 sum: 3 tensor-core products where
// the function has 2. q, k, v are bf16 already, so S is exact in fp32.
//
// Design (sm90.cuh holds the swizzle, descriptor, cp.async and fragment
// helpers that K2 and K3 use too):
//  * One block of one warpgroup (128 threads) owns (b, h, 64-row
//    q-tile) and loops over the 64-key k-tiles up to the causal
//    diagonal; heavy causal q-tiles are scheduled first. The tile is 64
//    x 64 at every shape: on an H100, 128 q rows (two warpgroups sharing
//    each K/V tile) tied at the training shape and lost at the prefill
//    shape, and 128-key tiles held more registers, fit fewer blocks per
//    SM and lost at both (PERF.md, Findings).
//  * S = Q.K^T by wgmma m64n64k16, Q and K both K-major from shared
//    memory in the 128-byte swizzled layout. The online softmax runs in
//    the accumulator layout: a thread holds two rows, each row's max
//    reduced over the 4 threads that share it; l stays a per-thread
//    partial sum until the epilogue; O is rescaled by alpha in
//    registers.
//  * P is split hi/lo into wgmma A fragments (the accumulator layout is
//    the A register layout) and O += P_hi.V + P_lo.V by wgmma m64n64k16
//    per 64 columns of D, V read MN-major through the transpose flag: P
//    never goes through shared memory.
//  * Q is staged once; K and V are double buffered with cp.async (rows
//    past T zero-filled by the copy's source size), so the next k-tile's
//    load overlaps this one's products. Nothing crosses blocks.
//
// Ragged T: rows >= T of q, k, v are zero-filled, keys with kpos >= T are
// masked, and no O or lse row >= T is written.
//
// Bound on the H100: at the training shape (16 x 1024 x 16 x 64, bf16,
// causal) the function is 4 B H D T(T+1)/2 ~ 34.4 GFLOP (0.035 ms at
// 989 TFLOP/s) on ~135 MB (q, k, v read once, O and lse written once:
// 0.040 ms at 3.35 TB/s), so bytes bound it; the hi/lo split raises the
// tensor work to ~51.6 GFLOP (0.052 ms), above the bytes. At the prefill
// shape (1 x 512 x 16 x 64) the bound is ~1.3 us of bytes and the kernel
// is bound by latency: 128 64-row q-tiles for 132 SMs, each walking at
// most 8 k-tiles. What holds it back: one warpgroup waits for each group
// of products before its softmax (the tensor cores idle during the exp
// work unless another block on the SM fills in), the split's extra
// products, and no TMA or warp specialisation (later work).

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // ray_tpu/ops/attention.py:_NEG_INF

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // [B, H, T] (the trailing 1 of [B, H, T, 1])
  Strides sq, sk, sv, so;
  int seq, heads;
  float sm_scale;
  int causal;
};

template <int D>
struct FwdSmem {  // byte offsets from a 1024-aligned base
  static constexpr int kTile = kBlock * padded(D) * 2;
  static constexpr int Q = 0;
  static constexpr int K = kTile;             // two buffers
  static constexpr int V = K + 2 * kTile;     // two buffers
  static constexpr int kBytes = V + 2 * kTile + 1024;
};

// One block per (b * H + h, 64-row q-tile), looping over the 64-key
// k-tiles up to the causal diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_sm90_kernel(FwdArgs a) {
  using S = FwdSmem<D>;
  constexpr int kHalves = padded(D) / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int qt = gridDim.y - 1 - blockIdx.y;  // causal: heavy q-tiles first
  const int q0 = qt * kBlock;
  const int seq = a.seq;
  const bf16* kh = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vh = a.v + b * a.sv.b + h * a.sv.h;

  // Causal: k-tiles that start past the q-tile's last row contribute
  // nothing (the TPU kernel's `run` predicate).
  const int k_end = a.causal ? min(seq, q0 + kBlock) : seq;
  const int n_k = (k_end + kBlock - 1) / kBlock;
  load_tile<D>(base + S::Q, a.q + b * a.sq.b + h * a.sq.h, a.sq.t, q0, seq);
  load_tile<D>(base + S::K, kh, a.sk.t, 0, seq);
  load_tile<D>(base + S::V, vh, a.sv.t, 0, seq);
  cp_async_commit();

  // This thread's two accumulator rows: the running max of their raw
  // scores and its share of their denominators.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o_acc[kHalves][32];
#pragma unroll
  for (int x = 0; x < kHalves; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[x][i] = 0.f;

  const float scale_log2 = a.sm_scale * kLog2e;
  for (int kt = 0, s = 0; kt < n_k; ++kt, s ^= 1) {
    const int k0 = kt * kBlock;
    if (kt + 1 < n_k) {  // the next k-tile into the other buffer
      const int n = s ^ 1;
      load_tile<D>(base + S::K + n * S::kTile, kh, a.sk.t, k0 + kBlock, seq);
      load_tile<D>(base + S::V + n * S::kTile, vh, a.sv.t, k0 + kBlock, seq);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this k-tile has landed
    __syncthreads();
    const uint32_t ks = base + S::K + s * S::kTile;
    const uint32_t vs = base + S::V + s * S::kTile;

    // S = Q.K^T: rows are the queries, columns the keys.
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_acc(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk)
      wgmma_ss(sc, kmajor(base + S::Q, kk), kmajor(ks, kk));
    wgmma_commit();
    wgmma_wait();
    fence_acc(sc);

    // Mask, then the new row max over the 4 threads that share a row.
    const bool edge =
        (a.causal && k0 + kBlock - 1 > q0) || k0 + kBlock > seq;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        if (edge) {
          const int qpos = q0 + acc_row(e), kpos = k0 + acc_col(j, e);
          if (kpos >= seq || (a.causal && qpos < kpos)) sc[i] = kNegInf;
        }
        mx[e / 2] = fmaxf(mx[e / 2], sc[i]);
      }
    float alpha[2], m_log2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      m_log2[r] = mx[r] * scale_log2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int x = 0; x < kHalves; ++x)
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[x][i] *= alpha[(i % 4) / 2];

    // P = exp(s * scale - m * scale) in place; a masked score gives 0
    // (key 0 is in every row's first k-tile, so m is a score from then on).
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(fmaf(sc[i], scale_log2, -m_log2[(i % 4) / 2]));
      l[(i % 4) / 2] += p;
      sc[i] = p;
    }

    // O += P.V as hi + lo, contracting over the 64 keys.
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_fragments(sc, kk, p_hi[kk], p_lo[kk]);
#pragma unroll
    for (int x = 0; x < kHalves; ++x) fence_acc(o_acc[x]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < kHalves; ++x) {
        wgmma_rs(o_acc[x], p_hi[kk], mnmajor(vs, x, kk));
        wgmma_rs(o_acc[x], p_lo[kk], mnmajor(vs, x, kk));
      }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int x = 0; x < kHalves; ++x) fence_acc(o_acc[x]);
    __syncthreads();  // every warp is done with buffer s
  }

  // O = sum / l and lse = m * scale + log(l); l == 0 is taken as 1.
  float li[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    li[r] = l[r] == 0.f ? 1.f : l[r];
  }
#pragma unroll
  for (int x = 0; x < kHalves; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[x][i] /= li[(i % 4) / 2];
  bf16* oh = a.o + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int x = 0; x < kHalves; ++x)
    store_acc<D>(o_acc[x], oh, a.so.t, q0, x, seq);
  if (threadIdx.x % 4 == 0) {
    const long long row0 = ((long long)b * a.heads + h) * seq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + acc_row(2 * r);
      if (t < seq) a.lse[row0 + t] = m[r] * a.sm_scale + logf(li[r]);
    }
  }
}

template <int D>
cudaError_t launch(const FwdArgs& a, int batch, cudaStream_t stream) {
  constexpr int smem = FwdSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.heads, (a.seq + kBlock - 1) / kBlock);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. Strides are in elements. Returns a cudaError_t (0 on
// success); the caller raises on anything else.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              void* o, void* lse, int batch, int seq,
                              int heads, int head_dim, long long sqb,
                              long long sqt, long long sqh, long long skb,
                              long long skt, long long skh, long long svb,
                              long long svt, long long svh, long long sob,
                              long long sot, long long soh, float sm_scale,
                              int causal, void* stream) {
  const FwdArgs a{static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v),
                  static_cast<bf16*>(o),
                  static_cast<float*>(lse),
                  Strides{sqb, sqt, sqh},
                  Strides{skb, skt, skh},
                  Strides{svb, svt, svh},
                  Strides{sob, sot, soh},
                  seq,
                  heads,
                  sm_scale,
                  causal};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define RTT_CASE(D) \
  case D:           \
    return static_cast<int>(launch<D>(a, batch, st));
    RTT_CASE(8) RTT_CASE(16) RTT_CASE(32) RTT_CASE(64) RTT_CASE(128)
#undef RTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_fwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
