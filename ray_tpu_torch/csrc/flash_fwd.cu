// Flash-attention forward (K1) for Hopper, CUDA C++ with scalar FMAs:
// the fp32 route (bf16 runs the tensor-core kernel of
// flash_fwd_sm90.cu; TF32 tensor cores could not hold fp32's tolerance).
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_kernel (launched
// by _flash_forward through pl.pallas_call). It computes the same function:
// blockwise online-softmax attention, causal or not; running max m,
// denominator l and accumulator kept in fp32; tiles above the causal
// diagonal skipped; masked scores set to -1e30; l == 0 guarded; O written
// in fp32 and lse = m + log(l) as fp32 [B, H, T, 1].
//
// Layout: q, k, v, o are [B, T, H, D] read and written through their
// (b, t, h) strides with unit stride on D, so no transpose copy is made.
// dtype is fp32, D is 8, 16, 32, 64 or 128; anything else is refused.
// D = 8 is padded to 16 columns in shared memory (zeros), since a thread
// owns output columns 16 apart; the padding is never written back.
//
// Design: one thread block of 256 threads per (b, h, 64-row q-tile). The
// block loops over 64-row k-tiles itself (the TPU's sequential ki grid
// axis becomes this loop, since blocks run in parallel and in no order on
// the GPU), stops at the causal diagonal and masks the ragged tail of T.
// Q, K, V and the probability tile P are staged in shared memory as fp32
// (66 KB at D=64, 113 KB at D=128, hence the dynamic shared-memory
// attribute). Thread (ty, tx) owns rows ty + 16 i (i < 4) of both the
// score tile (columns tx + 16 j, j < 4) and the output accumulator
// (columns tx + 16 c), so each row's max and sum reduce across the 16
// lanes that share ty with warp shuffles and the rescale by alpha stays in
// registers. Heavy causal q-tiles are scheduled first.
//
// Bound on the H100: at the prefill width in fp32 (1 x 512 x 16 x 64,
// causal) the function needs 4 * H * D * T(T+1)/2 ~ 0.54 GFLOP (~8 us
// at 67 TFLOP/s of fp32 FMAs) on ~8.4 MB (~2.5 us at 3.35 TB/s), so it
// is bound by operations. This simple design runs its products as
// scalar fp32 FMAs out of shared memory (no TMA, no cp.async
// pipelining); fp32 models run it, not the bf16 main paths.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kRows = kBlockQ / 16; // rows per thread
constexpr int kCols = kBlockK / 16; // score columns per thread
constexpr float kNegInf = -1e30f;   // ray_tpu/ops/attention.py:_NEG_INF

struct Strides {
  long long b, t, h;
};

// Columns of a tile of head_dim D in shared memory.
__host__ __device__ constexpr int padded(int d) { return d < 16 ? 16 : d; }

template <int D>
constexpr size_t smem_bytes() {
  // Q and K rows padded by one float so column reads hit distinct banks.
  constexpr int DP = padded(D);
  return sizeof(float) * (2 * kBlockQ * (DP + 1) + kBlockK * DP +
                          kBlockQ * (kBlockK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int seq, int heads, Strides sq,
                 Strides sk, Strides sv, Strides so, float sm_scale,
                 int causal) {
  constexpr int DP = padded(D);
  constexpr int LD = DP + 1;
  constexpr int LP = kBlockK + 1;
  constexpr int kOut = DP / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                // [kBlockQ][LD]
  float* ks = qs + kBlockQ * LD;   // [kBlockK][LD]
  float* vs = ks + kBlockK * LD;   // [kBlockK][DP]
  float* ps = vs + kBlockK * DP;   // [kBlockQ][LP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < kBlockQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, t = q0 + r;
    qs[r * LD + d] = t < seq && d < D ? qb[t * sq.t + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  // Causal: k-tiles that start past the q-tile's last row contribute
  // nothing (the TPU kernel's `run` predicate).
  const int k_end = causal ? min(seq, q0 + kBlockQ) : seq;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // previous tile's readers are done with ks, vs, ps
    for (int i = tid; i < kBlockK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP, t = k0 + r;
      const bool in = t < seq && d < D;
      ks[r * LD + d] = in ? kb[t * sk.t + d] : 0.f;
      vs[r * DP + d] = in ? vb[t * sv.t + d] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = kpos < seq && (!causal || qpos >= kpos);
        s[i][j] = keep ? s[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float row = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        row += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row += __shfl_xor_sync(0xffffffffu, row, off);
      l[i] = l[i] * alpha + row;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float x = vs[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], x, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + b * so.b + t * so.t + h * so.h;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      if (tx + 16 * c < D) orow[tx + 16 * c] = acc[i][c] / li;
    if (tx == 0) lse[((long long)b * heads + h) * seq + t] = m[i] + logf(li);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int seq, int heads, Strides sq,
                   Strides sk, Strides sv, Strides so, float sm_scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse),
      seq, heads, sq, sk, sv, so, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32 (the only one taken; bf16 has its own kernel in
// flash_fwd_sm90.cu). Strides are in elements. Returns a cudaError_t (0
// on success); the caller raises on anything else.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int batch, int seq, int heads,
                         int head_dim, long long sqb, long long sqt,
                         long long sqh, long long skb, long long skt,
                         long long skh, long long svb, long long svt,
                         long long svh, long long sob, long long sot,
                         long long soh, float sm_scale, int causal, int dtype,
                         void* stream) {
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh},
      so{sob, sot, soh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
#define RTT_CASE(D)                                                        \
  case D:                                                                  \
    return static_cast<int>(launch<D>(q, k, v, o, lse, batch, seq, heads,  \
                                      sq, sk, sv, so, sm_scale, causal, st));
    RTT_CASE(8) RTT_CASE(16) RTT_CASE(32) RTT_CASE(64) RTT_CASE(128)
#undef RTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
