// Flash-attention backward for Hopper, CUDA C++ with scalar FMAs: K2
// (dK, dV) and K3 (dQ).
//
// Replaces the TPU kernels ray_tpu/ops/attention.py:_flash_bwd_dkv_kernel
// (K2) and _flash_bwd_dq_kernel (K3), both launched by _flash_backward
// through pl.pallas_call, with their shared recompute _bwd_tiles. They
// compute the same function: q, k, v and dO taken to fp32; s = q.k^T *
// scale with masked scores at -1e30; p = exp(s - lse); dp = dO.v^T;
// ds = p * (dp - delta) * scale; dV = p^T.dO and dK = ds^T.q (K2), dQ =
// ds.k (K3), all accumulated in fp32 and written in the input dtype.
// lse (from K1) and delta = rowsum(dO * O) are fp32 [B, H, T, 1].
//
// Layout: q, k, v, dO, dQ, dK, dV are [B, T, H, D] read and written
// through their (b, t, h) strides with unit stride on D, as K1 does.
// dtype is fp32 (D 8, 16, 32, 64 or 128) or bf16 (D 64 or 128); anything
// else is refused. D = 8 is padded to 16 columns in shared memory (zeros),
// since a thread owns output columns 16 apart; the padding is never
// written back.
//
// Design: the TPU runs the reduction axis as the innermost, sequential
// grid axis and carries the sums in VMEM scratch. GPU blocks run in
// parallel and in no order, so each block owns its output tile and loops
// over the reduction axis itself; nothing crosses blocks (no atomics, the
// sums are deterministic).
//  * K2: one block of 256 threads per (b, h, 64-row k-tile). It stages
//    its K and V tiles once, then loops over the 64-row q-tiles from the
//    first that reaches the causal diagonal to the end, staging Q, dO,
//    lse and delta for each. dK and dV stay in fp32 registers.
//  * K3: one block per (b, h, 64-row q-tile). It stages Q, dO, lse and
//    delta once and loops over the k-tiles up to the diagonal. dQ stays
//    in fp32 registers. Heavy causal q-tiles are scheduled first.
// Thread (ty, tx) of a 16 x 16 block recomputes rows ty + 16 i and
// columns tx + 16 j (i, j < 4) of the score tile. The p and ds tiles go
// through shared memory to the products that contract over q (K2) or k
// (K3), where the thread owns output rows ty + 16 i and columns tx + 16 c.
// Tiles are staged as fp32, rows padded by one float so that column reads
// hit distinct banks: K2 needs 100 KB at D=64 and 166 KB at D=128, K3
// 84 KB and 149 KB, hence the dynamic shared-memory attribute.
//
// Ragged T: rows >= T of q, k, v and dO are zero-filled, pairs with
// qpos >= T or kpos >= T get p = ds = 0, lse and delta are never read past
// T (K1 does not write those rows), and no row >= T is written.
//
// Bound on the H100: at the training shape (16 x 1024 x 16 x 64, bf16,
// causal) K2 does 8 * B * H * D * T(T+1)/2 ~ 69 GFLOP (0.070 ms of bf16
// tensor-core time at 989 TFLOP/s) and moves ~203 MB (0.061 ms at
// 3.35 TB/s); K3 does ~52 GFLOP (0.052 ms) on ~170 MB (0.051 ms). Both
// are bound by operations. This simple design runs its products as
// scalar fp32 FMAs out of shared memory (no tensor cores, no wgmma, no
// TMA, no cp.async pipelining), so it is far from that bound; making it
// fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;          // rows of a q-tile and of a k-tile
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kRows = kBlock / 16;  // tile rows (and columns) per thread

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Inputs shared by both kernels, all pointing at head (0, 0).
template <typename T>
struct BwdInputs {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;    // [B, H, T] (the trailing 1 of [B, H, T, 1])
  const float* delta;  // [B, H, T]
  Strides sq, sk, sv, sdo;
  int seq, heads;
  float sm_scale;
  int causal;
};

// Columns of a tile of head_dim D in shared memory.
__host__ __device__ constexpr int padded(int d) { return d < 16 ? 16 : d; }

// Rows [t0, t0 + 64) of one head of x into dst[64][ld] as fp32; rows past
// seq and the padding columns past D are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* head,
                                          long long stride_t, int t0,
                                          int seq) {
  constexpr int DP = padded(D);
  constexpr int LD = DP + 1;
  for (int i = threadIdx.x; i < kBlock * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, t = t0 + r;
    dst[r * LD + d] =
        t < seq && d < D ? to_float(head[t * stride_t + d]) : 0.f;
  }
}

// lse and delta of rows [t0, t0 + 64) of one head; 0 past seq (the masks
// below zero every pair of those rows, so the value is never used).
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int t0,
                                          int seq) {
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    const int t = t0 + i;
    lse_s[i] = t < seq ? lse[t] : 0.f;
    delta_s[i] = t < seq ? delta[t] : 0.f;
  }
}

// The recompute of _bwd_tiles for this thread's 4 x 4 pairs of the
// (q-tile q0, k-tile k0) tile: p and ds (scale folded into ds).
template <int D>
__device__ __forceinline__ void bwd_tile(
    const float* qs, const float* ks, const float* vs, const float* dos,
    const float* lse_s, const float* delta_s, int q0, int k0, int seq,
    float sm_scale, int causal, float (&p)[kRows][kRows],
    float (&ds)[kRows][kRows]) {
  constexpr int LD = padded(D) + 1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float s[kRows][kRows], dp[kRows][kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kRows; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[kRows], dov[kRows], kv[kRows], vv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      qv[i] = qs[(ty + 16 * i) * LD + d];
      dov[i] = dos[(ty + 16 * i) * LD + d];
      kv[i] = ks[(tx + 16 * i) * LD + d];
      vv[i] = vs[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    const float l = lse_s[ty + 16 * i];
    const float dl = delta_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int kpos = k0 + tx + 16 * j;
      // the TPU kernel masks a score to -1e30 (_NEG_INF), and
      // exp(-1e30 - lse) is exactly 0
      const bool keep =
          qpos < seq && kpos < seq && (!causal || qpos >= kpos);
      const float pij = keep ? expf(s[i][j] * sm_scale - l) : 0.f;
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - dl) * sm_scale;
    }
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO tiles; p and ds tiles; lse and delta rows
  return sizeof(float) * (4 * kBlock * (padded(D) + 1) +
                          2 * kBlock * (kBlock + 1) + 2 * kBlock);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles; ds tile; lse and delta rows
  return sizeof(float) *
         (4 * kBlock * (padded(D) + 1) + kBlock * (kBlock + 1) + 2 * kBlock);
}

// K2: dK, dV of one (b, h, k-tile), looping over q-tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(BwdInputs<T> in, T* __restrict__ dk,
                     T* __restrict__ dv, Strides sdk, Strides sdv) {
  constexpr int LD = padded(D) + 1;
  constexpr int LP = kBlock + 1;
  constexpr int kOut = padded(D) / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* ks = smem;               // [kBlock][LD]
  float* vs = ks + kBlock * LD;   // [kBlock][LD]
  float* qs = vs + kBlock * LD;   // [kBlock][LD]
  float* dos = qs + kBlock * LD;  // [kBlock][LD]
  float* ps = dos + kBlock * LD;  // [q][k], [kBlock][LP]
  float* dss = ps + kBlock * LP;  // [q][k], [kBlock][LP]
  float* lse_s = dss + kBlock * LP;
  float* delta_s = lse_s + kBlock;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kBlock;  // causal: heavy k-tiles come first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = in.seq;
  const long long row0 = ((long long)b * in.heads + h) * seq;

  const T* qh = in.q + b * in.sq.b + h * in.sq.h;
  const T* doh = in.dout + b * in.sdo.b + h * in.sdo.h;
  load_tile<T, D>(ks, in.k + b * in.sk.b + h * in.sk.h, in.sk.t, k0, seq);
  load_tile<T, D>(vs, in.v + b * in.sv.b + h * in.sv.h, in.sv.t, k0, seq);

  float dk_acc[kRows][kOut], dv_acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kOut; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // Causal: q-tiles that end before k0 see none of this k-tile (the TPU
  // kernel's `run` predicate); the tiles are aligned, so start at k0's.
  const int n_q = (seq + kBlock - 1) / kBlock;
  for (int qt = in.causal ? k0 / kBlock : 0; qt < n_q; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();  // the previous q-tile's readers are done
    load_tile<T, D>(qs, qh, in.sq.t, q0, seq);
    load_tile<T, D>(dos, doh, in.sdo.t, q0, seq);
    load_rows(lse_s, delta_s, in.lse + row0, in.delta + row0, q0, seq);
    __syncthreads();

    float p[kRows][kRows], ds[kRows][kRows];
    bwd_tile<D>(qs, ks, vs, dos, lse_s, delta_s, q0, k0, seq, in.sm_scale,
                in.causal, p, ds);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p[i][j];
        dss[(ty + 16 * i) * LP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // dV[kr] += sum_q p[q][kr] dO[q]; dK[kr] += sum_q ds[q][kr] Q[q]
#pragma unroll 4
    for (int qq = 0; qq < kBlock; ++qq) {
      float pv[kRows], dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = ps[qq * LP + ty + 16 * i];
        dsv[i] = dss[qq * LP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float o = dos[qq * LD + tx + 16 * c];
        const float x = qs[qq * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          dv_acc[i][c] = fmaf(pv[i], o, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], x, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= seq) continue;
    T* dkrow = dk + b * sdk.b + t * sdk.t + h * sdk.h;
    T* dvrow = dv + b * sdv.b + t * sdv.t + h * sdv.h;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      if (tx + 16 * c >= D) continue;
      dkrow[tx + 16 * c] = from_float<T>(dk_acc[i][c]);
      dvrow[tx + 16 * c] = from_float<T>(dv_acc[i][c]);
    }
  }
}

// K3: dQ of one (b, h, q-tile), looping over k-tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(BwdInputs<T> in, T* __restrict__ dq, Strides sdq) {
  constexpr int LD = padded(D) + 1;
  constexpr int LP = kBlock + 1;
  constexpr int kOut = padded(D) / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [kBlock][LD]
  float* dos = qs + kBlock * LD;  // [kBlock][LD]
  float* ks = dos + kBlock * LD;  // [kBlock][LD]
  float* vs = ks + kBlock * LD;   // [kBlock][LD]
  float* dss = vs + kBlock * LD;  // [q][k], [kBlock][LP]
  float* lse_s = dss + kBlock * LP;
  float* delta_s = lse_s + kBlock;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;  // heavy first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = in.seq;
  const long long row0 = ((long long)b * in.heads + h) * seq;

  const T* kh = in.k + b * in.sk.b + h * in.sk.h;
  const T* vh = in.v + b * in.sv.b + h * in.sv.h;
  load_tile<T, D>(qs, in.q + b * in.sq.b + h * in.sq.h, in.sq.t, q0, seq);
  load_tile<T, D>(dos, in.dout + b * in.sdo.b + h * in.sdo.h, in.sdo.t, q0,
                  seq);
  load_rows(lse_s, delta_s, in.lse + row0, in.delta + row0, q0, seq);

  float dq_acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kOut; ++c) dq_acc[i][c] = 0.f;

  // Causal: k-tiles that start past the q-tile's last row contribute
  // nothing.
  const int k_end = in.causal ? min(seq, q0 + kBlock) : seq;
  const int n_k = (k_end + kBlock - 1) / kBlock;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous k-tile's readers are done
    load_tile<T, D>(ks, kh, in.sk.t, k0, seq);
    load_tile<T, D>(vs, vh, in.sv.t, k0, seq);
    __syncthreads();

    float p[kRows][kRows], ds[kRows][kRows];
    bwd_tile<D>(qs, ks, vs, dos, lse_s, delta_s, q0, k0, seq, in.sm_scale,
                in.causal, p, ds);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        dss[(ty + 16 * i) * LP + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dQ[qr] += sum_k ds[qr][k] K[k]
#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = dss[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float x = ks[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          dq_acc[i][c] = fmaf(dsv[i], x, dq_acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq) continue;
    T* dqrow = dq + b * sdq.b + t * sdq.t + h * sdq.h;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      if (tx + 16 * c < D) dqrow[tx + 16 * c] = from_float<T>(dq_acc[i][c]);
  }
}

template <typename T>
BwdInputs<T> make_inputs(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, int seq, int heads,
                         const long long* s, float sm_scale, int causal) {
  return BwdInputs<T>{static_cast<const T*>(q),
                      static_cast<const T*>(k),
                      static_cast<const T*>(v),
                      static_cast<const T*>(dout),
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

template <typename T, int D>
cudaError_t launch_dkv(const BwdInputs<T>& in, void* dk, void* dv,
                       Strides sdk, Strides sdv, int batch,
                       cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((in.seq + kBlock - 1) / kBlock, in.heads, batch);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      in, static_cast<T*>(dk), static_cast<T*>(dv), sdk, sdv);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const BwdInputs<T>& in, void* dq, Strides sdq,
                      int batch, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((in.seq + kBlock - 1) / kBlock, in.heads, batch);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      in, static_cast<T*>(dq), sdq);
  return cudaGetLastError();
}

}  // namespace

// Both entry points: dtype 0 = fp32, 1 = bf16. `in_strides` holds the
// (b, t, h) strides, in elements, of q, k, v and dO in that order (12
// values); lse and delta are contiguous fp32 [B, H, T, 1]. Each returns a
// cudaError_t (0 on success); the caller raises on anything else.

// K2: dK and dV.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             int batch, int seq, int heads, int head_dim,
                             const long long* in_strides, long long sdkb,
                             long long sdkt, long long sdkh, long long sdvb,
                             long long sdvt, long long sdvh, float sm_scale,
                             int causal, int dtype, void* stream) {
  const Strides sdk{sdkb, sdkt, sdkh}, sdv{sdvb, sdvt, sdvh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RTT_LAUNCH(T, D)                                                   \
  return static_cast<int>(launch_dkv<T, D>(                                \
      make_inputs<T>(q, k, v, dout, lse, delta, seq, heads, in_strides,    \
                     sm_scale, causal),                                    \
      dk, dv, sdk, sdv, batch, st))
  if (dtype == 0 && head_dim == 8) RTT_LAUNCH(float, 8);
  if (dtype == 0 && head_dim == 16) RTT_LAUNCH(float, 16);
  if (dtype == 0 && head_dim == 32) RTT_LAUNCH(float, 32);
  if (dtype == 0 && head_dim == 64) RTT_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) RTT_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) RTT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) RTT_LAUNCH(__nv_bfloat16, 128);
#undef RTT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3: dQ.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int batch, int seq,
                            int heads, int head_dim,
                            const long long* in_strides, long long sdqb,
                            long long sdqt, long long sdqh, float sm_scale,
                            int causal, int dtype, void* stream) {
  const Strides sdq{sdqb, sdqt, sdqh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RTT_LAUNCH(T, D)                                                   \
  return static_cast<int>(launch_dq<T, D>(                                 \
      make_inputs<T>(q, k, v, dout, lse, delta, seq, heads, in_strides,    \
                     sm_scale, causal),                                    \
      dq, sdq, batch, st))
  if (dtype == 0 && head_dim == 8) RTT_LAUNCH(float, 8);
  if (dtype == 0 && head_dim == 16) RTT_LAUNCH(float, 16);
  if (dtype == 0 && head_dim == 32) RTT_LAUNCH(float, 32);
  if (dtype == 0 && head_dim == 64) RTT_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) RTT_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) RTT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) RTT_LAUNCH(__nv_bfloat16, 128);
#undef RTT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
