// Helpers shared by the Hopper tensor-core flash kernels (bf16, wgmma):
// K1 in flash_fwd_sm90.cu, K2 and K3 in flash_bwd_sm90.cu.
//
// * Tiles sit in shared memory in wgmma's 128-byte swizzled layout: a
//   tile of 64 rows x D bf16 columns is D/64 sub-tiles of [64 rows][64
//   columns], each row 128 bytes with its 16-byte chunks XOR-ed by
//   (row % 8). One layout serves both ways a tile is read: K-major
//   (contracting over D) and MN-major (contracting over the rows, with
//   wgmma's transpose flag).
//   A head_dim under 64 (8, 16 or 32) is padded to one sub-tile: its
//   columns past D are zero-filled, so the products over them add
//   nothing, and they are never written back.
// * cp.async copies 16 bytes a thread into the swizzled address; rows
//   past the sequence are zero-filled by the copy's source size.
// * Products are wgmma.mma_async with bf16 inputs and fp32 sums; an
//   accumulator is also, two columns to a register, the register layout
//   of wgmma's A operand, so a score tile feeds the next product without
//   going back through shared memory (split hi + lo where the function
//   keeps it in fp32).
//
// Every helper is in an anonymous namespace: each kernel source is its
// own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlock = 64;                    // rows of a wgmma tile
constexpr int kThreads = 128;                 // one warpgroup
constexpr int kSubTile = kBlock * 64 * 2;     // bytes of a [64][64] bf16
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async ------------------------------------------------------------

// 16 bytes global -> shared; zero-filled when !valid (source size 0).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N groups are in flight, then make this thread's
// copies visible to wgmma (which reads shared memory through the async
// proxy); a __syncthreads() after it covers the other threads' copies.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Columns of a tile of head_dim D in shared memory: D, or one 64-wide
// sub-tile when D < 64.
__host__ __device__ constexpr int padded(int d) { return d < 64 ? 64 : d; }

// Byte offset of 16-byte chunk c (of D / 8) of row r in a swizzled tile.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c / 8) * kSubTile + r * 128 + (((c % 8) ^ (r % 8)) * 16);
}

// Rows [t0, t0 + 64) of one head into the swizzled tile at dst; rows past
// seq and the padding columns past D are zero.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* head,
                                          long long stride_t, int t0,
                                          int seq) {
  constexpr int kChunks = padded(D) / 8;
#pragma unroll
  for (int n = 0; n < kBlock * kChunks / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const int t = t0 + r;
    const bool valid = t < seq && c < D / 8;
    const bf16* src = head + (valid ? t * stride_t + c * 8 : 0);
    cp_async_16(dst + swizzled(r, c), src, valid);
  }
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B. 8-row groups are 1024 bytes apart (SBO). K-major operands
// never cross a swizzle atom along K in one k16 step, so their LBO is
// unused (1, as CUTLASS sets it); MN-major operands here are one 64-wide
// atom in N, and their LBO is set to the 8-row stride too.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Step kk (16 columns of D) of a tile read K-major.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * kSubTile + (kk % 4) * 32, 16);
}

// Step kk (rows [16 kk, 16 kk + 16)) of the 64 columns [64 half, 64 half
// + 64) of a tile read MN-major.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int half,
                                            int kk) {
  return smem_desc(tile + half * kSubTile + kk * 16 * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products (the asm statements do not show the wait).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RTT_ACC32                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),       \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),   \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),   \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),   \
      "+f"(d[31])

#define RTT_D32                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// d[64 x 64] += A[64 x 16] . B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RTT_ACC32
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A from registers (wgmma's A
// fragment), B MN-major in shared memory (transposed read).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RTT_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef RTT_D32
#undef RTT_ACC32

// Accumulator layout of a 64 x 64 fp32 wgmma result, thread t of the
// warpgroup: d[4 j + e] is row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2),
// column 8 j + 2 (t % 4) + e % 2.
__device__ __forceinline__ int acc_row(int e) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int acc_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x % 4) + e % 2;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 ~ hi + lo, each a pair of bf16.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = bf16x2(x0 - hf.x, x1 - hf.y);
}

// Columns [16 kk, 16 kk + 16) of an accumulator as the A fragments (hi
// and lo) of one k16 step: wgmma's A layout is the accumulator's, two
// columns to a register.
__device__ __forceinline__ void a_fragments(const float (&d)[32], int kk,
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    split(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1], hi[r], lo[r]);
}

// Writes rows [t0, t0 + 64) (those below seq) of columns [64 half, 64 half
// + 64) (those below D) of one head from an accumulator, in bf16.
template <int D>
__device__ __forceinline__ void store_acc(const float (&d)[32], bf16* head,
                                          long long stride_t, int t0,
                                          int half, int seq) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int t = t0 + acc_row(e);
      if (t < seq && 64 * half + 8 * j < D)
        *reinterpret_cast<uint32_t*>(head + t * stride_t + 64 * half +
                                     acc_col(j, e)) =
            bf16x2(d[4 * j + e], d[4 * j + e + 1]);
    }
}

}  // namespace
