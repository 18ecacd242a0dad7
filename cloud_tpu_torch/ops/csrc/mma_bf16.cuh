// bf16 tensor-core building blocks shared by the flash kernels (sm_80 and
// later, used here on sm_90a): 16-byte cp.async copies into shared memory,
// ldmatrix fragment loads and the m16n8k16 mma.sync product with f32
// accumulators, all as inline PTX.  The paged kernel uses the copies.
//
// Fragment layout of mma.sync.m16n8k16.row.col (lane = 4 * g + t4):
//   A (16 x 16, row major), 4 regs of 2 bf16: a0 (row g, cols 2 t4 + {0, 1}),
//     a1 (row g + 8, same cols), a2 (row g, cols 8 + 2 t4 + {0, 1}),
//     a3 (row g + 8, cols 8 + 2 t4 + {0, 1});
//   B (16 x 8, given as 8 rows of 16 along k), 2 regs: b0 (k 2 t4 + {0, 1},
//     n g), b1 (k 8 + 2 t4 + {0, 1}, n g);
//   C (16 x 8, f32), 4 floats: c0, c1 (row g, cols 2 t4 + {0, 1}), c2, c3
//     (row g + 8, same cols).
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16
// and packed in pairs, are the A fragment of the next product over those
// 16 columns (pack_a below): softmax weights never leave registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (no
// bytes are read then, src only has to be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously, zero-filled when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i, and register i receives this lane's pair of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: a [k][n] tile in shared memory arrives
// as B fragments.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment over columns 16 kk .. 16 kk + 15 from the C fragments of
// the 8-column tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Copy rows [r0, r0 + kRows) of one head ([pos][D] at row stride st, in
// elements) into a [kRows][D + 8] shared tile, 16 bytes a copy by each of
// kThreads threads, zero-filled past T.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long st, int r0, int T) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks, pos = r0 + r;
    const bool ok = pos < T;
    cp_async16(dst + r * (D + 8) + c * 8, src + (ok ? pos * st : 0) + c * 8,
               ok);
  }
}

// Lane offsets into a [rows][stride] bf16 tile for ldsm_x4 (row, col):
//   a_lane: the A fragment of rows r0 .. r0 + 15, cols c0 .. c0 + 15;
//   b_lane: the B fragments of two 8-row tiles (rows r0 .. r0 + 15 are n,
//           cols c0 .. c0 + 15 are k): regs {0, 1} tile 0, {2, 3} tile 1;
//   bt_lane (for ldsm_x4_t): the B fragments of a [k][n] tile, rows
//           r0 .. r0 + 15 are k, cols c0 .. c0 + 15 two 8-wide n tiles.
__device__ __forceinline__ int a_lane_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_lane_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int b_lane_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_lane_col(int lane) {
  return ((lane >> 3) & 1) << 3;
}
__device__ __forceinline__ int bt_lane_row(int lane) {
  return (lane & 7) + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int bt_lane_col(int lane) {
  return (lane >> 4) << 3;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_add(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tc
