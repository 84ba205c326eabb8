// Helpers shared by the generic CIN layer kernels (cin_layer.cu,
// cin_layer_bwd.cu), the transpose (transpose.cu) and the fanout
// (split_fused.cu): bf16 tensor-core
// products with mma.sync (m16n8k16, f32 accumulate), whose fragment layouts
// the PTX ISA documents, fed by ldmatrix from shared memory; cp.async
// copies; and a tile loader that zero-fills what lies outside the matrix.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * group + tig):
//   A [16 x 16] row: a0 (row group, cols 2 tig, +1), a1 (row group + 8),
//                    a2 (row group, cols 2 tig + 8, +9), a3 (row group + 8)
//   B [16 x 8] col:  b0 (rows 2 tig, +1; col group), b1 (rows 2 tig + 8, +9)
//   C [16 x 8] f32:  c0, c1 (row group, cols 2 tig, +1), c2, c3 (row group + 8)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rm {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices; lane L gives the address of row (L & 7) of
// matrix L / 8. Without .trans, register j holds matrix j's elements (row
// group, cols 2 tig, +1); with .trans, (rows 2 tig, +1; col group).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16 x 16 block at (row0, col0) of a row-major bf16 tile
// in shared memory with leading dimension ld (rows 16-byte aligned).
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld, int row0, int col0,
                                       int lane) {
  ldmatrix_x4(a, s + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// A fragment of the 16 x 16 block of the TRANSPOSE of a row-major tile:
// A[m][k] = s[(k0 + k) * ld + m0 + m].
__device__ __forceinline__ void load_a_trans(uint32_t a[4], const bf16* s, int ld, int m0, int k0,
                                             int lane) {
  ldmatrix_x4_trans(a, s + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * ld + m0 +
                           ((lane >> 3) & 1) * 8);
}

// B fragments of two 16 x 8 blocks (cols n0..n0+7 and n0+8..n0+15) of a
// row-major [k][n] tile: b[0], b[1] for the first, b[2], b[3] the second.
__device__ __forceinline__ void load_b_kn(uint32_t b[4], const bf16* s, int ld, int k0, int n0,
                                          int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// The same from a row-major [n][k] tile (B's columns stored as rows).
__device__ __forceinline__ void load_b_nk(uint32_t b[4], const bf16* s, int ld, int k0, int n0,
                                          int lane) {
  ldmatrix_x4(b, s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// The first `bytes` (0 to 16) of the 16 at src; the rest of dst is zeroed.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows x cols (cols a multiple of 8) of a row-major bf16 matrix g with
// leading dimension ld into shared memory s (leading dimension lds, 16-byte
// aligned rows); elements at or past (avail_rows, avail_cols) read as 0.
// Where g's rows are 16-byte aligned the copy goes by cp.async (the caller
// waits and synchronises before reading); chunks at the matrix's edge, and
// every chunk of an unaligned g, are stored at once.
__device__ __forceinline__ void stage_tile(bf16* s, int lds, const bf16* __restrict__ g,
                                           long long ld, long long avail_rows, int avail_cols,
                                           int rows, int cols) {
  union Chunk {
    uint4 u;
    bf16 h[8];
  };
  const bool vec = ((reinterpret_cast<uintptr_t>(g) | (uintptr_t)(ld * 2)) & 15) == 0;
  const int chunks = cols >> 3;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    bf16* dst = s + r * lds + c;
    const bf16* src = g + r * ld + c;
    if (vec && r < avail_rows && c + 8 <= avail_cols) {
      cp_async16(dst, src);
      continue;
    }
    Chunk v;
    v.u = make_uint4(0u, 0u, 0u, 0u);
    if (r < avail_rows) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c + j < avail_cols) v.h[j] = src[j];
    }
    *reinterpret_cast<uint4*>(dst) = v.u;
  }
}

// The (lo, hi) bf16 pair of a 32-bit fragment register, widened.
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t x) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&x);
  return __bfloat1622float2(h);
}

}  // namespace rm
