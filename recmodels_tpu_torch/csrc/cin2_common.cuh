// What the fused CIN kernels (cin2.cu, cin2_bwd.cu) share: their limits,
// the padded pair layout, and two launchers defined in cin2.cu that both
// directions use (a weight re-layout and a bf16 GEMM on the tensor cores).
// The CIN layer's backward (cin_layer_bwd.cu) takes kTileRows, kConsumers,
// kMaxSmem and the re-layout (cin2_permute, Perm) from here.
//
// Pairs (h, i) of fields are laid out h-major with i padded to kPairPad =
// 32: pair (h, i) is column h * 32 + i, and columns with i >= m are zero.
// A run of 16 pair columns then shares its field h, so a thread forms its
// pair products from one value x0[r, h] and the x0[r, i] it keeps in
// registers, and the backward's folds over h and over i stay in a thread's
// registers (cin2_bwd.cu). The padding costs 32 / m more tensor-core work
// (1.23x at m = 26) and nothing else.

#pragma once

#include "wgmma_sm90.cuh"

namespace rm {

constexpr int kPairPad = 32;       // i padded to 32: m <= 32
constexpr int kMaxSlots = 32;      // rows of an example held in a tile: d <= 32
constexpr int kTileRows = 128;     // rows (slots) per tile: two warpgroups of 64
constexpr int kConsumers = 256;    // threads of the two consumer warpgroups
constexpr int kBlockThreads = kConsumers + 32;  // and one producer warp
constexpr size_t kMaxSmem = 232448;

// slots per example: d rows, padded to 16 or 32 so that a tile of 128
// slots holds whole examples
__host__ __device__ inline int cin2_slots(int d) { return d <= 16 ? 16 : 32; }

__host__ __device__ inline size_t align1k(size_t x) { return (x + 1023) & ~(size_t)1023; }

// out[o0][o1][o2] = (o0 < lim0 && o1 < lim1 && o2 < lim2) ? in[o0 s0 + o1 s1 + o2 s2] : 0
struct Perm {
  const bf16* in;
  bf16* out;
  int n0, n1, n2, lim0, lim1, lim2;
  long long s0, s1, s2;
};

// x0 [b*d, m] as row slots [tiles * 128, 32]: example e's rows in slots
// e * slots + s, s < d, fields padded to 32, every other slot zero. The
// kernels then read a tile's x0 as 64-byte rows (16-byte vectors, TMA).
inline Perm x0_slot_job(const bf16* x0, bf16* out, int b, int d, int m, int slots, int tiles) {
  return Perm{x0, out, tiles * (kTileRows / slots), slots, kPairPad, b, d, m,
              (long long)d * m, m, 1};
}

// Up to four re-layouts in one launch (each under 2^31 elements, n2 a
// multiple of 8; outputs 16-byte aligned).
int cin2_permute(const Perm* jobs, int njobs, cudaStream_t st);

// c [m, n] = bf16(a [m, k] . b [n, k]^T), f32 accumulate; a, b, c row-major
// bf16 with row pitches k, k and n (k and n multiples of 8, pointers 16-byte
// aligned).
int cin2_gemm_tn(const bf16* a, const bf16* b, bf16* c, long long m, int n, int k, cudaStream_t st);

// A tile of 128 row slots of x0 (x0_slot_job's layout) into shared memory
// with row stride ld: two 16-byte vectors a consumer thread.
__device__ __forceinline__ void load_x0_tile(bf16* s, int ld, const bf16* __restrict__ tile, int tid) {
#pragma unroll
  for (int k = 0; k < kTileRows * kPairPad / 8 / kConsumers; ++k) {
    const int v = tid + k * kConsumers;
    *reinterpret_cast<uint4*>(s + (v >> 2) * ld + (v & 3) * 8) =
        *reinterpret_cast<const uint4*>(tile + v * 8);
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

}  // namespace rm
