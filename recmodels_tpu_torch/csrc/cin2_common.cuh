// What the fused CIN kernels (cin2.cu, cin2_bwd.cu) share: their limits,
// the padded pair layout, and two launchers defined in cin2.cu that both
// directions use (a weight re-layout and a bf16 GEMM on the tensor cores).
// The CIN layer's kernels (cin_layer.cu, cin_layer_bwd.cu) take kTileRows,
// kConsumers, kMaxSmem and the re-layout from here, and share the host-side
// plan of their inputs as TMA reads them (TmaRows, Scratch, tma_copy).
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

// ------------------------------------------------- inputs as TMA reads them
// A row-major bf16 matrix [outer][inner] is read by TMA as it lies when its
// base is 16-byte aligned and its row pitch a multiple of 8 elements; else a
// re-layout launch first copies it into scratch with rows padded to a
// multiple of 8 (zeros past `inner`).
inline bool tma_ready(const void* p, long long pitch) {
  return ((reinterpret_cast<uintptr_t>(p) & 15) == 0) && pitch % 8 == 0;
}

inline int multiprocessors(int device, int* sms) {
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

struct TmaRows {
  const bf16* src;
  long long outer, pitch;  // pitch: of the matrix TMA reads
  int inner;
  bool copy;               // read from a padded copy at `off` in scratch
  size_t off;
  const bf16* at(unsigned char* scratch) const { return copy ? (const bf16*)(scratch + off) : src; }
};

// Scratch laid out piece by piece, each piece 1024-byte aligned.
struct Scratch {
  size_t total = 0;
  size_t take(size_t bytes) {
    const size_t off = total;
    total += align1k(bytes);
    return off;
  }
  TmaRows rows(const void* p, long long outer, int inner) {
    TmaRows r{(const bf16*)p, outer, inner, inner, false, 0};
    if (!tma_ready(p, inner)) {
      r.copy = true;
      r.pitch = (inner + 7) / 8 * 8;
      r.off = take((size_t)outer * r.pitch * 2);
    }
    return r;
  }
};

// The padded copies of the inputs that need one, in pieces of fewer than
// 2^31 elements, four to a re-layout launch.
inline int tma_copy(const TmaRows* in, int n, unsigned char* scratch, cudaStream_t st) {
  Perm jobs[4];
  int njobs = 0;
  for (int k = 0; k < n; ++k) {
    const TmaRows& r = in[k];
    if (!r.copy) continue;
    const long long piece = 0x7fffffffLL / r.pitch;
    for (long long r0 = 0; r0 < r.outer; r0 += piece) {
      const int nr = (int)(r.outer - r0 < piece ? r.outer - r0 : piece);
      jobs[njobs++] = Perm{r.src + r0 * r.inner, (bf16*)(scratch + r.off) + r0 * r.pitch, 1, nr,
                           (int)r.pitch, 1, nr, r.inner, 0, r.inner, 1};
      if (njobs == 4) {
        const int e = cin2_permute(jobs, njobs, st);
        if (e) return e;
        njobs = 0;
      }
    }
  }
  return njobs ? cin2_permute(jobs, njobs, st) : 0;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

}  // namespace rm
