// The sparse table update from a sorted id stream with duplicates, shared by
// csrc/adagrad_update.cu and csrc/adam_update.cu: one kernel template over
// the optimizer's element step (Op::apply, on one column of each state
// array), the grads' type, the columns a thread takes at once (V), the
// elements it holds in flight (K) and where the grads lie (kPooled).
//
// The stream is ids [n] (int32, ascending; ids < 0 or >= R are sentinels and
// are skipped) and its grads (bf16 or f32), from one of two sources:
// - rows (kPooled false): grads [n, d] in the ids' order, position j's grad
//   row j;
// - pooled (kPooled true): a multi-hot group's pooled bag grads [P, d] and
//   an int32 index [n], the bag of each position: position j's grad is row
//   index[j] of the pooled array, read where it lies. Each bag's row is
//   read by every id of the bag, so the rows the expanded [n, d] stream
//   would copy are never written out.
// The state is Op::kArrays row-major [R, d] f32 arrays, the table first,
// updated in place.
// The values that change from step to step (lr, the bias corrections) are
// Op::kScalars f32 values in device memory, as the TPU kernels read them from
// a scalar operand: a CUDA graph of a training step then replays the values
// the step computed, not those of the step it was captured on.
// For each distinct kept id the grads of its run are summed in f32 in stream
// order from 0, and Op::apply updates each column of its rows once. Both
// sources sum the same values in the same order, so a pooled call gives the
// bits of the rows call on the expanded stream.
//
// Tiles and ownership. The stream is cut into tiles of 32 consecutive
// positions, and a group of threads owns a tile: a warp per column group of
// a row, at most 8 (a block of 256 threads), so d = 1 has a warp a tile and
// eight tiles a block, d = 16 (four float4 column groups) 128 threads a tile,
// d = 17 256. A run (the positions of one id) belongs to the tile that holds
// its first position. The owner sums the run's part in its tile and reads on
// past the tile's end, in stream order; a tile that starts inside an earlier
// tile's run skips those positions. So each run is summed by one thread per
// column, in order: no atomics, no cap on a run's length, and two calls give
// the same bits.
//
// Per tile:
// 1. The group reads the ids of positions [base - 1, base + 64) into shared
//    memory in one coalesced pass (pooled: their bags beside them); the
//    block's first threads read the Op::kScalars values of the step (lr;
//    Adam's bias corrections) once, and Op::bind takes them after the
//    barrier.
// 2. Its first warp finds the run starts by a ballot of id != previous id
//    and gives each run its rank in a compacted list (id, start, end) by a
//    popc prefix. A run ends at the next start, or for the tile's last run
//    in the 32 ids after the tile, or past them in device memory 32 ids at a
//    time.
// 3. Each thread takes K (run, column group) elements of the tile,
//    neighbouring threads on neighbouring columns of one row, so a row's
//    sectors are read once and no thread is spent on a duplicate position.
//    It issues every state load of its elements before any arithmetic; V = 4
//    columns a load (float4) where d % 4 == 0 and every state base is
//    16-byte aligned.
// 4. Then each element's run sum in stream order (its grads read where they
//    lie, neighbouring threads on neighbouring values), Op::apply and the
//    stores. Rows: the compiler's loop over the run's rows. Pooled: the run
//    in chunks of kChunk positions, each chunk's bags read first (from
//    shared memory in [base, base + 64), past it from device memory, all
//    lanes of a column group at one address, the next chunk's while this
//    chunk's rows load), then the chunk's rows (V = 4 columns one 8- or
//    16-byte load, kept as loaded), then their adds one position after
//    another. So a long run's chain waits on one row load a chunk, not on
//    an index load and then a row load a position.
//
// What the measurements chose (NVIDIA H100 80GB HBM3; PERF.md; the
// yardsticks are recmodels_tpu_torch/probes/sparse_update_rows.py). The
// touched rows bound these launches: a bare read-modify-write of the
// flagship stream's 393,083 rows takes 0.081 ms for two [2,600,960, 17]
// arrays and as much for three of 16 columns, about twice the byte bound.
// It reaches that rate with one element a thread and the rows in flight few
// and neighbouring; a warp that walks its tile's rows in rounds or holds
// 8-17 elements a lane takes 0.087-0.094 ms, one that stages rows by 4-byte
// cp.async 0.156 ms. A persistent grid that read the next tile's ids ahead,
// or double-buffered ids and grads by cp.async, was slower than blocks that
// overlap each other's phases, and is gone; so is a register cap (the IEEE
// division's and root's slow-path calls spill under one).
// The pooled route, on the DLRM-DCNv2 cell's batch (3,506,176 ids, d = 128,
// bf16; the rows instance on the expanded stream takes 2.65 ms): chunks of
// 4 positions kept as loaded take 2.06 ms at 58 registers; of 8, 2.13 ms
// (76). Widened to f32 at the load, chunks of 4 took 2.44 ms (63), of 8
// 2.58 (96), of 16 7.9 (148 registers: one block an SM), of 2, 3, 5 and 6
// 2.59-4.71; two elements a thread (K = 2) and a minimum of 3 or 4 blocks
// an SM in the launch bound were slower too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sorted_update {

constexpr int kTile = 32;                  // stream positions a group owns
constexpr int kBlock = 256;                // threads of a block
constexpr int kMaxTiles = kBlock / 32;     // groups (tiles) a block holds at most
constexpr int kChunk = 4;                  // pooled positions whose rows load at once

template <class Op>
struct Args {
  float* state[Op::kArrays];  // the table first
  const int* ids;
  const void* grads;
  long long n, rows;
  int d;
  Op op;                      // its by-value constants
  const float* scalars;       // Op::kScalars f32 values in device memory
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int V>
__device__ __forceinline__ void load_cols(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = p[v];
  }
}

// V grads of one pooled row as loaded, widened to f32 only where they are
// added (so a chunk in flight holds bf16 in half the registers); V = 4 is
// one 8-byte (bf16) or 16-byte (f32) load, which the pooled route takes
// only on an aligned pooled array. at(i) takes a constant i.
template <int V, typename G>
struct RowGrads {
  G v[V];
  __device__ __forceinline__ void load(const G* p) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
  __device__ __forceinline__ float at(int i) const { return to_f32(v[i]); }
};

template <>
struct RowGrads<4, __nv_bfloat16> {
  uint2 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = *reinterpret_cast<const uint2*>(p); }
  __device__ __forceinline__ float at(int i) const {
    const unsigned w = i < 2 ? u.x : u.y;  // a bf16 is the top half of its f32
    return __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
  }
};

template <>
struct RowGrads<4, float> {
  float4 f;
  __device__ __forceinline__ void load(const float* p) { f = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ float at(int i) const { return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w; }
};

template <int V>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = x[v];
  }
}

// Adds the pooled grads of positions [j0, j1) of one column group (columns
// c..c+V) to g, in order; bag_of(j) is position j's row of `pooled`.
// kChunk positions at a time: their bags (the next chunk's read while this
// chunk's rows load), their rows, then the adds.
template <int V, typename G, class BagOf>
__device__ __forceinline__ void add_pooled(float (&g)[V], const G* pooled, int d, int c, long long j0,
                                           long long j1, const BagOf& bag_of) {
  int bag[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) bag[u] = j0 + u < j1 ? bag_of(j0 + u) : 0;
  for (long long j = j0; j < j1; j += kChunk) {
    RowGrads<V, G> x[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (j + u < j1) x[u].load(pooled + (long long)bag[u] * d + c);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) bag[u] = j + kChunk + u < j1 ? bag_of(j + kChunk + u) : 0;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (j + u < j1) {
#pragma unroll
        for (int v = 0; v < V; ++v) g[v] = __fadd_rn(g[v], x[u].at(v));
      }
    }
  }
}

// Block: blockDim.x / group tiles, `group` threads each (a multiple of 32
// up to kBlock). Each thread holds up to K elements' loads in flight.
// kPooled: the grads are a.grads [P, d] read through grad_index [n] (the
// rows instances never read it).
template <class Op, typename G, int V, int K, bool kPooled>
__global__ void __launch_bounds__(kBlock) sorted_update_kernel(const Args<Op> a, int group,
                                                               const int* grad_index) {
  constexpr int kArrays = Op::kArrays;
  constexpr int kIds = 2 * kTile + 1;   // ids of [base - 1, base + 64)
  __shared__ int sid[kMaxTiles][kIds];  // sid[s][1 + j]: the id at base + j
  __shared__ int sbag[kMaxTiles][kIds]; // pooled: sbag[s][1 + j], the bag at base + j
  __shared__ int run_id[kMaxTiles][kTile], run_start[kMaxTiles][kTile], run_end[kMaxTiles][kTile];
  __shared__ int run_count[kMaxTiles];
  __shared__ long long run_tail[kMaxTiles];
  const int slot = threadIdx.x / group, tid = threadIdx.x - slot * group;
  const long long base = ((long long)blockIdx.x * (blockDim.x / group) + slot) * kTile;
  const bool live = base < a.n;  // the whole group
  const int d = a.d, dv = a.d / V;
  // a group of one warp (d = 1) waits for itself only
  const auto sync = [group]() {
    if (group == 32) __syncwarp();
    else __syncthreads();
  };

  // 1. the step's scalars (once a block, from device memory, so a CUDA graph
  // replays the values of its step) and the ids of [base - 1, base + 64)
  __shared__ float scalars[Op::kScalars];
  if (threadIdx.x < Op::kScalars) scalars[threadIdx.x] = a.scalars[threadIdx.x];
  if (live) {
    for (int l = tid; l < kIds; l += group) {
      const long long p = base - 1 + l;
      sid[slot][l] = p >= 0 && p < a.n ? a.ids[p] : 0;
      if constexpr (kPooled) sbag[slot][l] = p >= 0 && p < a.n ? grad_index[p] : 0;
    }
  }
  __syncthreads();
  Op op = a.op;
  op.bind(scalars);

  // 2. the tile's runs, by its group's first warp
  if (live && tid < 32) {
    const int lane = tid;
    const int* s = sid[slot];
    const int cnt = a.n - base < kTile ? (int)(a.n - base) : kTile;
    const bool in = lane < cnt;
    const int id = in ? s[1 + lane] : 0;
    const bool starts = in && (base + lane == 0 || s[lane] != id);
    const unsigned bounds = __ballot_sync(~0u, starts || !in);
    const bool owns = starts && id >= 0 && id < a.rows;
    const unsigned runs = __ballot_sync(~0u, owns);
    const int nruns = __popc(runs);
    if (owns) {
      const int r = __popc(runs & ((1u << lane) - 1));
      const unsigned after = lane == 31 ? 0u : bounds >> (lane + 1) << (lane + 1);
      run_id[slot][r] = id;
      run_start[slot][r] = lane;
      run_end[slot][r] = after ? __ffs(after) - 1 : kTile;
    }
    __syncwarp();
    // The last run goes on past the tile when the next id is its own; tail
    // ends where it stops (base + kTile: it does not go on).
    long long tail = base + kTile;
    if (nruns > 0 && run_end[slot][nruns - 1] == kTile && tail < a.n &&
        s[1 + kTile] == run_id[slot][nruns - 1]) {
      const int last = run_id[slot][nruns - 1];
      unsigned other = __ballot_sync(~0u, tail + lane >= a.n || s[1 + kTile + lane] != last);
      while (other == 0) {
        tail += kTile;
        const long long p = tail + lane;
        other = __ballot_sync(~0u, p >= a.n || a.ids[p] != last);
      }
      tail += __ffs(other) - 1;
    }
    if (lane == 0) run_count[slot] = nruns, run_tail[slot] = tail;
  }
  sync();
  if (!live) return;

  // 3-4. the tile's (run, column group) elements, K a thread at a time
  const G* grads = static_cast<const G*>(a.grads);
  const int nruns = run_count[slot], total = nruns * dv;
  const long long tail = run_tail[slot];
  for (int e0 = tid; e0 < total; e0 += K * group) {
    float x[K][kArrays][V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = e0 + k * group;
      if (e < total) {
        const int r = e / dv;
        const long long at = (long long)run_id[slot][r] * d + (e - r * dv) * V;
#pragma unroll
        for (int q = 0; q < kArrays; ++q) load_cols<V>(x[k][q], a.state[q] + at);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = e0 + k * group;
      if (e >= total) break;
      const int r = e / dv, c = (e - r * dv) * V;
      float g[V];
      if constexpr (kPooled) {
        // the run's positions relative to base: [start, end), and for the
        // tile's last run on to the tail (end is then kTile)
        const long long j1 = run_end[slot][r] + (r == nruns - 1 ? tail - base - kTile : 0);
        const int* bags = sbag[slot];
        const int* index = grad_index + base;
        const auto bag_of = [bags, index](long long j) { return j < 2 * kTile ? bags[1 + j] : index[j]; };
#pragma unroll
        for (int v = 0; v < V; ++v) g[v] = 0.f;
        add_pooled<V>(g, grads, d, c, run_start[slot][r], j1, bag_of);
      } else {
        const G* gp = grads + (base + run_start[slot][r]) * d + c;
#pragma unroll
        for (int v = 0; v < V; ++v) g[v] = __fadd_rn(0.f, to_f32(gp[v]));
        for (int j = run_start[slot][r] + 1, j1 = run_end[slot][r]; j < j1; ++j) {
          gp += d;
#pragma unroll
          for (int v = 0; v < V; ++v) g[v] = __fadd_rn(g[v], to_f32(gp[v]));
        }
        if (r == nruns - 1) {
          for (long long j = base + kTile; j < tail; ++j) {
#pragma unroll
            for (int v = 0; v < V; ++v) g[v] = __fadd_rn(g[v], to_f32(grads[j * d + c + v]));
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float y[kArrays];
#pragma unroll
        for (int q = 0; q < kArrays; ++q) y[q] = x[k][q][v];
        op.apply(g[v], y);
#pragma unroll
        for (int q = 0; q < kArrays; ++q) x[k][q][v] = y[q];
      }
      const long long at = (long long)run_id[slot][r] * d + c;
#pragma unroll
      for (int q = 0; q < kArrays; ++q) store_cols<V>(a.state[q] + at, x[k][q]);
    }
  }
}

// Launch the update for a.state, a.ids, a.grads (bf16 when grads_bf16), a.n,
// a.rows and a.d; pooled where grad_index is set. V = 4 where d % 4 == 0
// and every state base is 16-byte aligned, and pooled grads' base is aligned
// to a 4-column load. A tile's group has a warp per column group up to 8 of
// them, and a block of kBlock threads holds several groups where they are
// smaller.
template <class Op, bool kPooled>
int launch_source(const Args<Op>& a, const int* grad_index, int grads_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.d < 1) return (int)cudaErrorInvalidValue;
  if (a.n == 0) return 0;
  bool vec = a.d % 4 == 0;
  for (int q = 0; q < Op::kArrays; ++q) vec = vec && (reinterpret_cast<uintptr_t>(a.state[q]) & 15) == 0;
  if constexpr (kPooled) vec = vec && reinterpret_cast<uintptr_t>(a.grads) % (grads_bf16 ? 8 : 16) == 0;
  const int dv = vec ? a.d / 4 : a.d;
  const int group = 32 * (dv < kBlock / 32 ? dv : kBlock / 32);
  const int per_block = kBlock / group;
  const long long tiles = (a.n + kTile - 1) / kTile;
  const unsigned blocks = (unsigned)((tiles + per_block - 1) / per_block);
  // V = 4 (d = 16: 4 elements a row) and d = 1 take one element a thread; other
  // rows two (d = 17: a tile's 544 elements on 256 threads, in two rounds)
  const auto kernel =
      grads_bf16 ? (vec ? sorted_update_kernel<Op, __nv_bfloat16, 4, 1, kPooled>
                        : a.d == 1 ? sorted_update_kernel<Op, __nv_bfloat16, 1, 1, kPooled>
                                   : sorted_update_kernel<Op, __nv_bfloat16, 1, 2, kPooled>)
                 : (vec ? sorted_update_kernel<Op, float, 4, 1, kPooled>
                        : a.d == 1 ? sorted_update_kernel<Op, float, 1, 1, kPooled>
                                   : sorted_update_kernel<Op, float, 1, 2, kPooled>);
  kernel<<<blocks, group * per_block, 0, (cudaStream_t)stream>>>(a, group, grad_index);
  return (int)cudaGetLastError();
}

// grad_index: null for rows, else the pooled grads' index [n]
template <class Op>
int launch(const Args<Op>& a, const int* grad_index, int grads_bf16, int device, void* stream) {
  return grad_index ? launch_source<Op, true>(a, grad_index, grads_bf16, device, stream)
                    : launch_source<Op, false>(a, grad_index, grads_bf16, device, stream);
}

}  // namespace sorted_update
