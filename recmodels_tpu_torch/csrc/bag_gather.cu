// Pooled embedding bags: out[b, s, :] = cast(sum over the bag's ids of
// table[id, :]), each bag's f32 rows summed in f32 in bag order.
//
// Replaces: nothing of the TPU package, which has one id a slot. This is the
// port's own kernel for multi-hot slots (DLRM's sum-pooled embedding bags;
// MLPerf Training's DLRM-DCNv2 reads 214 ids an example in 26 bags of 1 to
// 100). Without it the row gather (csrc/gather.cu) would write every id's
// row, [B, n_ids, d], for PyTorch to read back and sum: at 16,384 examples,
// 214 ids and d = 128 that is 0.9 GB of bf16 written and read a step for a
// [B, 26, 128] result.
//
// Layout: ids [B, n_ids] int32 global row ids, slot-major (bag s of example b
// is ids[b, off[s] .. off[s + 1])); table [R, d] f32 row-major; out [B,
// n_bags, d] bf16 (round to nearest even of the f32 sum, as the plain
// version's cast) or f32.
//
// Bound on this card: bytes, scattered. Each id reads one 512-byte row at d
// = 128; the output is small beside it. Rows are read at the card's rate only
// with many of them in flight.
//
// Design: a warp owns a bag. Its lanes read up to 32 of the bag's ids in one
// coalesced access and hand them round by shuffles; each lane owns V = 4
// consecutive columns (one 16-byte load of a row, d = 128 in one pass of the
// warp; narrower rows leave lanes idle, wider rows take several passes).
// A lane issues the loads of kUnroll ids before it adds any, then adds them in
// bag order with explicitly rounded f32 additions, so two calls give the same
// bits and the plain version (gather, then the same additions in the same
// order) gives them too. The first row starts the sum (no 0 + x, which would
// turn a -0 into +0). Element offsets are 64-bit: a table past 2^31 elements
// (51.9 M rows x 128 in the DLRM cell) is read right. Rows whose width is no
// multiple of 4, or a table off 16 bytes, take V = 1.
//
// Precondition (the caller's, as for the row gather): every id lies in [0, R).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBags = 256;  // bags an example, passed by value
constexpr int kUnroll = 8;     // row loads a lane holds in flight

struct BagOffsets {
  int at[kMaxBags + 1];  // bag s is ids [at[s], at[s + 1]) of an example
};

template <int V>
__device__ __forceinline__ void load_row(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_sum(T* p, const float (&x)[V]);

template <>
__device__ __forceinline__ void store_sum<float, 4>(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

template <>
__device__ __forceinline__ void store_sum<float, 1>(float* p, const float (&x)[1]) {
  *p = x[0];
}

template <>
__device__ __forceinline__ void store_sum<__nv_bfloat16, 4>(__nv_bfloat16* p, const float (&x)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]), hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  memcpy(&u.x, &lo, 4);
  memcpy(&u.y, &hi, 4);
  *reinterpret_cast<uint2*>(p) = u;
}

template <>
__device__ __forceinline__ void store_sum<__nv_bfloat16, 1>(__nv_bfloat16* p, const float (&x)[1]) {
  *p = __float2bfloat16_rn(x[0]);
}

// A warp a bag: bag q = b * n_bags + s, its output row out[q, :].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bag_gather_kernel(const float* __restrict__ table, const int* __restrict__ ids, T* __restrict__ out,
                      long long n_out, int n_bags, int n_ids, int d, const BagOffsets off) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q >= n_out) return;
  const long long b = q / n_bags;
  const int s = (int)(q - b * n_bags);
  const int first = off.at[s], h = off.at[s + 1] - first;
  const int* bag = ids + b * n_ids + first;
  T* dst = out + q * d;
  for (int c0 = 0; c0 < d; c0 += 32 * V) {
    const int c = c0 + lane * V;
    const bool on = c < d;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int j0 = 0; j0 < h; j0 += 32) {
      const int cnt = min(32, h - j0);
      const int mine = lane < cnt ? __ldg(bag + j0 + lane) : 0;
      for (int j = 0; j < cnt; j += kUnroll) {
        float x[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int id = __shfl_sync(~0u, mine, (j + u) & 31);
          if (on && j + u < cnt) load_row<V>(x[u], table + (long long)id * d + c);
        }
        if (on) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (j + u < cnt) {
#pragma unroll
              for (int v = 0; v < V; ++v) acc[v] = j0 + j + u == 0 ? x[u][v] : __fadd_rn(acc[v], x[u][v]);
            }
          }
        }
      }
    }
    if (on) store_sum<T, V>(dst + c, acc);
  }
}

template <typename T>
cudaError_t launch(const float* table, const int* ids, T* out, long long b, int n_ids, int d,
                   const BagOffsets& off, int n_bags, cudaStream_t s) {
  const long long n_out = b * n_bags;
  const long long blocks = (n_out + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  if (vec)
    bag_gather_kernel<T, 4><<<(unsigned)blocks, kThreads, 0, s>>>(table, ids, out, n_out, n_bags, n_ids, d, off);
  else
    bag_gather_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, s>>>(table, ids, out, n_out, n_bags, n_ids, d, off);
  return cudaGetLastError();
}

}  // namespace

// table [R, d] f32, ids [b, n_ids] i32, out [b, n_bags, d] (bf16 when
// out_bf16, else f32); bag_offsets: n_bags + 1 ints in host memory, from 0
// ascending to n_ids, each bag at least one id.
extern "C" int rm_bag_gather(int device, const void* table, const void* ids, void* out, long long b,
                             int n_ids, int d, const int* bag_offsets, int n_bags, int out_bf16,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 0 || d < 1 || n_bags < 1 || n_bags > kMaxBags || bag_offsets[0] != 0 ||
      bag_offsets[n_bags] != n_ids)
    return (int)cudaErrorInvalidValue;
  BagOffsets off;
  for (int s = 0; s <= n_bags; ++s) {
    if (s > 0 && bag_offsets[s] <= bag_offsets[s - 1]) return (int)cudaErrorInvalidValue;
    off.at[s] = bag_offsets[s];
  }
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(out_bf16 ? launch<__nv_bfloat16>((const float*)table, (const int*)ids, (__nv_bfloat16*)out, b,
                                                n_ids, d, off, n_bags, s)
                        : launch<float>((const float*)table, (const int*)ids, (float*)out, b, n_ids, d, off,
                                        n_bags, s));
}
