// Embedding row gather: out[i, :] = cast(table[ids[i], :]).
//
// Replaces: recmodels_tpu/embedding/pallas_gather.py::sorted_gather (the
// Pallas kernel _gather_kernel). The TPU kernel sweeps a packed
// [n_tiles, d8, tr] table and selects rows with one-hot MXU dots because a
// TPU row gather is op-bound; it therefore needs the ids sorted and an
// un-permute afterwards. Hopper gathers rows directly, so this kernel takes a
// plain row-major [R, D+1] f32 table and ids in any order (batch order on the
// serving path), and the sort and the un-permute are gone.
//
// Bound on this card: bytes. At the serving shape (425,984 ids into a
// 2,600,960 x 17 f32 table, bf16 out) it reads each touched 68-byte row and
// writes 14.5 MB of rows; there is no arithmetic to speak of. Scattered rows
// are read at the card's rate only with many of them in flight.
//
// Design (rows of 2 to 33 values, into a 16-byte aligned output): a warp
// owns a tile of 32 consecutive ids and the tile's output, 32 d1 values,
// which is a whole number of 16-byte chunks. The warp loads the tile's
// ids with one coalesced access into shared memory. Lane j then
// takes the tile's values j, j + 32, ... in output order (value e is
// column e % d1 of row e / d1, stepped without division), so consecutive
// lanes read consecutive values of a row and each row's sectors are
// fetched once; it issues all of its table loads (17 at d1 = 17) before it
// uses any. The values are cast and written into shared memory in output
// order, and the tile goes out as 16-byte stores (the ragged last chunk of
// the batch value by value). The bf16 output is __float2bfloat16_rn of the
// f32 value (round to nearest even, the same bits as JAX's astype); the f32
// output is a bit-exact copy.
//
// Rows of one value (d1 = 1: slice 3's wide table) and rows past 33 values
// (bench.py --dim 40 and 64) take the plain path, a thread per output value.
// At d1 = 1 that is a thread an id, whose loads and stores are coalesced
// with no staging (staged tiles were slower there); a tile of 64-value
// rows spilled its registers.
//
// Precondition (the caller's, as in recmodels_tpu/embedding/collection.py
// group_row_ids): every id lies in [0, R). The kernel does not clamp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileD1 = 33;  // widest row of the tiled path

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A warp's tile: 32 rows, 32 d1 values; lane j holds values j + 32 k,
// k < V (d1 <= V). Shared memory: [kWarps][32] ids, then [kWarps][32 d1]
// output values.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gather_tiles_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                        T* __restrict__ out, long long n, int d1) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ uint4 smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r0 = ((long long)blockIdx.x * kWarps + warp) * 32;
  if (r0 >= n) return;
  int* sid = reinterpret_cast<int*>(smem_raw) + warp * 32;
  T* sout = reinterpret_cast<T*>(reinterpret_cast<int*>(smem_raw) + kWarps * 32) + warp * 32 * d1;
  const int nr = (int)min(32LL, n - r0);
  if (lane < nr) sid[lane] = __ldg(ids + r0 + lane);
  __syncwarp();

  const int nv = nr * d1;
  const int row_step = 32 / d1, col_step = 32 - row_step * d1;
  int row = lane / d1, col = lane - row * d1;
  float v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (lane + 32 * k < nv) v[k] = __ldg(table + (long long)sid[row] * d1 + col);
    row += row_step;
    col += col_step;
    if (col >= d1) {
      col -= d1;
      ++row;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (lane + 32 * k < nv) sout[lane + 32 * k] = from_f32<T>(v[k]);
  __syncwarp();

  T* dst = out + r0 * d1;
  const int chunks = (nv + kVec - 1) / kVec;
  for (int c = lane; c < chunks; c += 32) {
    if ((c + 1) * kVec <= nv) {
      reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(sout)[c];
    } else {
      for (int e = c * kVec; e < nv; ++e) dst[e] = sout[e];
    }
  }
}

// The plain path: one thread per output value.
template <typename T>
__global__ void gather_values_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                                     T* __restrict__ out, long long total, int d1) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long i = e / d1;
  const int c = (int)(e - i * d1);
  const long long row = __ldg(ids + i);
  out[e] = from_f32<T>(__ldg(table + row * d1 + c));
}

template <typename T, int V>
cudaError_t launch_tiles(const float* table, const int* ids, T* out, long long n, int d1,
                         cudaStream_t s) {
  const long long blocks = (n + 32LL * kWarps - 1) / (32LL * kWarps);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = kWarps * 32 * (4 + d1 * (int)sizeof(T));  // under 48 KB at d1 <= 33
  gather_tiles_kernel<T, V><<<(unsigned)blocks, kThreads, smem, s>>>(table, ids, out, n, d1);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const float* table, const int* ids, T* out, long long n, int d1,
                   cudaStream_t s) {
  if (d1 == 1 || d1 > kMaxTileD1 || (reinterpret_cast<uintptr_t>(out) & 15)) {
    const long long total = n * d1;
    const long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    gather_values_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(table, ids, out, total, d1);
    return cudaGetLastError();
  }
  if (d1 <= 16) return launch_tiles<T, 16>(table, ids, out, n, d1, s);
  if (d1 <= 17) return launch_tiles<T, 17>(table, ids, out, n, d1, s);
  return launch_tiles<T, kMaxTileD1>(table, ids, out, n, d1, s);
}

}  // namespace

// table [R, d1] f32, ids [n] i32, out [n, d1] (bf16 when out_bf16, else f32).
extern "C" int rm_gather_rows(int device, const void* table, const void* ids, void* out,
                              long long n, int d1, int out_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0 || d1 < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || d1 == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(out_bf16 ? launch<__nv_bfloat16>((const float*)table, (const int*)ids,
                                                (__nv_bfloat16*)out, n, d1, s)
                        : launch<float>((const float*)table, (const int*)ids, (float*)out, n, d1, s));
}

extern "C" const char* rm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
