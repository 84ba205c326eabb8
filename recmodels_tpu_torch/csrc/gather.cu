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
// writes 14.5 MB of rows; there is no arithmetic to speak of.
//
// Design: one thread per output value, consecutive threads on consecutive
// values, so the output store and the 17 reads of one row are coalesced and
// each row's sectors are fetched once. The id is re-read by each of its
// row's threads from L1. The bf16 output is __float2bfloat16_rn of the f32
// value (round to nearest even, the same bits as JAX's astype); the f32
// output is a bit-exact copy.
//
// Precondition (the caller's, as in recmodels_tpu/embedding/collection.py
// group_row_ids): every id lies in [0, R). The kernel does not clamp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void gather_rows_kernel(const float* __restrict__ table,
                                   const int* __restrict__ ids,
                                   T* __restrict__ out, long long total,
                                   int d1) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long i = e / d1;
  const int c = (int)(e - i * d1);
  const long long row = __ldg(ids + i);
  out[e] = from_f32<T>(__ldg(table + row * d1 + c));
}

}  // namespace

// table [R, d1] f32, ids [n] i32, out [n, d1] (bf16 when out_bf16, else f32).
extern "C" int rm_gather_rows(int device, const void* table, const void* ids,
                              void* out, long long n, int d1, int out_bf16,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = n * d1;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    gather_rows_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)table, (const int*)ids, (__nv_bfloat16*)out, total, d1);
  } else {
    gather_rows_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)table, (const int*)ids, (float*)out, total, d1);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
