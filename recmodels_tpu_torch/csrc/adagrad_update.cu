// Sparse Adagrad from a sorted id stream with duplicates, in place.
//
// Replaces: recmodels_tpu/embedding/pallas_update.py::
// sorted_adagrad_update_packed (the TPU's packed [n_tiles, d, tr] layout) and
// ::sorted_adagrad_update (its 2-D [d, R] layout and dim-1 tables): the port
// keeps one layout, a plain row-major [R, d] f32 table and accumulator
// ([R] for dim-1), so one kernel serves both.
//
// Contract (pallas_update.py's, and the plain version's in
// recmodels_tpu_torch/embedding/update.py): for each distinct id k < R of the
// sorted stream, in every column,
//   g      = sum of the id's grads, in f32, in stream order (from 0)
//   acc[k] = acc[k] + g*g
//   w[k]   = w[k] - lr*g / (sqrt(acc[k]) + eps)
// Rows not in the stream are not touched (bit-identical); ids >= R
// (sentinels) are skipped; bf16 grads widen exactly to f32. Every operation
// is an explicitly rounded IEEE intrinsic, so nvcc contracts nothing into an
// FMA and the result equals the CPU plain version bit for bit given the same
// sum order.
//
// Bound on this card: bytes. At the training shape (425,984 grads of 17
// bf16 into a 2,600,960 x 17 table) it reads the ids and the 14.5 MB of
// grads and reads and writes each touched row of the table and of acc.
//
// Design: the TPU kernel sweeps the whole table and sums duplicates with a
// one-hot MXU contraction, because a TPU scatter is serial. Hopper reads and
// writes rows where they are, so the sweep goes: one thread per (stream
// position, column). A thread whose position starts a run (ids[k] !=
// ids[k-1]) walks the run in order, sums its column and updates that one
// element; every other thread returns at once. No two threads write the
// same element and nothing is atomic, so a run repeats bit for bit. A run is
// never capped: a hot id's thread walks all its duplicates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename G>
__global__ void adagrad_update_kernel(float* __restrict__ table,
                                      float* __restrict__ acc,
                                      const int* __restrict__ ids,
                                      const G* __restrict__ grads, long long n,
                                      long long rows, int d, float lr,
                                      float eps) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= n * d) return;
  const long long k = t / d;
  const int c = (int)(t - k * d);
  const int id = __ldg(ids + k);
  if (id < 0 || id >= rows) return;  // sentinel
  if (k > 0 && __ldg(ids + k - 1) == id) return;  // not the run's start
  float g = 0.f;
  for (long long j = k; j < n && __ldg(ids + j) == id; ++j)
    g = __fadd_rn(g, to_f32(grads[j * d + c]));
  const long long e = (long long)id * d + c;
  const float a = __fadd_rn(acc[e], __fmul_rn(g, g));
  acc[e] = a;
  table[e] = __fsub_rn(table[e],
                       __fdiv_rn(__fmul_rn(lr, g), __fadd_rn(__fsqrt_rn(a), eps)));
}

}  // namespace

// table, acc [rows, d] f32 (d = 1 for a dim-1 table), ids [n] i32 ascending,
// grads [n, d] (bf16 when grads_bf16, else f32) in the ids' order.
extern "C" int rm_adagrad_update(int device, void* table, void* acc,
                                 const void* ids, const void* grads,
                                 long long n, long long rows, int d,
                                 int grads_bf16, float lr, float eps,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1) return (int)cudaErrorInvalidValue;
  const long long total = n * d;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (grads_bf16) {
    adagrad_update_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (float*)table, (float*)acc, (const int*)ids,
        (const __nv_bfloat16*)grads, n, rows, d, lr, eps);
  } else {
    adagrad_update_kernel<float><<<blocks, threads, 0, s>>>(
        (float*)table, (float*)acc, (const int*)ids, (const float*)grads, n,
        rows, d, lr, eps);
  }
  return (int)cudaGetLastError();
}
