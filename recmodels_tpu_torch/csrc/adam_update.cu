// Lazy Adam from a sorted id stream with duplicates, in place.
//
// Replaces: recmodels_tpu/embedding/pallas_update.py::sorted_adam_update_packed
// (the TPU's packed [n_tiles, d, tr] layout, with a count feature that marks
// the touched rows). The port keeps a plain row-major [R, d] f32 table with
// its moments m and v ([R] for dim-1 tables), as csrc/adagrad_update.cu does.
//
// Contract (pallas_update.py's and optim.sparse_adam's, and the plain version's
// in recmodels_tpu_torch/embedding/update.py): for each distinct id k < R of
// the sorted stream, in every column,
//   g    = sum of the id's grads, in f32, in stream order (from 0)
//   m[k] = b1*m[k] + (1-b1)*g
//   v[k] = b2*v[k] + (1-b2)*g*g
//   w[k] = w[k] + (-lr*(m[k]/bc1)) / (sqrt(v[k]/bc2) + eps)
// where bc1 = 1 - b1^t and bc2 = 1 - b2^t come from the caller, computed once
// per call from the global step. A row is touched when its id is in the
// stream, whatever its grads sum to: an id whose grads sum to 0 still decays
// its moments (lazy Adam's membership rule). Rows not in the stream keep
// their bits; ids >= R (sentinels) are skipped; bf16 grads widen exactly to
// f32. Every operation is an explicitly rounded IEEE intrinsic, so nvcc
// contracts nothing into an FMA and the result equals the CPU plain version
// bit for bit given the same sum order and the same f32 constants.
//
// Bound on this card: bytes. It reads the ids and the grads and reads and
// writes each touched row of the table, m and v.
//
// Design: the TPU kernel sweeps the whole table with a one-hot MXU
// contraction; here, as in the Adagrad kernel, one thread per (stream
// position, column). The thread at a run's start (ids[k] != ids[k-1]) walks
// the run in order, sums its column and updates that element of the table,
// m and v; every other thread returns at once. No atomics, no cap on a run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct AdamConsts {
  float lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps;
};

template <typename G>
__global__ void adam_update_kernel(float* __restrict__ table,
                                   float* __restrict__ m,
                                   float* __restrict__ v,
                                   const int* __restrict__ ids,
                                   const G* __restrict__ grads, long long n,
                                   long long rows, int d, AdamConsts c) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= n * d) return;
  const long long k = t / d;
  const int col = (int)(t - k * d);
  const int id = __ldg(ids + k);
  if (id < 0 || id >= rows) return;  // sentinel
  if (k > 0 && __ldg(ids + k - 1) == id) return;  // not the run's start
  float g = 0.f;
  for (long long j = k; j < n && __ldg(ids + j) == id; ++j)
    g = __fadd_rn(g, to_f32(grads[j * d + col]));
  const long long e = (long long)id * d + col;
  const float mn = __fadd_rn(__fmul_rn(c.b1, m[e]), __fmul_rn(c.one_minus_b1, g));
  const float vn =
      __fadd_rn(__fmul_rn(c.b2, v[e]), __fmul_rn(__fmul_rn(c.one_minus_b2, g), g));
  m[e] = mn;
  v[e] = vn;
  const float num = __fmul_rn(-c.lr, __fdiv_rn(mn, c.bc1));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, c.bc2)), c.eps);
  table[e] = __fadd_rn(table[e], __fdiv_rn(num, den));
}

}  // namespace

// table, m, v [rows, d] f32 (d = 1 for a dim-1 table), ids [n] i32 ascending,
// grads [n, d] (bf16 when grads_bf16, else f32) in the ids' order. The
// constants arrive as f32: one_minus_b1 = f32(1 - b1) rounded from the
// double, as JAX rounds its Python constants.
extern "C" int rm_adam_update(int device, void* table, void* m, void* v,
                              const void* ids, const void* grads, long long n,
                              long long rows, int d, int grads_bf16, float lr,
                              float bc1, float bc2, float b1,
                              float one_minus_b1, float b2, float one_minus_b2,
                              float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1) return (int)cudaErrorInvalidValue;
  const long long total = n * d;
  if (total == 0) return 0;
  const AdamConsts c{lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps};
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (grads_bf16) {
    adam_update_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (float*)table, (float*)m, (float*)v, (const int*)ids,
        (const __nv_bfloat16*)grads, n, rows, d, c);
  } else {
    adam_update_kernel<float><<<blocks, threads, 0, s>>>(
        (float*)table, (float*)m, (float*)v, (const int*)ids,
        (const float*)grads, n, rows, d, c);
  }
  return (int)cudaGetLastError();
}
