// Batched transpose of the two minor axes: x [B, a, b] -> out [B, b, a].
//
// Replaces: recmodels_tpu/ops/pallas/interactions_tpu.py::_transpose_minor2,
// the TPU's VMEM transpose between the H-major field matrix [B, m, D] and
// the D-major [B, D, m] rows that the CIN kernels take (and, in the VJP, the
// same transpose of the cotangent). Bits are moved, not values, so one
// kernel serves bf16 (2-byte) and f32 (4-byte) elements.
//
// Bound on this card: bytes, the input read once and the output written
// once (27 MB at the training shape [16384, 26, 16] bf16).
//
// Design: the TPU kernel transposes whole [tb, a, b] blocks in VMEM. Here
// one thread per output element: a warp writes 32 consecutive elements
// (coalesced) and reads them from one or two [a, b] items of at most a few
// KB, which L1 holds, so every input line comes from device memory once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void transpose_minor2_kernel(const T* __restrict__ x, T* __restrict__ out,
                                        long long total, int a, int b) {
  const long long ab = (long long)a * b;
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < total;
       o += (long long)gridDim.x * blockDim.x) {
    const long long item = o / ab;
    const int rem = (int)(o - item * ab);
    const int y = rem / a;  // out[item, y, z] = x[item, z, y]
    const int z = rem - y * a;
    out[o] = __ldg(x + item * ab + (long long)z * b + y);
  }
}

}  // namespace

// x [batch, a, b] -> out [batch, b, a], elements of elem_bytes (2 or 4).
extern "C" int rm_transpose_minor2(int device, const void* x, void* out, long long batch, int a,
                                   int b, int elem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a < 1 || b < 1 || batch < 0) return (int)cudaErrorInvalidValue;
  const long long total = batch * a * b;
  if (total == 0) return 0;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < (1LL << 30) ? want : (1LL << 30));
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 2) {
    transpose_minor2_kernel<uint16_t><<<blocks, threads, 0, st>>>(
        (const uint16_t*)x, (uint16_t*)out, total, a, b);
  } else if (elem_bytes == 4) {
    transpose_minor2_kernel<uint32_t><<<blocks, threads, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)out, total, a, b);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
