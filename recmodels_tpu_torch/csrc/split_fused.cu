// Fused-row fanout: [B, m, D+1] rows -> x_dm [B, D, m] (same type) and
// wide_sum [B] f32, the sum over m of the last column; and its backward,
// (g_dm [B, D, m], g_ws [B] f32) -> the rows' cotangent [B, m, D+1] in
// g_dm's type: g_dm transposed, with g_ws broadcast into the last column.
//
// Replaces: recmodels_tpu/ops/pallas/interactions_tpu.py::_split_fused_fwd_impl
// (the forward of split_fused_rows) and ::_split_fused_bwd_impl (its
// backward). wide_sum is rank 1 here too: the TPU kernel's (B, 1) block
// shape once built (B, B) logits.
//
// Bound on this card: bytes. At the serving shape (B = 16,384, m = 26,
// D = 16, bf16) it reads 14.5 MB and writes 13.6 MB plus 64 KB of sums; the
// arithmetic is 26 adds per example.
//
// The backward reads 13.6 MB of g_dm and 64 KB of g_ws and writes 14.5 MB;
// the bf16 cast of g_ws is __float2bfloat16_rn, JAX's astype.
//
// Design: a block takes a run of whole examples, which are contiguous in
// both the input and the output. It copies the run's input into shared
// memory with coalesced loads, then writes the transposed run with coalesced
// stores, so each byte crosses device memory once. One thread per example
// sums the last column in f32, in slot order. The backward is the same
// pattern in the other direction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxExamplesPerBlock = 32;
constexpr int kSmemBytes = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void split_fused_rows_kernel(const T* __restrict__ full,
                                        T* __restrict__ x_dm,
                                        float* __restrict__ wide_sum, int b,
                                        int m, int d, int epb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int d1 = d + 1;
  const int per_in = m * d1;
  const int per_out = d * m;
  const long long b0 = (long long)blockIdx.x * epb;
  const int nb = (int)min((long long)epb, b - b0);

  const T* src = full + b0 * per_in;
  for (int k = threadIdx.x; k < nb * per_in; k += blockDim.x) tile[k] = src[k];
  __syncthreads();

  T* dst = x_dm + b0 * per_out;
  for (int k = threadIdx.x; k < nb * per_out; k += blockDim.x) {
    const int e = k / per_out;
    const int r = k - e * per_out;
    const int c = r / m;
    const int i = r - c * m;
    dst[k] = tile[e * per_in + i * d1 + c];
  }
  for (int e = threadIdx.x; e < nb; e += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < m; ++i) s += to_f32(tile[e * per_in + i * d1 + d]);
    wide_sum[b0 + e] = s;
  }
}

template <typename T>
__global__ void split_fused_rows_bwd_kernel(const T* __restrict__ g_dm,
                                            const float* __restrict__ g_ws,
                                            T* __restrict__ out, int b, int m,
                                            int d, int epb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int d1 = d + 1;
  const int per_in = d * m;
  const int per_out = m * d1;
  const long long b0 = (long long)blockIdx.x * epb;
  const int nb = (int)min((long long)epb, b - b0);

  const T* src = g_dm + b0 * per_in;
  for (int k = threadIdx.x; k < nb * per_in; k += blockDim.x) tile[k] = src[k];
  __syncthreads();

  T* dst = out + b0 * per_out;
  for (int k = threadIdx.x; k < nb * per_out; k += blockDim.x) {
    const int e = k / per_out;
    const int r = k - e * per_out;
    const int i = r / d1;
    const int c = r - i * d1;
    dst[k] = c < d ? tile[e * per_in + c * m + i] : from_f32<T>(g_ws[b0 + e]);
  }
}

// examples per block: as many as fit kSmemBytes, at most kMaxExamplesPerBlock
template <typename T>
int examples_per_block(int m, int d) {
  const int per_bytes = m * (d + 1) * (int)sizeof(T);
  if (per_bytes > kSmemBytes) return 0;
  const int epb = kSmemBytes / per_bytes;
  return epb > kMaxExamplesPerBlock ? kMaxExamplesPerBlock : epb;
}

template <typename T>
int launch(const void* full, void* x_dm, void* wide_sum, int b, int m, int d,
           cudaStream_t s) {
  const int epb = examples_per_block<T>(m, d);
  if (epb == 0) return (int)cudaErrorInvalidValue;
  const int blocks = (b + epb - 1) / epb;
  split_fused_rows_kernel<T><<<blocks, kThreads, epb * m * (d + 1) * sizeof(T), s>>>(
      (const T*)full, (T*)x_dm, (float*)wide_sum, b, m, d, epb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g_dm, const void* g_ws, void* out, int b, int m,
               int d, cudaStream_t s) {
  const int epb = examples_per_block<T>(m, d);
  if (epb == 0) return (int)cudaErrorInvalidValue;
  const int blocks = (b + epb - 1) / epb;
  split_fused_rows_bwd_kernel<T><<<blocks, kThreads, epb * d * m * sizeof(T), s>>>(
      (const T*)g_dm, (const float*)g_ws, (T*)out, b, m, d, epb);
  return (int)cudaGetLastError();
}

}  // namespace

// full [b, m, d+1], x_dm [b, d, m] (bf16 when is_bf16, else f32), wide_sum [b] f32.
extern "C" int rm_split_fused_rows(int device, const void* full, void* x_dm,
                                   void* wide_sum, int b, int m, int d,
                                   int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(full, x_dm, wide_sum, b, m, d, s)
                 : launch<float>(full, x_dm, wide_sum, b, m, d, s);
}

// g_dm [b, d, m], out [b, m, d+1] (bf16 when is_bf16, else f32), g_ws [b] f32.
extern "C" int rm_split_fused_rows_backward(int device, const void* g_dm,
                                            const void* g_ws, void* out, int b,
                                            int m, int d, int is_bf16,
                                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_bwd<__nv_bfloat16>(g_dm, g_ws, out, b, m, d, s)
                 : launch_bwd<float>(g_dm, g_ws, out, b, m, d, s);
}
