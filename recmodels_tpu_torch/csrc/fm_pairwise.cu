// FM second-order term: emb [B, F, D] -> out[b] = 0.5 * (sum_d s_d^2 -
// sum_{f,d} e_fd^2), s_d = sum_f e_fd, in emb's type (bf16 or f32).
//
// Replaces: recmodels_tpu/ops/pallas/interactions_tpu.py::_fm_forward (the
// Pallas kernel _fm_kernel). The TPU kernel takes whole 512-example tiles
// and sends a ragged batch to the jnp reference; this kernel takes any B.
//
// The input need not be packed: the engine hands the model the view
// full[..., :D] of gathered fused rows [B, F, D+1], whose field rows lie D+1
// values apart. The kernel takes the example stride and the field stride in
// elements and needs unit stride along D only.
//
// Rounding points (those of recmodels_tpu_torch/ops/interactions.py
// fm_pairwise, which are the JAX reference's): s_d, sum e^2 and sum s^2 add
// in f32 and round once to the input type; e*e and s*s round elementwise;
// the difference rounds and the halving is exact. For f32 the products and
// sums use __fmul_rn/__fadd_rn, so no multiply-add contracts a rounding away.
//
// Bound on this card: bytes. At DeepFM's serving shape (B = 16,384, F = 26,
// D = 16, bf16) it reads 13.6 MB and writes 32 KB; the arithmetic is about
// 3 operations a value.
//
// Design: a group of G lanes (8, 16 or 32: the smallest that covers D, at
// most 32) takes one example; lane c walks the F field rows of column c (and
// of c + G, ... when D > 32), summing s_c and the squares in f32. The groups
// then reduce by xor shuffles within the group. At D = 16 a warp takes two
// examples, and each field row is one 32-byte read of a half warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the value as the type T holds it (round to nearest even for bf16)
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int G>
__global__ void fm_pairwise_kernel(const T* __restrict__ emb,
                                   T* __restrict__ out, int b, int f, int d,
                                   long long stride_b, long long stride_f) {
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long ex = warp * (32 / G) + lane / G;
  // every lane takes part in the shuffles; a lane past B sums nothing
  float sq = 0.f;  // sum of the rounded e^2 over this lane's columns
  float ss = 0.f;  // sum of the rounded s^2 over this lane's columns
  if (ex < b) {
    const T* row = emb + ex * stride_b;
    for (int c = gl; c < d; c += G) {
      float s = 0.f;
#pragma unroll 4
      for (int i = 0; i < f; ++i) {
        const float e = to_f32(row[i * stride_f + c]);
        s = __fadd_rn(s, e);
        sq = __fadd_rn(sq, round_to<T>(__fmul_rn(e, e)));
      }
      const float sr = round_to<T>(s);
      ss = __fadd_rn(ss, round_to<T>(__fmul_rn(sr, sr)));
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {  // offsets below G stay in the group
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, o));
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  }
  if (ex < b && gl == 0) {
    const float diff = round_to<T>(__fsub_rn(round_to<T>(ss), round_to<T>(sq)));
    out[ex] = from_f32<T>(__fmul_rn(0.5f, diff));
  }
}

template <typename T, int G>
int launch(const void* emb, void* out, int b, int f, int d,
           long long stride_b, long long stride_f, cudaStream_t s) {
  const long long per_block = (long long)(kThreads / 32) * (32 / G);
  const long long blocks = (b + per_block - 1) / per_block;
  fm_pairwise_kernel<T, G><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const T*)emb, (T*)out, b, f, d, stride_b, stride_f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for(const void* emb, void* out, int b, int f, int d,
               long long stride_b, long long stride_f, cudaStream_t s) {
  if (d <= 8) return launch<T, 8>(emb, out, b, f, d, stride_b, stride_f, s);
  if (d <= 16) return launch<T, 16>(emb, out, b, f, d, stride_b, stride_f, s);
  return launch<T, 32>(emb, out, b, f, d, stride_b, stride_f, s);
}

}  // namespace

// emb: element (b, f, c) at emb[b * stride_b + f * stride_f + c], strides in
// elements; out [b]; both bf16 when is_bf16, else f32.
extern "C" int rm_fm_pairwise(int device, const void* emb, void* out, int b,
                              int f, int d, long long stride_b,
                              long long stride_f, int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_for<__nv_bfloat16>(emb, out, b, f, d, stride_b, stride_f, s)
                 : launch_for<float>(emb, out, b, f, d, stride_b, stride_f, s);
}
