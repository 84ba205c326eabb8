// DCN cross stack: x0 [B, d], w, b [L, d] -> x_L [B, d], all in one type
// (bf16 or f32), with x_{l+1} = x0 * (x_l . w_l) + b_l + x_l, x_0 = x0.
//
// Replaces: recmodels_tpu/ops/pallas/interactions_tpu.py::_dcn_forward (the
// Pallas kernel _dcn_kernel). As there, all L layers run in one launch and,
// on the register path, x_l does not go to device memory between layers.
// The TPU kernel takes whole 256-row tiles and sends a ragged batch to the
// jnp reference; this file takes any B, d and L.
//
// Rounding points (those of recmodels_tpu_torch/ops/interactions.py
// dcn_cross_layer, which are the JAX reference's): t = x_l . w_l is an f32
// sum of products (exact for bf16 values), rounded once to the type; then
// x0 * t, + b and + x_l each round. For f32 those three steps use
// __fmul_rn/__fadd_rn, so no multiply-add contracts a rounding away.
//
// Bound on this card: bytes. At DCN's shape (B = 16,384, d = 26 * 16 + 13 =
// 429, L = 3, bf16) it reads 14.1 MB of x0 and writes 14.1 MB; the
// arithmetic is about 5 operations a value a layer.
//
// Design, two paths chosen by shape (the wrapper's dcn_rows_in_registers):
//  * registers (d <= 1024 and w and b of all layers within 48 KB, so DCN's
//    d = 429 up to 28 bf16 or 14 f32 layers): one warp per row. Lane j
//    holds the row's values j, j + 32, ... in registers (x0 and x_l, as
//    f32: 14 of each at d = 429), so a row is read once and written once
//    with 2-byte accesses. Those need no alignment: a bf16 row of odd d
//    starts 2 bytes off a 4-byte boundary every other row, and a wider
//    vector load would fault there. Each layer sums the lane's products,
//    reduces across the warp by xor shuffles (every lane ends with the same
//    t) and updates its values. w and b of all layers sit in shared memory,
//    copied once per block, and the blocks walk the rows;
//  * wide rows (any other d and L: bench.py --model dcn --dim 40 gives x0
//    of 1,053; more than 14 f32 layers at 429): one block of 256 threads
//    per row, the blocks walking the rows. Thread j owns columns j, j + 256,
//    ... of the row; x_l lives in the output row (each thread reads back
//    only what it wrote, so no barrier guards it), x0, w_l and b_l are read
//    from L2 layer by layer. t sums thread j's products in column order,
//    then each warp by xor shuffles, then the eight warp sums in warp
//    order, one thread, no atomics: runs repeat bit for bit, and in bf16
//    the products are exact, so the wrapper's dcn_cross_stack_in_kernel_order
//    gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBytes = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one element of a layer: round(round(round(x0 * t) + b) + xl)
template <typename T>
__device__ __forceinline__ float cross(float x0, float t, float b, float xl) {
  const float u = round_to<T>(__fmul_rn(x0, t));
  return round_to<T>(__fadd_rn(round_to<T>(__fadd_rn(u, b)), xl));
}

// x_l in registers: lane j holds columns j + 32 k, k < V (d <= 32 V)
template <typename T, int V>
__global__ void dcn_cross_kernel(const T* __restrict__ x0,
                                 const T* __restrict__ w,
                                 const T* __restrict__ bias,
                                 T* __restrict__ out, int b, int d,
                                 int n_layers) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);  // [L, d]
  T* bs = ws + n_layers * d;               // [L, d]
  for (int k = threadIdx.x; k < n_layers * d; k += blockDim.x) {
    ws[k] = w[k];
    bs[k] = bias[k];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < b;
       r += (long long)gridDim.x * kWarps) {
    const T* xr = x0 + r * d;
    float xv[V], lv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      xv[k] = c < d ? to_f32(xr[c]) : 0.f;
      lv[k] = xv[k];
    }
    for (int l = 0; l < n_layers; ++l) {
      const T* wl = ws + l * d;
      const T* bl = bs + l * d;
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int c = lane + 32 * k;
        if (c < d) t = fmaf(lv[k], to_f32(wl[c]), t);
      }
      const float tr = round_to<T>(warp_sum(t));
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int c = lane + 32 * k;
        if (c < d) lv[k] = cross<T>(xv[k], tr, to_f32(bl[c]), lv[k]);
      }
    }
    T* orow = out + r * d;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      if (c < d) orow[c] = from_f32<T>(lv[k]);
    }
  }
}

// wide rows: one block per row; x_l in the output row
template <typename T>
__global__ void __launch_bounds__(kThreads) dcn_cross_wide_kernel(const T* __restrict__ x0,
                                                                  const T* __restrict__ w,
                                                                  const T* __restrict__ bias,
                                                                  T* __restrict__ out, int b,
                                                                  int d, int n_layers) {
  __shared__ float part[kWarps];
  __shared__ float t_shared;
  const int tid = threadIdx.x;
  for (long long r = blockIdx.x; r < b; r += gridDim.x) {
    const T* xr = x0 + r * d;
    T* orow = out + r * d;
    for (int c = tid; c < d; c += kThreads) orow[c] = xr[c];
    for (int l = 0; l < n_layers; ++l) {
      const T* wl = w + (long long)l * d;
      const T* bl = bias + (long long)l * d;
      float t = 0.f;
      for (int c = tid; c < d; c += kThreads) t = fmaf(to_f32(orow[c]), to_f32(wl[c]), t);
      t = warp_sum(t);
      if ((tid & 31) == 0) part[tid >> 5] = t;
      __syncthreads();
      if (tid == 0) {
        float sum = part[0];
        for (int k = 1; k < kWarps; ++k) sum += part[k];
        t_shared = round_to<T>(sum);
      }
      __syncthreads();
      const float tr = t_shared;
      for (int c = tid; c < d; c += kThreads)
        orow[c] = from_f32<T>(cross<T>(to_f32(xr[c]), tr, to_f32(bl[c]), to_f32(orow[c])));
    }
  }
}

template <typename T, int V>
int launch_v(const void* x0, const void* w, const void* bias, void* out, int b,
             int d, int n_layers, unsigned blocks, cudaStream_t s) {
  const size_t smem = 2 * (size_t)n_layers * d * sizeof(T);
  dcn_cross_kernel<T, V><<<blocks, kThreads, smem, s>>>(
      (const T*)x0, (const T*)w, (const T*)bias, (T*)out, b, d, n_layers);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x0, const void* w, const void* bias, void* out, int b,
           int d, int n_layers, int device, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // enough blocks to fill the card; each walks its share of the rows
  if (d > 32 * 32 || 2 * (long long)n_layers * d * (long long)sizeof(T) > kSmemBytes) {
    const unsigned blocks = (unsigned)(b < 8LL * sms ? b : 8LL * sms);
    dcn_cross_wide_kernel<T><<<blocks, kThreads, 0, s>>>((const T*)x0, (const T*)w, (const T*)bias,
                                                          (T*)out, b, d, n_layers);
    return (int)cudaGetLastError();
  }
  const long long want = ((long long)b + kWarps - 1) / kWarps;
  const unsigned blocks = (unsigned)(want < 4LL * sms ? want : 4LL * sms);
  if (d <= 32) return launch_v<T, 1>(x0, w, bias, out, b, d, n_layers, blocks, s);
  if (d <= 64) return launch_v<T, 2>(x0, w, bias, out, b, d, n_layers, blocks, s);
  if (d <= 128) return launch_v<T, 4>(x0, w, bias, out, b, d, n_layers, blocks, s);
  if (d <= 256) return launch_v<T, 8>(x0, w, bias, out, b, d, n_layers, blocks, s);
  if (d <= 512) return launch_v<T, 16>(x0, w, bias, out, b, d, n_layers, blocks, s);
  return launch_v<T, 32>(x0, w, bias, out, b, d, n_layers, blocks, s);
}

}  // namespace

// x0, out [b, d]; w, bias [n_layers, d]; all bf16 when is_bf16, else f32.
extern "C" int rm_dcn_cross_stack(int device, const void* x0, const void* w,
                                  const void* bias, void* out, int b, int d,
                                  int n_layers, int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b == 0 || d == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(x0, w, bias, out, b, d, n_layers, device, s)
                 : launch<float>(x0, w, bias, out, b, d, n_layers, device, s);
}
