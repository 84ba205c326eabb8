// The residual sum and LayerNorm that close a Wukong layer
// (recmodels_tpu_torch/nn/wukong_ln.py, models/wukong.py), forward and back,
// over rows of d values (a row: one embedding of one example):
//
//   wukong_ln_fwd_kernel: row j of example b sums the layer's part (row j of
//     the FMB's output h [B, n_F d] for j < n_F, else row j - n_F of the
//     LCB's l [B, n_L, d]) and the residual r [B, m, d] in f32, rounds once
//     to bf16 (s, which the backward reads), and writes y = bf16((s - mean)
//     rstd scale + shift), the mean and rstd of the row's bf16 s values in
//     f32 (two passes over registers), scale and shift f32 [d].
//   wukong_ln_bwd_kernel: g_s = bf16(rstd (g_hat - mean(g_hat) - x_hat
//     mean(g_hat x_hat))), g_hat = g scale, x_hat = (s - mean) rstd, written
//     to g_s [B, m, d] and, for rows j < n_F, to g_h [B, n_F d] as well (the
//     FMB's MLP reads its cotangent there, contiguous); and per block the
//     partial sums over its rows of g_scale = sum g x_hat and g_shift = sum g.
//   wukong_ln_grad_sum_kernel: the blocks' partials summed in a fixed order.
//     No atomics: two calls give the same bits.
//
// Replaces: none (the JAX package has no Wukong). In the port it replaces
// torch.cat, the residual add and PyTorch's layer_norm and its backward,
// which for rows of 128 ran a block a row and needed the scale and shift in
// the input's dtype (bf16): rounding scales near 1 to bf16 put a per-channel
// error of up to 2^-8 on every output, the same for every example, which the
// batch's gradient sums do not average away. Here they stay f32, as under
// autocast.
//
// Bound on this card: bytes. Forward: h or l and r read, s and y written
// (bf16), mean and rstd written (f32): 8 bytes a value. Backward: g and s
// read, g_s written, g_h for the FMB's rows: 6 to 8 bytes a value.
//
// Design: a warp takes a row at a time, each lane d / 32 consecutive values
// (d 32, 64, 128 or 256) by one vector load; the row's sums are warp
// butterflies in a fixed order. The backward's blocks take a fixed range of
// rows (so its partials are fixed), each lane summing its values'
// weight-grad terms in registers, then the block's warps in warp order
// through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kFwdRowsPerWarp = 8;
constexpr int kBwdRowsPerWarp = 64;
constexpr int kSumRows = 8;  // threads a column in the grad sum kernel

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V consecutive bf16 values (V = 1, 2, 4 or 8: 2 to 16 bytes) widened.
template <int V>
__device__ __forceinline__ void load(float (&x)[V], const bf16* p) {
  if constexpr (V == 1) {
    x[0] = __bfloat162float(*p);
  } else if constexpr (V == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    x[0] = f.x, x[1] = f.y;
  } else if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x, x[2 * i + 1] = f.y;
    }
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x, x[2 * i + 1] = f.y;
    }
  }
}

// V values rounded to bf16 and stored (one vector store).
template <int V>
__device__ __forceinline__ void store(bf16* p, const float (&x)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(x[0]);
  } else {
    uint32_t w[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    if constexpr (V == 2) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// V values rounded to bf16 in place (the forward's s).
template <int V>
__device__ __forceinline__ void round_bf16(float (&x)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) x[i] = __bfloat162float(__float2bfloat16_rn(x[i]));
}

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
    wukong_ln_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ l, const bf16* __restrict__ r,
                         const float* __restrict__ scale, const float* __restrict__ shift, bf16* __restrict__ s,
                         bf16* __restrict__ y, float* __restrict__ mean, float* __restrict__ rstd, long long rows,
                         int m, int n_f, float eps) {
  constexpr int D = 32 * V;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = lane * V;
  float sc[V], sh[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sc[i] = scale[c0 + i], sh[i] = shift[c0 + i];
  const long long first = ((long long)blockIdx.x * kWarps + warp) * kFwdRowsPerWarp;
  for (int k = 0; k < kFwdRowsPerWarp; ++k) {
    const long long row = first + k;
    if (row >= rows) break;
    const long long b = row / m;
    const int j = (int)(row - b * m);
    const bf16* part = j < n_f ? h + (b * n_f + j) * D : l + (b * (m - n_f) + (j - n_f)) * D;
    float x[V], res[V];
    load<V>(x, part + c0);
    load<V>(res, r + row * D + c0);
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] += res[i];
    round_bf16<V>(x);
    store<V>(s + row * D + c0, x);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) sum += x[i];
    const float mu = warp_sum(sum) / D;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) var += (x[i] - mu) * (x[i] - mu);
    const float rs = 1.f / sqrtf(warp_sum(var) / D + eps);
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = (x[i] - mu) * rs * sc[i] + sh[i];
    store<V>(y + row * D + c0, x);
    if (lane == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
    wukong_ln_bwd_kernel(const bf16* __restrict__ g, const bf16* __restrict__ s, const float* __restrict__ mean,
                         const float* __restrict__ rstd, const float* __restrict__ scale, bf16* __restrict__ g_s,
                         bf16* __restrict__ g_h, float* __restrict__ partials, long long rows, int m, int n_f) {
  constexpr int D = 32 * V;
  __shared__ float red[kWarps][2 * D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = lane * V;
  float sc[V], gsc[V], gsh[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sc[i] = scale[c0 + i], gsc[i] = 0.f, gsh[i] = 0.f;
  const long long first = ((long long)blockIdx.x * kWarps + warp) * kBwdRowsPerWarp;
  for (int k = 0; k < kBwdRowsPerWarp; ++k) {
    const long long row = first + k;
    if (row >= rows) break;
    float gv[V], x[V];
    load<V>(gv, g + row * D + c0);
    load<V>(x, s + row * D + c0);
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      x[i] = (x[i] - mu) * rs;
      gsc[i] += gv[i] * x[i];
      gsh[i] += gv[i];
      gv[i] *= sc[i];
      s1 += gv[i];
      s2 += gv[i] * x[i];
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
    for (int i = 0; i < V; ++i) gv[i] = rs * (gv[i] - m1 - x[i] * m2);
    store<V>(g_s + row * D + c0, gv);
    const long long b = row / m;
    const int j = (int)(row - b * m);
    if (j < n_f) store<V>(g_h + (b * n_f + j) * D + c0, gv);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[warp][c0 + i] = gsc[i];
    red[warp][D + c0 + i] = gsh[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) {
    float t = red[0][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += red[w][c];
    partials[(long long)blockIdx.x * 2 * D + c] = t;
  }
}

// block 32 x kSumRows: thread (x, y) sums rows y, y + kSumRows, ... of column
// 32 blockIdx.x + x, then thread (x, 0) the kSumRows sums in order
__global__ void __launch_bounds__(32 * kSumRows)
    wukong_ln_grad_sum_kernel(const float* __restrict__ partials, float* __restrict__ g_scale,
                              float* __restrict__ g_shift, int p, int d) {
  __shared__ float sums[kSumRows][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float v = 0.f;
  if (c < 2 * d)
    for (int i = ty; i < p; i += kSumRows) v += partials[(long long)i * 2 * d + c];
  sums[ty][tx] = v;
  __syncthreads();
  if (ty != 0 || c >= 2 * d) return;
  float t = sums[0][tx];
#pragma unroll
  for (int k = 1; k < kSumRows; ++k) t += sums[k][tx];
  if (c < d)
    g_scale[c] = t;
  else
    g_shift[c - d] = t;
}

long long bwd_blocks(long long rows) { return (rows + kWarps * kBwdRowsPerWarp - 1) / (kWarps * kBwdRowsPerWarp); }

template <int V>
int launch_fwd(const void* h, const void* l, const void* r, const void* scale, const void* shift, void* s, void* y,
               void* mean, void* rstd, long long rows, int m, int n_f, float eps, cudaStream_t st) {
  const long long per_block = (long long)kWarps * kFwdRowsPerWarp;
  wukong_ln_fwd_kernel<V><<<(unsigned)((rows + per_block - 1) / per_block), kWarps * 32, 0, st>>>(
      (const bf16*)h, (const bf16*)l, (const bf16*)r, (const float*)scale, (const float*)shift, (bf16*)s, (bf16*)y,
      (float*)mean, (float*)rstd, rows, m, n_f, eps);
  return (int)cudaGetLastError();
}

template <int V>
int launch_bwd(const void* g, const void* s, const void* mean, const void* rstd, const void* scale, void* g_s,
               void* g_h, void* partials, void* g_scale, void* g_shift, long long rows, int m, int n_f,
               cudaStream_t st) {
  const long long p = bwd_blocks(rows);
  if (p > 0) {
    wukong_ln_bwd_kernel<V><<<(unsigned)p, kWarps * 32, 0, st>>>(
        (const bf16*)g, (const bf16*)s, (const float*)mean, (const float*)rstd, (const float*)scale, (bf16*)g_s,
        (bf16*)g_h, (float*)partials, rows, m, n_f);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  wukong_ln_grad_sum_kernel<<<(2 * 32 * V + 31) / 32, dim3(32, kSumRows), 0, st>>>(
      (const float*)partials, (float*)g_scale, (float*)g_shift, (int)p, 32 * V);
  return (int)cudaGetLastError();
}

bool shape_ok(long long b, int m, int n_f, int d) {
  return b >= 0 && m >= 1 && n_f >= 0 && n_f <= m && (d == 32 || d == 64 || d == 128 || d == 256);
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

}  // namespace

// Floats of rm_wukong_ln_backward's partials for b examples of m rows of d.
extern "C" long long rm_wukong_ln_partial_floats(long long b, int m, int d) {
  if (!shape_ok(b, m, 0, d)) return -1;
  const long long p = bwd_blocks(b * m);
  return (p > 0 ? p : 1) * 2 * d;
}

// h [b, n_f d], l [b, m - n_f, d], r [b, m, d] bf16, scale, shift [d] f32 ->
// s, y [b, m, d] bf16, mean, rstd [b m] f32. d 32, 64, 128 or 256; the bf16
// tensors 16-byte aligned.
extern "C" int rm_wukong_ln_forward(int device, const void* h, const void* l, const void* r, const void* scale,
                                    const void* shift, void* s, void* y, void* mean, void* rstd, long long b, int m,
                                    int n_f, int d, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!shape_ok(b, m, n_f, d) || !aligned16(h) || !aligned16(l) || !aligned16(r) || !aligned16(s) ||
      !aligned16(y))
    return (int)cudaErrorInvalidValue;
  const long long rows = b * m;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 32) return launch_fwd<1>(h, l, r, scale, shift, s, y, mean, rstd, rows, m, n_f, eps, st);
  if (d == 64) return launch_fwd<2>(h, l, r, scale, shift, s, y, mean, rstd, rows, m, n_f, eps, st);
  if (d == 128) return launch_fwd<4>(h, l, r, scale, shift, s, y, mean, rstd, rows, m, n_f, eps, st);
  return launch_fwd<8>(h, l, r, scale, shift, s, y, mean, rstd, rows, m, n_f, eps, st);
}

// g, s [b, m, d] bf16, mean, rstd [b m] f32, scale [d] f32 -> g_s [b, m, d]
// bf16, g_h [b, n_f d] bf16 (g_s's rows j < n_f), partials (scratch,
// rm_wukong_ln_partial_floats), g_scale, g_shift [d] f32.
extern "C" int rm_wukong_ln_backward(int device, const void* g, const void* s, const void* mean, const void* rstd,
                                     const void* scale, void* g_s, void* g_h, void* partials, void* g_scale,
                                     void* g_shift, long long b, int m, int n_f, int d, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!shape_ok(b, m, n_f, d) || !aligned16(g) || !aligned16(s) || !aligned16(g_s) || !aligned16(g_h))
    return (int)cudaErrorInvalidValue;
  const long long rows = b * m;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 32) return launch_bwd<1>(g, s, mean, rstd, scale, g_s, g_h, partials, g_scale, g_shift, rows, m, n_f, st);
  if (d == 64) return launch_bwd<2>(g, s, mean, rstd, scale, g_s, g_h, partials, g_scale, g_shift, rows, m, n_f, st);
  if (d == 128) return launch_bwd<4>(g, s, mean, rstd, scale, g_s, g_h, partials, g_scale, g_shift, rows, m, n_f, st);
  return launch_bwd<8>(g, s, mean, rstd, scale, g_s, g_h, partials, g_scale, g_shift, rows, m, n_f, st);
}
