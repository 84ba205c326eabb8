// The bf16 MLP's epilogues around each layer's f32 product
// (recmodels_tpu_torch/nn/mlp.py MlpStack), one pass forward and one back:
//
//   mlp_bias_act_fwd_kernel: z [B, N] f32 (cuBLAS's f32 sum of the bf16
//     products) and the bias b [N] f32 -> h = bf16(relu(z + b)) [B, N], or
//     bf16(z + b) for a linear layer;
//   mlp_act_bwd_kernel: the cotangent g of h, f32 (the layer above's input
//     grad, straight from cuBLAS) or bf16 -> g_z = bf16(g) [B, N], zero where
//     h <= 0 for a ReLU layer, and f32 column sums of g_z a block of rows
//     (partials [P, N]);
//   mlp_bias_grad_kernel: the partials summed in a fixed order -> the bias's
//     grad g_b [N] f32.
//
// Replaces: none. The JAX package leaves the bias add, ReLU and convert
// around its dot_general to XLA, which fuses them into the product. PyTorch
// ran each as a pass of its own over the f32 product: z + b, relu and the
// cast forward (22 bytes an output element), and back the cast's backward,
// threshold_backward against the f32 ReLU output, the bias's batch sum and
// the cotangent's and the input grad's casts to bf16 (28 bytes an output
// element and 6 an input element), where one pass each way needs 6 and 8.
//
// Rounding points: those of that chain. z + b in f32, round to nearest even
// to bf16 (__float2bfloat16_rn, the cast's); g rounds to bf16 once, as
// ProductF32's backward rounded it. So h and g_z have the chain's bits. The
// one difference: the ReLU mask reads bf16 h, not the f32 output; the two
// differ only for outputs in (0, 2^-134], which round to bf16 zero. g_b sums
// the same bf16 values in f32, in another order, fixed: no atomics, so two
// calls (an eager step, a replay) give the same bits. NaN: relu passes it as
// torch.relu does (fmaxf would drop it), and h = NaN passes the grad as
// threshold_backward does (h <= 0 is false).
//
// Bound on this card: bytes. The forward reads 4 bytes and writes 2 an
// element; the backward reads 4 (2 for a bf16 g) and, for a ReLU layer, 2
// of h, and writes 2, plus the partials: [B / 64, N] f32 at N >= 256, under
// 2% of its bytes. At DLRM-DCNv2's [16,384, 1,024] the forward moves 101 MB.
//
// Design: a thread takes 8 consecutive elements of a row as 16-byte loads
// and stores where N % 8 == 0 and every pointer is 16-byte aligned (the
// wrapper passes vec = 8), else one element (vec = 1: the logit's N = 1, a
// view off 16 bytes). The backward's block is TX x TY = 256 threads: TX
// threads across the columns (TX * vec of them, at most 256), TY rows of
// threads, each taking kRowsPerThread rows TY apart, all of whose loads are
// issued before the first add. A block sums its thread rows' column sums
// through shared memory in thread-row order into its row of partials; the
// bias grad kernel sums the partials' rows, 8 threads a column, each over
// rows 8 apart, then those 8 in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kSumRows = 8;  // threads a column in the bias grad kernel

struct Geometry {
  int tx, ty, rows_per_block;
  dim3 grid;
};

// the backward's block shape and grid: TX a power of two covering the
// row's vectors up to 32
Geometry geometry(int rows, int n, int vec) {
  Geometry g;
  const int cols = (n + vec - 1) / vec;
  g.tx = 1;
  while (g.tx < cols && g.tx < 32) g.tx *= 2;
  g.ty = kThreads / g.tx;
  g.rows_per_block = g.ty * kRowsPerThread;
  g.grid = dim3((cols + g.tx - 1) / g.tx, (rows + g.rows_per_block - 1) / g.rows_per_block);
  return g;
}

template <int V>
__device__ __forceinline__ void load(float (&x)[V], const float* p) {
  if constexpr (V == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load(float (&x)[V], const __nv_bfloat16* p) {
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(q[j]);
      x[2 * j] = f.x, x[2 * j + 1] = f.y;
    }
  } else {
    x[0] = __bfloat162float(*p);
  }
}

// V bf16 values as they are, 16 bytes at V = 8
template <int V>
__device__ __forceinline__ void load_raw(__nv_bfloat16 (&x)[V], const __nv_bfloat16* p) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(x) = *reinterpret_cast<const uint4*>(p);
  } else {
    x[0] = *p;
  }
}

// x rounded to bf16 (round to nearest even), stored
template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float (&x)[V]) {
  if constexpr (V == 8) {
    uint4 u;
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(x[0]);
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// thread i takes elements [V i, V i + V), all in one row (N % V == 0)
template <bool RELU, int V>
__global__ void __launch_bounds__(kThreads)
    mlp_bias_act_fwd_kernel(const float* __restrict__ z, const float* __restrict__ b,
                            __nv_bfloat16* __restrict__ h, long long count, int n) {
  const long long e = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * V;
  if (e >= count) return;
  float x[V], bias[V];
  load<V>(x, z + e);
  load<V>(bias, b + e % n);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float v = x[j] + bias[j];
    x[j] = (RELU && v <= 0.f) ? 0.f : v;  // NaN > 0 and NaN <= 0 are both false: NaN stays
  }
  store_bf16<V>(h + e, x);
}

// G: the cotangent's type (float or __nv_bfloat16); RELU: mask by h
template <typename G, bool RELU, int V>
__global__ void __launch_bounds__(kThreads)
    mlp_act_bwd_kernel(const G* __restrict__ g, const __nv_bfloat16* __restrict__ h,
                       __nv_bfloat16* __restrict__ gz, float* __restrict__ partials, int rows, int n) {
  __shared__ float sums[kThreads * V];  // [ty][tx * V + j]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int width = blockDim.x * V;  // the block's columns
  const int c0 = blockIdx.x * width + tx * V;
  const int r0 = blockIdx.y * blockDim.y * kRowsPerThread + ty;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (c0 < n) {
    float x[kRowsPerThread][V];
    alignas(16) __nv_bfloat16 m[kRowsPerThread][V];  // h as loaded: half the registers of floats
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = r0 + k * blockDim.y;
      if (r < rows) {
        const long long e = (long long)r * n + c0;
        load<V>(x[k], g + e);
        if (RELU) load_raw<V>(m[k], h + e);
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = r0 + k * blockDim.y;
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float v = (RELU && __bfloat162float(m[k][j]) <= 0.f) ? 0.f : round_bf16(x[k][j]);
          x[k][j] = v;
          acc[j] += v;
        }
        store_bf16<V>(gz + (long long)r * n + c0, x[k]);
      }
    }
  }
  float* mine = sums + ty * width + tx * V;
#pragma unroll
  for (int j = 0; j < V; ++j) mine[j] = acc[j];
  __syncthreads();
  const int t = ty * blockDim.x + tx;
  const int c = blockIdx.x * width + t;
  if (t < width && c < n) {
    float s = sums[t];
    for (int y = 1; y < (int)blockDim.y; ++y) s += sums[y * width + t];
    partials[(long long)blockIdx.y * n + c] = s;
  }
}

// block 32 x kSumRows: thread (x, y) sums rows y, y + kSumRows, ... of
// column 32 blockIdx.x + x, then thread (x, 0) the kSumRows sums in order
__global__ void __launch_bounds__(32 * kSumRows)
    mlp_bias_grad_kernel(const float* __restrict__ partials, float* __restrict__ gb, int p, int n) {
  __shared__ float sums[kSumRows][32];
  const int x = threadIdx.x, y = threadIdx.y;
  const int c = blockIdx.x * 32 + x;
  float s = 0.f;
  if (c < n)
    for (int i = y; i < p; i += kSumRows) s += partials[(long long)i * n + c];
  sums[y][x] = s;
  __syncthreads();
  if (y == 0 && c < n) {
    float t = sums[0][x];
#pragma unroll
    for (int k = 1; k < kSumRows; ++k) t += sums[k][x];
    gb[c] = t;
  }
}

template <bool RELU, int V>
int launch_fwd(const void* z, const void* b, void* h, long long count, int n, cudaStream_t s) {
  const long long threads = count / V;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  mlp_bias_act_fwd_kernel<RELU, V><<<blocks, kThreads, 0, s>>>(
      (const float*)z, (const float*)b, (__nv_bfloat16*)h, count, n);
  return (int)cudaGetLastError();
}

template <typename G, bool RELU, int V>
int launch_bwd(const Geometry& geo, const void* g, const void* h, void* gz, void* partials, int rows, int n,
               cudaStream_t s) {
  mlp_act_bwd_kernel<G, RELU, V><<<geo.grid, dim3(geo.tx, geo.ty), 0, s>>>(
      (const G*)g, (const __nv_bfloat16*)h, (__nv_bfloat16*)gz, (float*)partials, rows, n);
  return (int)cudaGetLastError();
}

template <typename G>
int launch_bwd_for(const Geometry& geo, const void* g, const void* h, void* gz, void* partials, int rows, int n,
                   int vec, cudaStream_t s) {
  if (vec == 8)
    return h ? launch_bwd<G, true, 8>(geo, g, h, gz, partials, rows, n, s)
             : launch_bwd<G, false, 8>(geo, g, h, gz, partials, rows, n, s);
  return h ? launch_bwd<G, true, 1>(geo, g, h, gz, partials, rows, n, s)
           : launch_bwd<G, false, 1>(geo, g, h, gz, partials, rows, n, s);
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

}  // namespace

// Rows of the backward's partials for a [rows, n] cotangent at vec (8 or 1).
extern "C" int rm_mlp_partial_rows(int rows, int n, int vec) {
  if (rows < 0 || n < 1 || (vec != 1 && vec != 8)) return -1;
  return (int)geometry(rows, n, vec).grid.y;
}

// z [rows, n] f32, b [n] f32 -> h [rows, n] bf16 = bf16(relu(z + b)) (relu
// = 0: bf16(z + b)). vec = 8 needs n % 8 == 0 and 16-byte aligned pointers.
extern "C" int rm_mlp_bias_act(int device, const void* z, const void* b, void* h, int rows, int n, int relu,
                               int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || n < 1 || (vec != 1 && vec != 8)) return (int)cudaErrorInvalidValue;
  if (vec == 8 && (n % 8 || !aligned16(z) || !aligned16(b) || !aligned16(h))) return (int)cudaErrorInvalidValue;
  const long long count = (long long)rows * n;
  if (count == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 8) return relu ? launch_fwd<true, 8>(z, b, h, count, n, s) : launch_fwd<false, 8>(z, b, h, count, n, s);
  return relu ? launch_fwd<true, 1>(z, b, h, count, n, s) : launch_fwd<false, 1>(z, b, h, count, n, s);
}

// g [rows, n] (bf16 when g_bf16, else f32), h [rows, n] bf16 (null: a
// linear layer, no mask) -> gz [rows, n] bf16, partials
// [rm_mlp_partial_rows(rows, n, vec), n] f32 (scratch), gb [n] f32. vec as
// for rm_mlp_bias_act (g, h, gz aligned).
extern "C" int rm_mlp_act_backward(int device, const void* g, const void* h, void* gz, void* partials, void* gb,
                                   int rows, int n, int g_bf16, int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || n < 1 || (vec != 1 && vec != 8)) return (int)cudaErrorInvalidValue;
  if (vec == 8 && (n % 8 || !aligned16(g) || (h && !aligned16(h)) || !aligned16(gz)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Geometry geo = geometry(rows, n, vec);
  if (rows > 0) {
    const int e = g_bf16 ? launch_bwd_for<__nv_bfloat16>(geo, g, h, gz, partials, rows, n, vec, s)
                         : launch_bwd_for<float>(geo, g, h, gz, partials, rows, n, vec, s);
    if (e != 0) return e;
  }
  mlp_bias_grad_kernel<<<(n + 31) / 32, dim3(32, kSumRows), 0, s>>>((const float*)partials, (float*)gb,
                                                                   (int)geo.grid.y, n);
  return (int)cudaGetLastError();
}
