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
// arithmetic is about 5 operations a value a layer. In bf16, though, each
// of a value's three roundings a layer done as an f32 -> bf16 conversion
// runs at the conversion rate, 16 a clock an SM: 19 us at DCN's shape,
// twice the byte bound. The register paths therefore compute bf16 rows
// with packed bf16 operations, which round at the same points with no
// conversion (cross_rows_bf16), and f32 rows with f32 ones (cross_row).
//
// Design, three paths chosen by shape and alignment (the wrapper's
// dcn_rows_in_registers says which of the first two and the last):
//  * staged rows (d <= 1024 and w and b of all layers within 48 KB, so DCN's
//    d = 429 up to 28 bf16 or 14 f32 layers, x0 and out 16-byte aligned):
//    the unit is a period, the least number n0 of rows that spans whole
//    16-byte chunks (8 rows in bf16 at d = 429, 6,864 bytes; 4 in f32). A
//    group is as many periods as fit in 16 KB (16 bf16 rows, 8 f32), fewer
//    when the batch has fewer groups than resident blocks. Persistent
//    blocks, four an SM and never more than the groups, each take an equal
//    share of the periods. A block copies a group into shared memory by
//    16-byte cp.async (the batch's last, ragged chunk zero-filled) and
//    double-buffers: the next group's copy is in flight while the warps
//    compute this one. A warp takes staged rows (two at a time in bf16 up
//    to d = 512, one in f32): lane j holds a row's values j, j + 32, ...
//    in registers (x0 and x_l: 14 of each at d = 429; in bf16 as pairs of
//    bf16 values), each layer sums the lane's products in that order by
//    fmaf, reduces across the warp by xor shuffles (16, 8, 4, 2, 1: every
//    lane ends with the same t) and updates its values; x_L goes back into
//    the staged row, and the block stores the group by 16-byte chunks. w
//    (as f32) and b of all layers sit in shared memory, copied once per
//    block;
//  * unaligned rows (the same shapes, x0 or out off 16 bytes): one warp per
//    row read and written in device memory by element (a bf16 row of odd d
//    starts 2 bytes off a 4-byte boundary every other row, and a wider
//    access would fault there) through the staged path's row functions, one
//    row at a time, so the two paths agree bit for bit;
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

#include <atomic>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBytes = 48 * 1024;   // w and b of the register paths in their type, at most
constexpr int kGroupBytes = 16 * 1024;  // a staged group, at most
constexpr int kBlocksPerSm = 4;
// dynamic shared memory of the register paths, at most: w as f32 and b in
// their type (1.5 kSmemBytes in bf16, 1 in f32), then two staged groups
constexpr int kMaxDynSmem = kSmemBytes * 3 / 2 + 16 + 2 * kGroupBytes;

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

// The L layers of one f32 row in a warp: lane j holds columns j + 32 k,
// k < V (d <= 32 V), read from xr and written to orow (shared or device
// memory); w and b [L, d] in shared memory.
template <int V>
__device__ __forceinline__ void cross_row(const float* xr, float* orow, const float* ws,
                                          const float* bs, int d, int n_layers, int lane) {
  float xv[V], lv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = lane + 32 * k;
    xv[k] = c < d ? xr[c] : 0.f;
    lv[k] = xv[k];
  }
  for (int l = 0; l < n_layers; ++l) {
    const float* wl = ws + l * d;
    const float* bl = bs + l * d;
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      if (c < d) t = fmaf(lv[k], wl[c], t);
    }
    const float tr = warp_sum(t);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      if (c < d) lv[k] = cross<float>(xv[k], tr, bl[c], lv[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = lane + 32 * k;
    if (c < d) orow[c] = lv[k];
  }
}

// Two bf16 values in a 32-bit register, the first in the low half, and
// the packed bf16 operations on them. Each rounds its exact result once
// to bf16, to nearest even, as the f32 operation and the cvt do on bf16
// operands: a product of two bf16 values is exact in f32 down to 2^-134,
// below which both round to 0; a sum of two has more than f32's 24 bits
// only where the smaller value is under 2^-15 of the larger, and then both
// roundings return the larger.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ float low_f32(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float high_f32(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }

// The L layers of R bf16 rows at once in a warp (row r read from src[r]
// and written to dst[r], shared or device memory, in place or not) with w
// in shared memory as f32 and b as bf16 bits: cross_row's sums in the same
// order, rounded at the same points. Lane j holds x0 and x_l
// at columns j + 32 k in pairs of bf16 (k = 2 p low, 2 p + 1 high), so a
// layer's elementwise update is three packed operations for two values
// and needs no f32 -> bf16 conversion, whose rate (16 a clock an SM)
// bounds cross_row; only t is converted, once a row a layer. Each w and b
// load serves the R rows.
template <int V, int R>
__device__ __forceinline__ void cross_rows_bf16(const uint16_t* const* src, uint16_t* const* dst,
                                                const float* ws, const uint16_t* bs, int d,
                                                int n_layers, int lane) {
  constexpr int P = (V + 1) / 2;
  uint32_t xp[R][P], lv[R][P];  // x0 and x_l, 0 past the row
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c0 = lane + 64 * p, c1 = c0 + 32;
      xp[r][p] = (c0 < d ? (uint32_t)src[r][c0] : 0u) |
                 (2 * p + 1 < V && c1 < d ? (uint32_t)src[r][c1] << 16 : 0u);
      lv[r][p] = xp[r][p];
    }
  }
  for (int l = 0; l < n_layers; ++l) {
    const float* wl = ws + l * d;
    const uint16_t* bl = bs + l * d;
    float t[R];
#pragma unroll
    for (int r = 0; r < R; ++r) t[r] = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      if (c < d) {
        const float w = wl[c];
#pragma unroll
        for (int r = 0; r < R; ++r)
          t[r] = fmaf(k % 2 ? high_f32(lv[r][k / 2]) : low_f32(lv[r][k / 2]), w, t[r]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] += __shfl_xor_sync(0xffffffffu, t[r], o);
    }
    uint32_t tp[R];  // t rounded to bf16, in both halves
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t tb = __bfloat16_as_ushort(__float2bfloat16_rn(t[r]));
      tp[r] = tb | tb << 16;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c0 = lane + 64 * p, c1 = c0 + 32;
      const uint32_t b = (c0 < d ? (uint32_t)bl[c0] : 0u) |
                         (2 * p + 1 < V && c1 < d ? (uint32_t)bl[c1] << 16 : 0u);
#pragma unroll
      for (int r = 0; r < R; ++r)
        lv[r][p] = add_bf16x2(add_bf16x2(mul_bf16x2(xp[r][p], tp[r]), b), lv[r][p]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      if (c < d) dst[r][c] = (uint16_t)(k % 2 ? lv[r][k / 2] >> 16 : lv[r][k / 2]);
    }
  }
}

// One block's share on the staged path: whole periods of n0 rows, an equal
// share of the batch's (the last period may be ragged at b), walked in
// groups of tb rows.
struct Share {
  long long r0, r1;  // the block's rows
  int tb, ng;        // rows a group, and the block's groups
  __device__ Share(long long b, int n0, int tb_) : tb(tb_) {
    const long long periods = (b + n0 - 1) / n0;
    r0 = (long long)blockIdx.x * periods / gridDim.x * n0;
    r1 = min(((long long)blockIdx.x + 1) * periods / gridDim.x * n0, b);
    ng = (int)((r1 - r0 + tb - 1) / tb);
  }
  __device__ long long first(int g) const { return r0 + (long long)g * tb; }
  __device__ int count(int g) const { return (int)min((long long)tb, r1 - first(g)); }
};

// Staged rows. Shared memory: w [L, d] as f32, b [L, d] as T, then
// [2][tb * d] T.
template <typename T, int V>
__global__ void dcn_cross_staged_kernel(const T* __restrict__ x0, const T* __restrict__ w,
                                        const T* __restrict__ bias, T* __restrict__ out,
                                        long long b, int d, int n_layers, int n0, int tb) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ uint4 smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);
  T* bs = reinterpret_cast<T*>(ws + n_layers * d);
  T* buf = reinterpret_cast<T*>(smem_raw + (n_layers * d * (4 + (int)sizeof(T)) + 15) / 16);
  const int group = tb * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Share sh(b, n0, tb);
  auto issue = [&](int g, int slot) {
    if (g < sh.ng) {
      const int elems = sh.count(g) * d;
      const int chunks = (elems + kVec - 1) / kVec;
      T* dst = buf + slot * group;
      const T* src = x0 + sh.first(g) * d;
      for (int c = threadIdx.x; c < chunks; c += kThreads) {
        const int left = elems - c * kVec;
        if (left >= kVec)
          rm::cp_async16(dst + c * kVec, src + c * kVec);
        else
          rm::cp_async16_zfill(dst + c * kVec, src + c * kVec, left * (int)sizeof(T));
      }
    }
    rm::cp_async_commit();
  };
  issue(0, 0);
  for (int k = threadIdx.x; k < n_layers * d; k += kThreads) {
    ws[k] = to_f32(w[k]);
    bs[k] = bias[k];
  }
  int slot = 0;
  for (int g = 0; g < sh.ng; ++g, slot ^= 1) {
    issue(g + 1, slot ^ 1);
    rm::cp_async_wait<1>();
    __syncthreads();  // group g has landed in `slot` (and w, b are converted)
    T* s = buf + slot * group;
    const int n = sh.count(g);
    if constexpr (sizeof(T) == 2) {
      constexpr int R = V <= 16 ? 2 : 1;  // rows a warp takes at a time, where registers allow
      uint16_t* bits = reinterpret_cast<uint16_t*>(s);
      const uint16_t* b16 = reinterpret_cast<const uint16_t*>(bs);
      for (int r = R * warp; r < n; r += R * kWarps) {
        uint16_t* rows[2] = {bits + r * d, bits + (r + 1) * d};
        if (R == 2 && r + 1 < n)
          cross_rows_bf16<V, R>(rows, rows, ws, b16, d, n_layers, lane);
        else
          cross_rows_bf16<V, 1>(rows, rows, ws, b16, d, n_layers, lane);  // the group's last row
      }
    } else {
      for (int r = warp; r < n; r += kWarps)
        cross_row<V>(s + r * d, s + r * d, ws, bs, d, n_layers, lane);
    }
    __syncthreads();  // x_L of the group is in `slot`
    const int elems = n * d;
    T* dst = out + sh.first(g) * d;
    for (int c = threadIdx.x; c * kVec < elems; c += kThreads) {
      if ((c + 1) * kVec <= elems) {
        reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(s)[c];
      } else {
        for (int e = c * kVec; e < elems; ++e) dst[e] = s[e];
      }
    }
    __syncthreads();  // every thread is done with `slot` before it is refilled
  }
}

// Unaligned rows: one warp per row, read and written in device memory.
// Shared memory: w [L, d] as f32, b [L, d] as T, as the staged kernel's.
template <typename T, int V>
__global__ void dcn_cross_kernel(const T* __restrict__ x0,
                                 const T* __restrict__ w,
                                 const T* __restrict__ bias,
                                 T* __restrict__ out, int b, int d,
                                 int n_layers) {
  extern __shared__ uint4 smem_raw[];  // one declaration in this file: the staged kernel's
  float* ws = reinterpret_cast<float*>(smem_raw);
  T* bs = reinterpret_cast<T*>(ws + n_layers * d);
  for (int k = threadIdx.x; k < n_layers * d; k += blockDim.x) {
    ws[k] = to_f32(w[k]);
    bs[k] = bias[k];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < b;
       r += (long long)gridDim.x * kWarps) {
    if constexpr (sizeof(T) == 2) {
      const uint16_t* src[1] = {reinterpret_cast<const uint16_t*>(x0 + r * d)};
      uint16_t* dst[1] = {reinterpret_cast<uint16_t*>(out + r * d)};
      cross_rows_bf16<V, 1>(src, dst, ws, reinterpret_cast<const uint16_t*>(bs), d, n_layers, lane);
    } else {
      cross_row<V>(x0 + r * d, out + r * d, ws, bs, d, n_layers, lane);
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

// least count of rows of `bytes` that spans whole 16-byte chunks
int whole_chunks(long long bytes) {
  int n = 1;
  while ((n * bytes) % 16) n *= 2;
  return n;
}

template <typename T, int V>
int launch_v(const void* x0, const void* w, const void* bias, void* out, int b, int d,
             int n_layers, bool aligned, int device, int sms, cudaStream_t s) {
  // both kernels may take kMaxDynSmem bytes; set once a device (the first 64)
  static std::atomic<unsigned long long> smem_allowed{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (!(smem_allowed.load() & bit)) {
    cudaError_t err = cudaFuncSetAttribute(dcn_cross_staged_kernel<T, V>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dcn_cross_kernel<T, V>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed.fetch_or(bit);
  }
  const long long resident = (long long)sms * kBlocksPerSm;
  const int smem_ws = (n_layers * (int)(d * (4 + sizeof(T))) + 15) / 16 * 16;  // w as f32, b
  if (!aligned) {
    const long long want = ((long long)b + kWarps - 1) / kWarps;
    const unsigned blocks = (unsigned)(want < resident ? want : resident);
    dcn_cross_kernel<T, V><<<blocks, kThreads, smem_ws, s>>>(
        (const T*)x0, (const T*)w, (const T*)bias, (T*)out, b, d, n_layers);
    return (int)cudaGetLastError();
  }
  const long long row_bytes = (long long)d * sizeof(T);
  const int n0 = whole_chunks(row_bytes);  // a period's bytes are at most 16 KB at d <= 1024
  const long long periods = ((long long)b + n0 - 1) / n0;
  long long per_group = kGroupBytes / (n0 * row_bytes);
  // a batch of fewer groups than resident blocks is cut into smaller ones
  const long long spread = (periods + resident - 1) / resident;
  if (spread < per_group) per_group = spread;
  const int tb = n0 * (int)per_group;
  const long long groups = (periods + per_group - 1) / per_group;
  const unsigned blocks = (unsigned)(groups < resident ? groups : resident);
  const int smem = smem_ws + 2 * tb * (int)row_bytes;
  dcn_cross_staged_kernel<T, V><<<blocks, kThreads, smem, s>>>(
      (const T*)x0, (const T*)w, (const T*)bias, (T*)out, b, d, n_layers, n0, tb);
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
  const bool aligned = ((reinterpret_cast<uintptr_t>(x0) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (d <= 32) return launch_v<T, 1>(x0, w, bias, out, b, d, n_layers, aligned, device, sms, s);
  if (d <= 64) return launch_v<T, 2>(x0, w, bias, out, b, d, n_layers, aligned, device, sms, s);
  if (d <= 128) return launch_v<T, 4>(x0, w, bias, out, b, d, n_layers, aligned, device, sms, s);
  if (d <= 256) return launch_v<T, 8>(x0, w, bias, out, b, d, n_layers, aligned, device, sms, s);
  if (d <= 448) return launch_v<T, 14>(x0, w, bias, out, b, d, n_layers, aligned, device, sms, s);  // DCN's 429
  if (d <= 512) return launch_v<T, 16>(x0, w, bias, out, b, d, n_layers, aligned, device, sms, s);
  return launch_v<T, 32>(x0, w, bias, out, b, d, n_layers, aligned, device, sms, s);
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
