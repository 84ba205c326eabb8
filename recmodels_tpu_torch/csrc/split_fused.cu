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
// D = 16, bf16) the forward reads 14.5 MB and writes 13.6 MB plus 64 KB of
// sums; the arithmetic is 26 adds per example. The backward reads 13.6 MB of
// g_dm and 64 KB of g_ws and writes 14.5 MB; the bf16 cast of g_ws is
// __float2bfloat16_rn, JAX's astype.
//
// Design: the pattern of transpose.cu (the field-matrix transpose) with the
// extra column. An example's rows and its D-major block are each contiguous,
// but at m = 26, D = 16 in bf16 its 884 input bytes are not a whole number
// of 16-byte chunks, so the unit of work is a period: the least number n0 of
// whole examples whose input and output both span whole chunks (4 there; at
// most 8 in bf16 and 4 in f32). A group is as many periods as fit in 16 KB
// (16 examples, 14,144 bytes at the serving shape), fewer when the batch has
// fewer groups than resident blocks. Persistent blocks, four an SM and never
// more than the groups, each take an equal share of the periods. A block
// copies a group's input into shared memory with 16-byte cp.async (the last,
// ragged chunk of the batch zero-filled) and double-buffers: the next
// group's copy is in flight while this one is assembled. Each thread then
// builds 16 bytes of output (8 bf16 or 4 f32) from their source positions,
// read from a table that the block builds once for a period (so no division
// per element), and writes them with one 16-byte store. In the forward a
// warp an example sums the wide column in f32 from shared memory (lanes over
// the slots, then a shuffle tree) while the group is resident. In the
// backward a table entry with the top bit set names the example whose g_ws
// fills that lane: thread e loads example e's g_ws when its group's copy is
// issued and stores it cast into shared memory beside the group, so every
// lane is one shared-memory load. Shared memory is not padded: a 16-byte pad
// every 128 bytes (transpose.cu's) measured slower here.
//
// Periods past 16 KB, and bases off 16 bytes, take the plain path of
// the same kernel: a block stages a group of whole examples (up to 16 KB, or
// one example) element by element, and warps write columns with lanes over
// the slots. Its wide sum is the same function, so the two paths agree bit
// for bit. An example's rows must fit in 48 KB (kMaxExampleBytes, the
// wrapper's SPLIT_FUSED_MAX_EXAMPLE_BYTES); past it the entries return
// cudaErrorInvalidValue.

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kGroupBytes = 16 * 1024;         // a group of the 16-byte path, at most
constexpr int kPlainBytes = 16 * 1024;         // a group of the plain path
constexpr int kMaxExampleBytes = 48 * 1024;    // m (D+1) elements

// Elements are moved as bits: uint16_t holds bf16, uint32_t f32.
__device__ __forceinline__ float to_f32(uint16_t h) { return __uint_as_float((uint32_t)h << 16); }
__device__ __forceinline__ float to_f32(uint32_t u) { return __uint_as_float(u); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ uint16_t from_f32<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ uint32_t from_f32<uint32_t>(float v) { return __float_as_uint(v); }

// sum of s[at + i * stride] over the m slots i, in f32: lane-strided, then a
// shuffle tree (every lane gets the sum); the same order on both paths
template <typename T>
__device__ __forceinline__ float column_sum(const T* s, int at, int stride, int m, int lane) {
  float acc = 0.f;
  for (int i = lane; i < m; i += 32) acc += to_f32(s[at + i * stride]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

template <typename T>
union Chunk {
  uint4 u;
  T e[16 / sizeof(T)];
};

// a chunk's source positions within its period
template <typename T>
struct alignas(32 / sizeof(T)) Offsets {
  uint16_t h[16 / sizeof(T)];
};

constexpr uint16_t kWide = 0x8000;  // backward table: the lane takes g_ws of example (h & 0x7fff)

// One block's share on the 16-byte path: whole periods of n0 examples, an
// equal share of the batch's (the last period may be ragged at b), walked
// in groups of tb examples.
struct Share {
  long long e0, e1;  // the block's examples
  int tb, ng;        // examples a group, and the block's groups
  __device__ Share(long long b, int n0, int tb_) : tb(tb_) {
    const long long periods = (b + n0 - 1) / n0;
    e0 = (long long)blockIdx.x * periods / gridDim.x * n0;
    e1 = min(((long long)blockIdx.x + 1) * periods / gridDim.x * n0, b);
    ng = (int)((e1 - e0 + tb - 1) / tb);
  }
  __device__ long long first(int g) const { return e0 + (long long)g * tb; }
  __device__ int count(int g) const { return (int)min((long long)tb, e1 - first(g)); }
};

// Copy `elems` elements at src (16-byte aligned) to the buffer dst by
// 16-byte cp.async; the last chunk may be short and is zero-filled.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int elems) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = (elems + kVec - 1) / kVec;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int left = elems - c * kVec;
    if (left >= kVec)
      rm::cp_async16(dst + c * kVec, src + c * kVec);
    else
      rm::cp_async16_zfill(dst + c * kVec, src + c * kVec, left * (int)sizeof(T));
  }
}

// Store chunk c of a group's output: whole, or its first `left` elements.
template <typename T>
__device__ __forceinline__ void put(T* dst, int c, int left, const Chunk<T>& v) {
  constexpr int kVec = 16 / sizeof(T);
  if (left >= kVec) {
    reinterpret_cast<uint4*>(dst)[c] = v.u;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)  // constant j keeps v in registers
      if (j < left) dst[c * kVec + j] = v.e[j];
  }
}

// This thread's walk over a group's output chunks: chunk c = threadIdx.x +
// k * kThreads lies in period p at chunk q of the table, stepped without
// division.
struct Walk {
  int p, q, p_step, q_step, cpp;
  __device__ explicit Walk(int chunks_per_period) : cpp(chunks_per_period) {
    p = threadIdx.x / cpp;
    q = threadIdx.x - p * cpp;
    p_step = kThreads / cpp;
    q_step = kThreads - p_step * cpp;
  }
  __device__ void next() {
    p += p_step;
    q += q_step;
    if (q >= cpp) {
      q -= cpp;
      ++p;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_fused_rows_kernel(const T* __restrict__ full, T* __restrict__ x_dm,
                            float* __restrict__ wide_sum, long long b, int m, int d, int n0, int tb,
                            int vec) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ uint4 smem_raw[];
  const int d1 = d + 1, per_in = m * d1, per_out = d * m;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (!vec) {  // the plain path: one group, element by element
    T* s = reinterpret_cast<T*>(smem_raw);
    const long long first = (long long)blockIdx.x * tb;
    const int n = (int)min((long long)tb, b - first);
    const T* src = full + first * per_in;
    for (int k = threadIdx.x; k < n * per_in; k += kThreads) s[k] = src[k];
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      T* dst = x_dm + (first + e) * per_out;
      for (int c = warp; c <= d; c += kWarps) {
        if (c < d) {
          for (int i = lane; i < m; i += 32) dst[c * m + i] = s[e * per_in + i * d1 + c];
        } else {
          const float sum = column_sum(s, e * per_in + d, d1, m, lane);
          if (lane == 0) wide_sum[first + e] = sum;
        }
      }
    }
    return;
  }

  // the 16-byte path: [2][group] buffers, then the table of a period
  const int group = tb * per_in;
  T* buf = reinterpret_cast<T*>(smem_raw);
  uint16_t* tab = reinterpret_cast<uint16_t*>(buf + 2 * group);
  const Share sh(b, n0, tb);
  auto issue = [&](int g, int slot) {
    if (g < sh.ng) {
      stage(buf + slot * group, full + sh.first(g) * per_in, sh.count(g) * per_in);
    }
    rm::cp_async_commit();
  };
  issue(0, 0);
  for (int row = threadIdx.x; row < n0 * d; row += kThreads) {  // x_dm[e, c, i] = full[e, i, c]
    const int e = row / d, c = row - e * d;
    for (int i = 0; i < m; ++i) tab[row * m + i] = (uint16_t)(e * per_in + i * d1 + c);
  }
  const Offsets<T>* offs = reinterpret_cast<const Offsets<T>*>(tab);
  const int period_in = n0 * per_in;
  const Walk walk0(n0 * per_out / kVec);
  int slot = 0;
  for (int g = 0; g < sh.ng; ++g, slot ^= 1) {
    issue(g + 1, slot ^ 1);
    rm::cp_async_wait<1>();
    __syncthreads();  // group g has landed in `slot` (and the table is built)
    const long long first = sh.first(g);
    const int n = sh.count(g);
    const T* s = buf + slot * group;
    for (int e = warp; e < n; e += kWarps) {
      const float sum = column_sum(s, e * per_in + d, d1, m, lane);
      if (lane == 0) wide_sum[first + e] = sum;
    }
    const int elems = n * per_out;
    T* dst = x_dm + first * per_out;
    Walk w = walk0;
    for (int c = threadIdx.x; c * kVec < elems; c += kThreads, w.next()) {
      const Offsets<T> off = offs[w.q];
      const int base = w.p * period_in;
      Chunk<T> v;
#pragma unroll
      for (int j = 0; j < kVec; ++j) v.e[j] = s[base + off.h[j]];
      put(dst, c, elems - c * kVec, v);
    }
    __syncthreads();  // every thread is done with `slot` before it is refilled
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_fused_rows_bwd_kernel(const T* __restrict__ g_dm, const float* __restrict__ g_ws,
                                T* __restrict__ out, long long b, int m, int d, int n0, int tb,
                                int vec) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ uint4 smem_raw[];
  const int d1 = d + 1, per_in = d * m, per_out = m * d1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (!vec) {  // the plain path: one group, element by element
    T* s = reinterpret_cast<T*>(smem_raw);
    const long long first = (long long)blockIdx.x * tb;
    const int n = (int)min((long long)tb, b - first);
    const T* src = g_dm + first * per_in;
    for (int k = threadIdx.x; k < n * per_in; k += kThreads) s[k] = src[k];
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      const T wide = from_f32<T>(g_ws[first + e]);
      T* dst = out + (first + e) * per_out;
      for (int i = warp; i < m; i += kWarps)
        for (int c = lane; c < d1; c += 32) dst[i * d1 + c] = c < d ? s[e * per_in + c * m + i] : wide;
    }
    return;
  }

  // the 16-byte path: [2][group] buffers, the table of a period, then
  // [2][tb] of g_ws cast to T. Thread e loads example e's g_ws when its
  // group's copy is issued and stores it, cast, once the group before is
  // assembled, so no thread waits on the load.
  const int group = tb * per_in;
  T* buf = reinterpret_cast<T*>(smem_raw);
  uint16_t* tab = reinterpret_cast<uint16_t*>(buf + 2 * group);
  T* wide = reinterpret_cast<T*>(tab + (n0 * per_out + 7) / 8 * 8);
  const Share sh(b, n0, tb);
  auto issue = [&](int g, int slot) {
    float w = 0.f;
    if (g < sh.ng) {
      const long long first = sh.first(g);
      stage(buf + slot * group, g_dm + first * per_in, sh.count(g) * per_in);
      if (threadIdx.x < sh.count(g)) w = g_ws[first + threadIdx.x];
    }
    rm::cp_async_commit();
    return w;
  };
  float next_ws = issue(0, 0);
  for (int row = threadIdx.x; row < n0 * m; row += kThreads) {  // out[e, i, c] = g_dm[e, c, i]
    const int e = row / m, i = row - e * m;
    for (int c = 0; c < d; ++c) tab[row * d1 + c] = (uint16_t)(e * per_in + c * m + i);
    tab[row * d1 + d] = (uint16_t)(kWide | e);  // ... and g_ws[e] at c = d
  }
  if (threadIdx.x < sh.count(0)) wide[threadIdx.x] = from_f32<T>(next_ws);
  const Offsets<T>* offs = reinterpret_cast<const Offsets<T>*>(tab);
  const int period_in = n0 * per_in;
  const Walk walk0(n0 * per_out / kVec);
  int slot = 0;
  for (int g = 0; g < sh.ng; ++g, slot ^= 1) {
    next_ws = issue(g + 1, slot ^ 1);
    rm::cp_async_wait<1>();
    __syncthreads();  // group g has landed in `slot` (and the table is built)
    const long long first = sh.first(g);
    const T* s = buf + slot * group;
    const T* ws = wide + slot * tb;
    const int elems = sh.count(g) * per_out;
    T* dst = out + first * per_out;
    Walk w = walk0;
    for (int c = threadIdx.x; c * kVec < elems; c += kThreads, w.next()) {
      const Offsets<T> off = offs[w.q];
      const int base = w.p * period_in, e_base = w.p * n0;
      Chunk<T> v;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int h = off.h[j];
        v.e[j] = *(h & kWide ? ws + e_base + (h & ~kWide) : s + base + h);
      }
      put(dst, c, elems - c * kVec, v);
    }
    if (g + 1 < sh.ng && threadIdx.x < sh.count(g + 1)) wide[(slot ^ 1) * tb + threadIdx.x] = from_f32<T>(next_ws);
    __syncthreads();  // every thread is done with `slot` before it is refilled
  }
}

// least count of whole examples of `bytes` that spans whole 16-byte chunks
int whole_chunks(long long bytes) {
  int n = 1;
  while ((n * bytes) % 16) n *= 2;
  return n;
}

// How a call runs: the period n0, the group tb (examples), the path, the
// grid and the dynamic shared memory.
struct Plan {
  int n0 = 1, tb = 1, vec = 0;
  long long blocks = 0, smem = 0;
};

// per_in, per_out: elements an example in and out; ws: whether the 16-byte
// path keeps the group's cast g_ws in shared memory (the backward).
template <typename T>
cudaError_t plan(int device, long long b, int m, int d, bool aligned, int per_in, int per_out,
                 bool ws, Plan* p) {
  const long long size = sizeof(T);
  const long long rows_bytes = (long long)m * (d + 1) * size;  // the larger side of an example
  if (m < 0 || d < 0 || rows_bytes > kMaxExampleBytes) return cudaErrorInvalidValue;
  p->n0 = whole_chunks(per_in * size);
  const int n0_out = whole_chunks(per_out * size);
  p->n0 = p->n0 > n0_out ? p->n0 : n0_out;
  p->vec = aligned && m >= 1 && d >= 1 && p->n0 * rows_bytes <= kGroupBytes;
  if (!p->vec) {
    p->tb = rows_bytes == 0 || rows_bytes >= kPlainBytes ? 1 : (int)(kPlainBytes / rows_bytes);
    p->blocks = (b + p->tb - 1) / p->tb;
    p->smem = (p->tb * per_in * size + 15) / 16 * 16;
    return cudaSuccess;
  }
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)sms * kBlocksPerSm;
  const long long periods = (b + p->n0 - 1) / p->n0;
  long long per_group = kGroupBytes / (p->n0 * rows_bytes);
  if (per_group > kThreads / p->n0) per_group = kThreads / p->n0;  // a thread an example's g_ws
  // a batch of fewer groups than resident blocks is cut into smaller ones
  const long long spread = (periods + resident - 1) / resident;
  if (spread < per_group) per_group = spread;
  p->tb = p->n0 * (int)per_group;
  const long long groups = (periods + per_group - 1) / per_group;
  p->blocks = groups < resident ? groups : resident;
  const long long table = (long long)(p->n0 * per_out + 7) / 8 * 8 * 2;
  p->smem = 2 * p->tb * per_in * size + table + (ws ? 2 * p->tb * size : 0);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(int device, const void* full, void* x_dm, void* wide_sum, long long b, int m,
                   int d, cudaStream_t st) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(full) | reinterpret_cast<uintptr_t>(x_dm)) & 15) == 0;
  Plan p;
  cudaError_t err = plan<T>(device, b, m, d, aligned, m * (d + 1), d * m, false, &p);
  if (err != cudaSuccess) return err;
  if (p.blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(split_fused_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.smem);
  if (err != cudaSuccess) return err;
  split_fused_rows_kernel<T><<<(unsigned)p.blocks, kThreads, (size_t)p.smem, st>>>(
      (const T*)full, (T*)x_dm, (float*)wide_sum, b, m, d, p.n0, p.tb, p.vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(int device, const void* g_dm, const void* g_ws, void* out, long long b, int m,
                       int d, cudaStream_t st) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(g_dm) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  Plan p;
  cudaError_t err = plan<T>(device, b, m, d, aligned, d * m, m * (d + 1), true, &p);
  if (err != cudaSuccess) return err;
  if (p.blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(split_fused_rows_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  split_fused_rows_bwd_kernel<T><<<(unsigned)p.blocks, kThreads, (size_t)p.smem, st>>>(
      (const T*)g_dm, (const float*)g_ws, (T*)out, b, m, d, p.n0, p.tb, p.vec);
  return cudaGetLastError();
}

}  // namespace

// full [b, m, d+1], x_dm [b, d, m] (bf16 when is_bf16, else f32), wide_sum [b] f32.
extern "C" int rm_split_fused_rows(int device, const void* full, void* x_dm, void* wide_sum, int b,
                                   int m, int d, int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch<uint16_t>(device, full, x_dm, wide_sum, b, m, d, s)
                       : launch<uint32_t>(device, full, x_dm, wide_sum, b, m, d, s));
}

// g_dm [b, d, m], out [b, m, d+1] (bf16 when is_bf16, else f32), g_ws [b] f32.
extern "C" int rm_split_fused_rows_backward(int device, const void* g_dm, const void* g_ws, void* out,
                                            int b, int m, int d, int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_bwd<uint16_t>(device, g_dm, g_ws, out, b, m, d, s)
                       : launch_bwd<uint32_t>(device, g_dm, g_ws, out, b, m, d, s));
}
