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
// Design: the TPU kernel transposes whole [tb, a, b] blocks in VMEM, and so
// does a block here. A group of tb whole consecutive items (as many as fit
// in 8 KB) has its input and its output each in one contiguous range. A
// block copies a group's input into shared memory with 16-byte cp.async,
// and each thread then assembles 16 bytes of output (8 bf16 or 4 f32
// elements) from their transposed positions and stores them with one
// 16-byte store. The blocks are persistent (four an SM), each takes an
// equal share of the items, and they double-buffer: the next group's copy
// is in flight while this one is assembled, so the card reads and writes at
// once. The positions within an item come from a
// table the block builds once (no division per element), and shared memory
// gets 16 bytes of padding after every 128, which spreads the strided reads
// of a column over the banks. At [16384, 26, 16] bf16 an item is 832 bytes:
// 9 items a group, 528 blocks of 31 or 32 items on 132 SMs.
//
// Items whose size is not a multiple of 16 bytes or past 8 KB, and
// unaligned bases, take the plain path of the same kernel: a block moves
// one group (up to 16 KB) element by element through shared memory. An
// item must fit in a block's shared memory: the wrapper refuses items past
// kMaxItemBytes (64 KB) with a ValueError, and so does this function. For
// the field matrix that is m slots x D up to 16,384 f32 elements (256 x 64);
// for the H-major CIN layer (interactions_cuda.cin_layer), which also
// transposes xk [B, Hk, D] and its output [B, D, Hn], it is Hk x D and
// Hn x D up to 16,384 f32 (32,768 bf16) elements.

#include "mma_sm90.cuh"

namespace {

constexpr int kThreadsT = 256;
constexpr int kBlocksPerSm = 4;
constexpr long long kGroupBytes = 8 * 1024;    // a group of the 16-byte path
constexpr long long kPlainBytes = 16 * 1024;   // a group of the plain path
constexpr long long kMaxItemBytes = 64 * 1024;  // interactions_cuda.TRANSPOSE_MAX_ITEM_BYTES

// shared-memory position of a group's element i on the 16-byte path: 16
// bytes of padding after every 128
template <typename T>
__device__ __forceinline__ int padded(int i) {
  constexpr int kVec = 16 / sizeof(T);
  return i + (i / (8 * kVec)) * kVec;
}

template <typename T>
__global__ void __launch_bounds__(kThreadsT)
    transpose_minor2_kernel(const T* __restrict__ x, T* __restrict__ out, long long batch, int a,
                            int b, int tb, int vec) {
  constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
  union Chunk {
    uint4 u;
    T e[kVec];
  };
  struct alignas(2 * kVec) Offsets {  // a chunk's input positions within its item
    uint16_t h[kVec];
  };
  extern __shared__ uint4 smem_raw[];
  const int ab = a * b;

  if (!vec) {  // the plain path: one group, element by element
    T* s = reinterpret_cast<T*>(smem_raw);
    const long long item0 = (long long)blockIdx.x * tb;
    const int n = (int)min((long long)tb, batch - item0) * ab;
    const T* src = x + item0 * ab;
    T* dst = out + item0 * ab;
    for (int e = threadIdx.x; e < n; e += kThreadsT) s[e] = src[e];
    __syncthreads();
    for (int o = threadIdx.x; o < n; o += kThreadsT) {
      const int item = o / ab, rem = o - item * ab;
      const int y = rem / a;  // out[item, y, z] = x[item, z, y]
      dst[o] = s[item * ab + (rem - y * a) * b + y];
    }
    return;
  }

  // the 16-byte path: [2][group] padded buffers, then the table. Block b
  // takes the items [it0, it1), an equal share, in groups of tb.
  const int cpi = ab / kVec;  // 16-byte chunks an item
  const int gpad = padded<T>(tb * ab);
  T* buf = reinterpret_cast<T*>(smem_raw);
  uint16_t* tab = reinterpret_cast<uint16_t*>(buf + 2 * gpad);
  const long long it0 = (long long)blockIdx.x * batch / gridDim.x;
  const long long it1 = ((long long)blockIdx.x + 1) * batch / gridDim.x;
  const int ng = (int)((it1 - it0 + tb - 1) / tb);
  auto issue = [&](int g, int slot) {
    if (g < ng) {
      const long long i0 = it0 + (long long)g * tb;
      const int chunks = (int)min((long long)tb, it1 - i0) * cpi;
      const uint4* src = reinterpret_cast<const uint4*>(x + i0 * ab);
      T* dst = buf + slot * gpad;
      for (int c = threadIdx.x; c < chunks; c += kThreadsT)
        rm::cp_async16(dst + padded<T>(c * kVec), src + c);
    }
    rm::cp_async_commit();
  };
  issue(0, 0);
  for (int o = threadIdx.x; o < ab; o += kThreadsT) {
    const int y = o / a;
    tab[o] = (uint16_t)((o - y * a) * b + y);
  }
  // this thread's first chunk of a group, and the step between its chunks
  const int item_step = kThreadsT / cpi, q_step = kThreadsT - item_step * cpi;
  const int item_first = threadIdx.x / cpi, q_first = threadIdx.x - item_first * cpi;
  int slot = 0;
  for (int g = 0; g < ng; ++g, slot ^= 1) {
    issue(g + 1, slot ^ 1);
    rm::cp_async_wait<1>();
    __syncthreads();  // group g has landed in `slot` (and the table is built)
    const long long i0 = it0 + (long long)g * tb;
    const int chunks = (int)min((long long)tb, it1 - i0) * cpi;
    const T* s = buf + slot * gpad;
    uint4* dst = reinterpret_cast<uint4*>(out + i0 * ab);
    int item = item_first, q = q_first;
    for (int c = threadIdx.x; c < chunks; c += kThreadsT) {
      const Offsets off = reinterpret_cast<const Offsets*>(tab)[q];
      const int base = item * ab;
      Chunk v;
#pragma unroll
      for (int j = 0; j < kVec; ++j) v.e[j] = s[padded<T>(base + off.h[j])];
      dst[c] = v.u;
      item += item_step;
      q += q_step;
      if (q >= cpi) {
        q -= cpi;
        ++item;
      }
    }
    __syncthreads();  // every thread is done with `slot` before it is refilled
  }
}

template <typename T>
cudaError_t launch(int device, const void* x, void* out, long long batch, int a, int b,
                   cudaStream_t st) {
  const long long item_bytes = (long long)a * b * (long long)sizeof(T);
  const bool vec = item_bytes % 16 == 0 && item_bytes <= kGroupBytes &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long share = vec ? kGroupBytes : kPlainBytes;
  const int tb = (int)(item_bytes >= share ? 1 : share / item_bytes);
  const long long groups = (batch + tb - 1) / tb;
  long long blocks = groups;
  long long smem = tb * item_bytes;
  if (vec) {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const long long resident = (long long)sms * kBlocksPerSm;
    blocks = groups < resident ? groups : resident;
    smem = 2 * (smem + smem / 128 * 16) + a * b * 2;  // two padded buffers and the table
  }
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  smem = (smem + 15) / 16 * 16;
  cudaError_t err = cudaFuncSetAttribute(transpose_minor2_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  transpose_minor2_kernel<T><<<(unsigned)blocks, kThreadsT, (size_t)smem, st>>>(
      (const T*)x, (T*)out, batch, a, b, tb, (int)vec);
  return cudaGetLastError();
}

}  // namespace

// x [batch, a, b] -> out [batch, b, a], elements of elem_bytes (2 or 4);
// an [a, b] item of at most kMaxItemBytes.
extern "C" int rm_transpose_minor2(int device, const void* x, void* out, long long batch, int a,
                                   int b, int elem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a < 1 || b < 1 || batch < 0 || (long long)a * b * elem_bytes > kMaxItemBytes)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 2) return (int)launch<uint16_t>(device, x, out, batch, a, b, st);
  if (elem_bytes == 4) return (int)launch<uint32_t>(device, x, out, batch, a, b, st);
  return (int)cudaErrorInvalidValue;
}
