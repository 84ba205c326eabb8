// Yardsticks of the sparse table updates (csrc/sorted_update_common.cuh):
// the least work that reads and writes the touched rows of two or three f32
// state arrays, in the access patterns a kernel could give them. No
// arithmetic of an optimizer, no grads: what is left is the rows' own cost.
// Built and run by sparse_update_rows.py; the port never calls it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One thread per element of the unique rows: read, add 1, write.
__global__ void rmw_thread(float* a, float* b, float* c, const int* rows, long long u, int d) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= u * d) return;
  const long long r = t / d;
  const long long e = (long long)rows[r] * d + (t - r * d);
  const float x = a[e], y = b[e];
  if (c) c[e] = c[e] + 1.f;
  a[e] = x + 1.f;
  b[e] = y + 1.f;
}

// The same, four columns a thread (float4; d % 4 == 0).
__global__ void rmw_thread4(float4* a, float4* b, float4* c, const int* rows, long long u, int d4) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= u * d4) return;
  const long long r = t / d4;
  const long long e = (long long)rows[r] * d4 + (t - r * d4);
  float4 x = a[e], y = b[e];
  if (c) {
    float4 z = c[e];
    z.x += 1.f;
    c[e] = z;
  }
  x.x += 1.f;
  y.x += 1.f;
  a[e] = x;
  b[e] = y;
}

__global__ void read_thread(const float* a, const float* b, const float* c, const int* rows,
                            long long u, int d, float* sink) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= u * d) return;
  const long long r = t / d;
  const long long e = (long long)rows[r] * d + (t - r * d);
  const float s = a[e] + b[e] + (c ? c[e] : 0.f);
  if (s == 12345.678f) sink[0] = s;  // never true for the probe's data; keeps the loads
}

__global__ void write_thread(float* a, float* b, float* c, const int* rows, long long u, int d) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= u * d) return;
  const long long r = t / d;
  const long long e = (long long)rows[r] * d + (t - r * d);
  a[e] = 1.f;
  b[e] = 2.f;
  if (c) c[e] = 3.f;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// A warp per 32 unique rows (two arrays, d <= 17), lane e = lane + 32 j over
// the 32 * d elements: MODE 1 reads, adds and writes one element at a time;
// MODE 2 reads K elements into registers, then writes them; MODE 3 copies
// every element into shared memory by 4-byte cp.async, then writes.
template <int MODE, int K>
__global__ void rmw_warp(float* a, float* b, const int* rows, long long u, int d) {
  __shared__ float sh[8][2][32 * 17];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long tile = blockIdx.x * 8LL + w;
  if (tile * 32 >= u) return;
  const int nr = u - tile * 32 < 32 ? (int)(u - tile * 32) : 32;
  const int total = nr * d;
  const int* my = rows + tile * 32;
  if (MODE == 1) {
    for (int e = lane; e < total; e += 32) {
      const int r = e / d;
      const long long o = (long long)my[r] * d + (e - r * d);
      const float x = a[o], y = b[o];
      a[o] = x + 1.f;
      b[o] = y + 1.f;
    }
  } else if (MODE == 2) {
    for (int e0 = 0; e0 < total; e0 += 32 * K) {
      float x[K], y[K];
      long long o[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = e0 + 32 * k + lane;
        const int r = e / d;
        o[k] = e < total ? (long long)my[r] * d + (e - r * d) : 0;
        if (e < total) x[k] = a[o[k]], y[k] = b[o[k]];
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (e0 + 32 * k + lane < total) a[o[k]] = x[k] + 1.f, b[o[k]] = y[k] + 1.f;
    }
  } else {
    float* s0 = sh[w][0];
    float* s1 = sh[w][1];
    for (int e = lane; e < total; e += 32) {
      const int r = e / d;
      const long long o = (long long)my[r] * d + (e - r * d);
      cp_async4(s0 + e, a + o);
      cp_async4(s1 + e, b + o);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    for (int e = lane; e < total; e += 32) {
      const int r = e / d;
      const long long o = (long long)my[r] * d + (e - r * d);
      a[o] = s0[e] + 1.f;
      b[o] = s1[e] + 1.f;
    }
  }
}

}  // namespace

// pattern: 0 rmw a thread an element, 1 the same by float4, 2 read only,
// 3 write only, 4 a warp's rows in rounds, 5 and 6 a warp holding 17 and 8
// elements a lane, 7 a warp staging by 4-byte cp.async. c may be null (two
// arrays); patterns 4-7 take two arrays and d <= 17.
extern "C" int rm_probe_rows(int pattern, void* a, void* b, void* c, const void* rows, long long u,
                             int d, void* sink, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* ids = (const int*)rows;
  const long long elems = u * (pattern == 1 ? d / 4 : d);
  const unsigned blocks = (unsigned)((elems + 255) / 256);
  const unsigned warp_blocks = (unsigned)(((u + 31) / 32 + 7) / 8);
  switch (pattern) {
    case 0: rmw_thread<<<blocks, 256, 0, s>>>((float*)a, (float*)b, (float*)c, ids, u, d); break;
    case 1: rmw_thread4<<<blocks, 256, 0, s>>>((float4*)a, (float4*)b, (float4*)c, ids, u, d / 4); break;
    case 2: read_thread<<<blocks, 256, 0, s>>>((float*)a, (float*)b, (float*)c, ids, u, d, (float*)sink); break;
    case 3: write_thread<<<blocks, 256, 0, s>>>((float*)a, (float*)b, (float*)c, ids, u, d); break;
    case 4: rmw_warp<1, 1><<<warp_blocks, 256, 0, s>>>((float*)a, (float*)b, ids, u, d); break;
    case 5: rmw_warp<2, 17><<<warp_blocks, 256, 0, s>>>((float*)a, (float*)b, ids, u, d); break;
    case 6: rmw_warp<2, 8><<<warp_blocks, 256, 0, s>>>((float*)a, (float*)b, ids, u, d); break;
    case 7: rmw_warp<3, 1><<<warp_blocks, 256, 0, s>>>((float*)a, (float*)b, ids, u, d); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
