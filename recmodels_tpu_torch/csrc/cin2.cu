// Fused 2-layer CIN forward (xDeepFM), in the pair-pool (Q) form.
//
// Replaces: recmodels_tpu/ops/pallas/interactions_tpu.py::_cin2_fwd_call.
// On rows r = (b, d) of the D-major field matrix x0 [B*D, m] (bf16):
//   x1[r, n]     = bf16( sum_{h,i} bf16(x0[r,h] * x0[r,i]) * w1[h, i*h1 + n] )
//   p1[b, n]     = bf16( sum_d x1[(b,d), n] )
//   Q[b, (j,k)]  = bf16( sum_d x0[(b,d), j] * x1[(b,d), k] )
//   p2[b, n]     = bf16( sum_{(j,k)} Q[b,(j,k)] * w2[k, j*h2 + n] )
// with every sum accumulated in f32. The pair product is rounded to bf16
// before the w1 product, as the TPU kernel does (its e1 * e2 is a bf16
// product); Q's products are exact f32 products of bf16 values. x1 and Q are
// written only when the caller passes their pointers (training saves them).
//
// Bound on this card: operations. At the serving shape (B = 16,384, D = 16,
// m = 26, h1 = h2 = 128) the three products are 22.7 + 0.9 + 7.0 GMAC, about
// 61 GFLOP, against 31 MB of input and 8 MB of pools.
//
// Design: a block of 16 warps takes 16 whole examples, so the example pools
// stay inside the block and nothing crosses blocks: unlike the TPU grid,
// Hopper blocks run in no order, so the TPU kernel's build of W2R in scratch
// at program 0 cannot carry over. Instead w2 is read in place: for a 16-row
// slice of W2R, W2R[(j, k0..k0+15), n] = w2[k0.., j*h2 + n] is a row-major
// 16 x 16 block of w2 with leading dimension m*h2. Weights do not fit in
// shared memory (w2 alone is 852 KB) and come through L2, where both stay
// resident; each weight fragment a block loads serves its 16 examples.
// Each example owns 16 row slots (its D rows, then zero rows), so warp w
// owns example w in every phase. All three products run on the tensor cores
// through WMMA (bf16 in, f32 accumulate):
//   L1  [256 slots, m*m] x [m*m, h1]: pairs built in shared memory 32 columns
//       at a time beside the matching w1 rows; the next w1 rows are loaded
//       into registers while the current ones multiply;
//   Q   per example x0^T [m, 16] x x1 [16, h1];
//   p2  [16, m*h1] x [m*h1, h2], Q as the A operand in shared memory and w2
//       fragments loaded one step ahead from L2.
// Examples past the batch's end are zero rows whose results are not stored,
// so any B works.
//
// Limits, checked here and by the wrapper: D <= 16, m <= 32, h1 and h2
// multiples of 16 and at most 128, and the shared-memory layout below within
// 227 KB (m <= 28 at h1 = h2 = 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kExamples = 16;  // examples per block: the M of the p2 product
constexpr int kWarps = 16;     // one warp per example
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = 16;  // row slots per example (D <= 16)
constexpr int kRows = kExamples * kSlots;
constexpr int kPairChunk = 32;  // pair columns per L1 step
constexpr int kMaxTiles = 8;    // h / 16 for h <= 128
constexpr int kMaxFields = 32;  // m <= 32: two 16-row tiles of Q
constexpr size_t kMaxSmem = 232448;
// Rows of the shared tiles that WMMA reads are padded by 8 bf16 (16 bytes):
// unpadded, their strides are multiples of 128 bytes, every row of a
// fragment falls in the same banks and the fragment loads serialise. The
// padding changes no result.
constexpr int kPad = 8;
constexpr int kLdPairs = kPairChunk + kPad;
static_assert(kExamples == kWarps, "warp w owns example w");
static_assert(kPairChunk * kMaxTiles * 2 <= kThreads, "one w1 vector per thread per step");

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~(size_t)127;
}

__host__ __device__ inline int ld_x0(int m) { return (m + 15) / 16 * 16; }

struct Layout {
  size_t x0, pairs, w1c, x1, q, total;
};

// Shared memory: x0 tile | scratch (pairs + w1 chunk during L1; then the
// per-warp f32 staging tiles; then the two p2 partial sums) | x1 tile | Q.
__host__ __device__ inline Layout layout(int m, int h1, int h2) {
  const size_t pairs = align128((size_t)kRows * kLdPairs * sizeof(bf16));
  const size_t l1 = pairs + align128((size_t)kPairChunk * (h1 + kPad) * sizeof(bf16));
  const size_t stage = (size_t)kWarps * 256 * sizeof(float);
  const size_t part = 2 * (size_t)kExamples * h2 * sizeof(float);
  size_t scratch = l1 > stage ? l1 : stage;
  scratch = scratch > part ? scratch : part;
  Layout L;
  L.x0 = 0;
  L.pairs = align128((size_t)kRows * ld_x0(m) * sizeof(bf16));
  L.w1c = L.pairs + pairs;
  L.x1 = L.pairs + align128(scratch);
  L.q = L.x1 + align128((size_t)kRows * (h1 + kPad) * sizeof(bf16));
  L.total = L.q + align128((size_t)kExamples * (m * h1 + kPad) * sizeof(bf16));
  return L;
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__global__ void __launch_bounds__(kThreads, 1)
    cin2_forward_kernel(const bf16* __restrict__ x0g,
                        const bf16* __restrict__ w1,
                        const bf16* __restrict__ w2, bf16* __restrict__ x1g,
                        bf16* __restrict__ p1g, bf16* __restrict__ p2g,
                        bf16* __restrict__ qg, int b, int d, int m, int h1,
                        int h2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(m, h1, h2);
  bf16* x0s = reinterpret_cast<bf16*>(smem + L.x0);
  bf16* pairs = reinterpret_cast<bf16*>(smem + L.pairs);
  bf16* w1c = reinterpret_cast<bf16*>(smem + L.w1c);
  float* scratch = reinterpret_cast<float*>(smem + L.pairs);
  bf16* x1s = reinterpret_cast<bf16*>(smem + L.x1);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long b0 = (long long)blockIdx.x * kExamples;
  const int nb = (int)min((long long)kExamples, b - b0);  // examples stored
  const int mm = m * m;
  const int mh1 = m * h1;
  const int ldx = ld_x0(m);  // x0 row stride: m rounded up to 16, zero-filled
  const int ldw = h1 + kPad;
  const int ld1 = h1 + kPad;
  const int ldq = mh1 + kPad;
  const int nt1 = h1 / 16;
  const int nt2 = h2 / 16;
  float* stage = scratch + warp * 256;  // this warp's f32 16 x 16 tile

  // x0 tile: slot (e, r) holds row (b0 + e, r) for r < d; the rest are zero
  const bf16* x0b = x0g + b0 * d * m;
  for (int k = tid; k < kRows * ldx; k += kThreads) {
    const int slot = k / ldx;
    const int c = k - slot * ldx;
    const int e = slot / kSlots;
    const int r = slot - e * kSlots;
    x0s[k] = (e < nb && r < d && c < m) ? x0b[(e * d + r) * m + c] : __float2bfloat16_rn(0.f);
  }

  // ---- layer 1: x1 = pairs @ w1 (as [m*m, h1]); warp w owns example w
  FragC acc[kMaxTiles];
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) wmma::fill_fragment(acc[t], 0.f);
  const int vec = h1 / 8;  // 16-byte vectors per w1 row
  const bool w1_loader = tid < kPairChunk * vec;
  const int w1_row = tid / vec;
  const int w1_col = (tid - w1_row * vec) * 8;
  auto load_w1 = [&](int p0) {
    const int p = p0 + w1_row;
    return (w1_loader && p < mm)
               ? *reinterpret_cast<const uint4*>(w1 + (size_t)p * h1 + w1_col)
               : make_uint4(0, 0, 0, 0);
  };
  const int pc = tid % kPairChunk;  // this thread's pair column in each step
  uint4 w1_next = load_w1(0);
  __syncthreads();
  for (int p0 = 0; p0 < mm; p0 += kPairChunk) {
    const int p = p0 + pc;
    const int h = p < mm ? p / m : 0;
    const int i = p < mm ? p - h * m : 0;
    for (int r = tid / kPairChunk; r < kRows; r += kThreads / kPairChunk) {
      const float v = p < mm ? __bfloat162float(x0s[r * ldx + h]) *
                                   __bfloat162float(x0s[r * ldx + i])
                             : 0.f;
      pairs[r * kLdPairs + pc] = __float2bfloat16_rn(v);
    }
    if (w1_loader) *reinterpret_cast<uint4*>(w1c + w1_row * ldw + w1_col) = w1_next;
    __syncthreads();
    w1_next = load_w1(p0 + kPairChunk);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < kPairChunk / 16; ++ks) {
      FragA a;
      wmma::load_matrix_sync(a, pairs + warp * 16 * kLdPairs + ks * 16, kLdPairs);
#pragma unroll
      for (int t = 0; t < kMaxTiles; ++t) {
        if (t < nt1) {
          FragB bw;
          wmma::load_matrix_sync(bw, w1c + ks * 16 * ldw + t * 16, ldw);
          wmma::mma_sync(acc[t], a, bw, acc[t]);
        }
      }
    }
    __syncthreads();
  }
  // x1 = bf16(acc): this warp's 16 slot rows, through its staging tile
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    if (t < nt1) {
      wmma::store_matrix_sync(stage, acc[t], 16, wmma::mem_row_major);
      __syncwarp();
      for (int k = lane; k < 256; k += 32)
        x1s[(warp * 16 + (k >> 4)) * ld1 + t * 16 + (k & 15)] = __float2bfloat16_rn(stage[k]);
      __syncwarp();
    }
  }
  __syncwarp();

  // ---- per example (warp w = example w; its x1 rows are its own)
  const int e = warp;
  const bool stored = e < nb;
  if (stored) {
    for (int k = lane; k < d * h1; k += 32) {
      const int r = k / h1;
      const int n = k - r * h1;
      if (x1g != nullptr) x1g[((b0 + e) * d + r) * h1 + n] = x1s[(e * 16 + r) * ld1 + n];
    }
    for (int n = lane; n < h1; n += 32) {  // p1 = sum over d of x1
      float s = 0.f;
      for (int r = 0; r < d; ++r) s += __bfloat162float(x1s[(e * 16 + r) * ld1 + n]);
      p1g[(b0 + e) * h1 + n] = __float2bfloat16_rn(s);
    }
  }
  // Q_e = x0_e^T [ldx, 16] x x1_e [16, h1] over the 16 slots (zero slots add 0)
  {
    FragAT at[kMaxFields / 16];
#pragma unroll
    for (int jt = 0; jt < kMaxFields / 16; ++jt)
      if (jt * 16 < ldx) wmma::load_matrix_sync(at[jt], x0s + e * 16 * ldx + jt * 16, ldx);
    for (int t = 0; t < nt1; ++t) {
      FragB bx;
      wmma::load_matrix_sync(bx, x1s + e * 16 * ld1 + t * 16, ld1);
#pragma unroll
      for (int jt = 0; jt < kMaxFields / 16; ++jt) {
        if (jt * 16 < ldx) {
          FragC c;
          wmma::fill_fragment(c, 0.f);
          wmma::mma_sync(c, at[jt], bx, c);
          wmma::store_matrix_sync(stage, c, 16, wmma::mem_row_major);
          __syncwarp();
          for (int k = lane; k < 256; k += 32) {
            const int j = jt * 16 + (k >> 4);
            const int kk = t * 16 + (k & 15);
            if (j < m) {
              const bf16 v = __float2bfloat16_rn(stage[k]);
              qs[e * ldq + j * h1 + kk] = v;
              if (qg != nullptr && stored) qg[(b0 + e) * mh1 + j * h1 + kk] = v;
            }
          }
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();

  // ---- p2 = Q @ W2R; warp w takes n tile (w mod nt2) over one half of K
  const int kt2 = mh1 / 16;
  if (warp < 2 * nt2) {
    const int t = warp % nt2;
    const int half = warp / nt2;
    const int kb = half ? kt2 / 2 : 0;
    const int ke = half ? kt2 : kt2 / 2;
    auto w2_tile = [&](int kt) {
      const int kk = kt * 16;
      const int j = kk / h1;
      return w2 + (size_t)(kk - j * h1) * m * h2 + (size_t)j * h2 + t * 16;
    };
    FragC c;
    wmma::fill_fragment(c, 0.f);
    FragB b_next;
    if (kb < ke) wmma::load_matrix_sync(b_next, w2_tile(kb), m * h2);
    for (int kt = kb; kt < ke; ++kt) {
      const FragB bw = b_next;
      if (kt + 1 < ke) wmma::load_matrix_sync(b_next, w2_tile(kt + 1), m * h2);
      FragA a;
      wmma::load_matrix_sync(a, qs + kt * 16, ldq);
      wmma::mma_sync(c, a, bw, c);
    }
    wmma::store_matrix_sync(scratch + half * kExamples * h2 + t * 16, c, h2,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int k = tid; k < nb * h2; k += kThreads) {
    const int ex = k / h2;
    const int n = k - ex * h2;
    p2g[(b0 + ex) * h2 + n] =
        __float2bfloat16_rn(scratch[ex * h2 + n] + scratch[kExamples * h2 + ex * h2 + n]);
  }
}

}  // namespace

// x0 [b*d, m], w1 [m, m*h1], w2 [h1, m*h2], p1 [b, h1], p2 [b, h2], all bf16;
// x1 [b*d, h1] and q [b, m*h1] may be null. Pointers to w1 and w2 must be
// 32-byte aligned (WMMA and 16-byte vector loads read them in place).
extern "C" int rm_cin2_forward(int device, const void* x0, const void* w1,
                               const void* w2, void* x1, void* p1, void* p2,
                               void* q, int b, int d, int m, int h1, int h2,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > kSlots || m < 1 || m > kMaxFields || h1 % 16 || h2 % 16 ||
      h1 < 16 || h2 < 16 || h1 > 16 * kMaxTiles || h2 > 16 * kMaxTiles)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(m, h1, h2);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  err = cudaFuncSetAttribute(cin2_forward_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (b + kExamples - 1) / kExamples;
  cin2_forward_kernel<<<blocks, kThreads, L.total, (cudaStream_t)stream>>>(
      (const bf16*)x0, (const bf16*)w1, (const bf16*)w2, (bf16*)x1, (bf16*)p1,
      (bf16*)p2, (bf16*)q, b, d, m, h1, h2);
  return (int)cudaGetLastError();
}
