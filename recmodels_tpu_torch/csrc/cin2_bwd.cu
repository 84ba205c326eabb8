// Fused 2-layer CIN backward (xDeepFM), in the pair-pool (Q) form.
//
// Replaces: recmodels_tpu/ops/pallas/interactions_tpu.py::_cin2_bwd_call.
// From the pool grads g1p [B, h1], g2p [B, h2] and the forward's saved x0
// [B*D, m], x1 [B*D, h1] and Q [B, m*h1] (all bf16), on rows r = (b, d):
//   t1p[b, (i,k)] = bf16( sum_n g2p[b,n] * w2[k, i*h2 + n] )
//   gx1[r, k]     = bf16( sum_i t1p[b,(i,k)] * x0[r,i] + g1p[b,k] )
//   gx0_a[r, i]   = sum_k bf16( t1p[b,(i,k)] * x1[r,k] )
//   gw2[k, i*h2+n] = sum_b g2p[b,n] * Q[b, i*h1 + k]
//   gp[r, (h,i)]  = bf16( sum_n gx1[r,n] * w1[h, i*h1 + n] )
//   gx0_b[r, j]   = sum_i bf16(gp[r,(j,i)] * x0[r,i]) + sum_h bf16(gp[r,(h,j)] * x0[r,h])
//   gw1[h, i*h1+n] = sum_r bf16(x0[r,h] * x0[r,i]) * gx1[r,n]
//   gx0 = bf16(gx0_a + gx0_b); gw1, gw2 rounded to bf16 (the weights' type)
// with every sum accumulated in f32: the TPU kernel's rounding points.
//
// Bound on this card: operations. At the training shape (B = 16,384, D =
// 16, m = 26, h1 = h2 = 128) the products are 22.7 (gp) + 22.7 (gw1) + 7.0
// (t1p) + 7.0 (gw2) GMAC plus 2.1 G elementwise multiply-adds, about 61.5
// GMAC, against 82 MB of inputs and 8 MB of outputs.
//
// Design. The TPU kernel runs an in-order grid: it builds the transposed w2
// in scratch at step 0 and sums gw1 and gw2 in scratch across all steps.
// Hopper blocks run in no order and share nothing, so
//  * w2 and w1 are read in place: WMMA loads their 16 x 16 blocks as
//    column-major fragments straight from L2, where both stay resident;
//  * the weight grads are sums over every row, so they are not summed across
//    blocks with atomics (the order would change from run to run): each of
//    two GEMM kernels writes one f32 partial per slice of the batch, and a
//    third kernel sums the partials in slice order.
// Four launches on the caller's stream:
//  1. rows: a block of 16 warps takes 16 whole examples (warp w owns example
//     w, its D rows in 16 row slots, zero rows after them); per two fields it
//     forms t1p on the tensor cores (g2p [16, h2] x w2 block), then each warp
//     adds the fields' terms to gx1 in registers (f32) and forms gx0_a on the
//     CUDA cores; then gp = gx1 [16, h1] x w1^T on the tensor cores, 16 pairs
//     at a time from a w1 tile staged once per block (the next tile loads
//     while this one multiplies); the bf16 products gx0_b sums are formed
//     on the CUDA cores and summed into its two fields on the tensor cores,
//     against one-hot maps from pairs to fields (the TPU kernel's OA, OB).
//     Writes gx0 and gx1 (gx1 to scratch, for launch 3).
//  2. gw2 partials: block (field i, batch slice s) forms g2p^T Q[:, i] over
//     its slice of examples, stored in gw2's layout.
//  3. gw1 partials: block (64 pairs, row slice s) forms pairs^T gx1 over its
//     slice of rows, the pairs rebuilt from x0.
//  4. the partials of gw1 and gw2 summed in slice order and rounded.
// Shared-memory rows that the 16 lanes of a half-warp read at 16 different
// rows have strides that put them in 16 different banks; tiles and slabs
// load as 16-byte vectors in loops of fixed trip count, so that all of a
// thread's loads are in flight together.
//
// Limits, checked here and by the wrapper: D <= 16, 4 <= m <= 32 (m*m >= 16:
// the last pair tile is the one ending at m*m, overlapping the one before),
// h1 and h2 multiples of 16 and at most 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kExamples = 16;  // examples per rows block
constexpr int kWarps = 16;     // one warp per example
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = 16;  // row slots per example (D <= 16)
constexpr int kRows = kExamples * kSlots;
constexpr int kMaxTiles = 8;    // h / 16 for h <= 128
constexpr int kMaxFields = 32;  // m <= 32
constexpr int kChunkFields = 2;  // fields of t1p per step: 2 * 8 tiles = 16 warps
constexpr int kPad = 8;          // bf16 row padding of WMMA tiles (bank spread)
// Row strides of tiles that lane r reads at row r: the x0 tile (bf16) and the
// gx0 sums (f32) take odd word strides so that 16 rows fall in 16 banks; the
// f32 staging tiles take 20 (WMMA stores need a multiple of 4).
constexpr int kX0Ld = kMaxFields + 2;
constexpr int kAccLd = kMaxFields + 1;
constexpr int kStageLd = 20;
constexpr size_t kMaxSmem = 232448;

constexpr int kGemmThreads = 256;  // launches 2 and 3: 8 warps
constexpr int kEx2 = 1024;   // examples per gw2 slice
constexpr int kSub2 = 64;    // examples staged per step in launch 2
constexpr int kRows3 = 4096;  // rows per gw1 slice
constexpr int kSub3 = 64;     // rows staged per step in launch 3
constexpr int kPairs3 = 64;   // pairs per gw1 block
constexpr int kLdG = 128 + kPad;  // staged rows of h <= 128 bf16

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~(size_t)127;
}

constexpr int kPLd = 24;    // bf16 tiles of gx0_b's pair products
constexpr int kOneLd = 40;  // bf16 one-hot tiles [16 pairs][32 fields]
constexpr int kSumLd = 36;  // f32 [16][32] store of gx0_b (WMMA: multiple of 4)
// per warp: the f32 staging tile, then the two bf16 product tiles
constexpr int kWarpScratch = 16 * kStageLd * 4 + 2 * 16 * kPLd * 2;
static_assert(16 * kSumLd * 4 <= kWarpScratch, "gx0_b's store fits the warp's scratch");

struct Layout {
  size_t x0, x1, g2, t1, one, scratch, gx0a, total;
};

// Shared memory of launch 1: x0 tile | x1 tile (then gx1) | g2p | t1p chunk
// (then the staged w1 tile and the two one-hot tiles) | per-warp scratch
// (f32 staging tile and the two pair-product tiles) | gx0_a, f32
// [16][kAccLd] per warp.
__host__ __device__ inline Layout rows_layout(int h1, int h2) {
  Layout L;
  L.x0 = 0;
  L.x1 = L.x0 + align128((size_t)kRows * kX0Ld * sizeof(bf16));
  L.g2 = L.x1 + align128((size_t)kRows * (h1 + kPad) * sizeof(bf16));
  L.t1 = L.g2 + align128((size_t)kExamples * (h2 + kPad) * sizeof(bf16));
  const size_t t1 = (size_t)kExamples * (kChunkFields * h1 + kPad) * sizeof(bf16);
  const size_t w1 = align128((size_t)16 * (h1 + kPad) * sizeof(bf16)) +
                    2 * align128((size_t)16 * kOneLd * sizeof(bf16));
  L.one = L.t1 + align128((size_t)16 * (h1 + kPad) * sizeof(bf16));
  L.scratch = L.t1 + align128(t1 > w1 ? t1 : w1);
  L.gx0a = L.scratch + align128((size_t)kWarps * kWarpScratch);
  L.total = L.gx0a + align128((size_t)kWarps * kSlots * kAccLd * sizeof(float));
  return L;
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint4 load16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void store16(bf16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&t);
}
// eight f32 values rounded to bf16, as one 16-byte vector
__device__ __forceinline__ uint4 pack8(const float* v) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// ------------------------------------------------------------- launch 1
__global__ void __launch_bounds__(kThreads, 1)
    cin2_bwd_rows_kernel(const bf16* __restrict__ x0g, const bf16* __restrict__ x1g,
                         const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                         const bf16* __restrict__ g1p, const bf16* __restrict__ g2p,
                         bf16* __restrict__ gx0g, bf16* __restrict__ gx1g, int b,
                         int d, int m, int h1, int h2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = rows_layout(h1, h2);
  bf16* x0s = reinterpret_cast<bf16*>(smem + L.x0);
  bf16* x1s = reinterpret_cast<bf16*>(smem + L.x1);
  bf16* g2s = reinterpret_cast<bf16*>(smem + L.g2);
  bf16* t1s = reinterpret_cast<bf16*>(smem + L.t1);
  bf16* w1s = t1s;  // the layer-1 phase reuses the t1p chunk's space
  bf16* onea = reinterpret_cast<bf16*>(smem + L.one);  // OA[p, j] = 1[h(p) == j]
  bf16* oneb = onea + 16 * kOneLd;                    // OB[p, j] = 1[i(p) == j]
  float* gx0a_all = reinterpret_cast<float*>(smem + L.gx0a);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long b0 = (long long)blockIdx.x * kExamples;
  const int nb = (int)min((long long)kExamples, b - b0);
  const int mm = m * m;
  const int mh2 = m * h2;
  const int ld1 = h1 + kPad;
  const int ldg2 = h2 + kPad;
  const int ldt = kChunkFields * h1 + kPad;
  const int nt1 = h1 / 16;
  const int nt2 = h2 / 16;
  const int e = warp;  // this warp's example
  float* gx0a = gx0a_all + e * kSlots * kAccLd;
  unsigned char* scratch = smem + L.scratch + warp * kWarpScratch;
  float* stage = reinterpret_cast<float*>(scratch);
  bf16* prod1 = reinterpret_cast<bf16*>(scratch + 16 * kStageLd * 4);
  bf16* prod2 = prod1 + 16 * kPLd;

  // tiles: slot (e, r) holds row (b0 + e, r) for r < d, zero otherwise;
  // fixed trip counts so that every load of a thread is in flight at once
  const bf16 zero = __float2bfloat16_rn(0.f);
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int it = 0; it < kRows * kMaxFields / kThreads; ++it) {
    const int k = tid + it * kThreads;
    const int slot = k / kMaxFields;
    const int c = k % kMaxFields;
    const int ex = slot / kSlots;
    const int r = slot % kSlots;
    x0s[slot * kX0Ld + c] = (ex < nb && r < d && c < m) ? x0g[((b0 + ex) * d + r) * m + c] : zero;
  }
#pragma unroll
  for (int it = 0; it < kRows * (128 / 8) / kThreads; ++it) {  // 16-byte vectors of x1
    const int v = tid + it * kThreads;
    const int slot = v / 16;
    const int c = (v % 16) * 8;
    const int ex = slot / kSlots;
    const int r = slot % kSlots;
    if (c < h1)
      store16(x1s + slot * ld1 + c,
              (ex < nb && r < d) ? load16(x1g + ((b0 + ex) * d + r) * h1 + c) : zero4);
  }
  if (tid < kExamples * 16) {
    const int ex = tid / 16;
    const int c = (tid % 16) * 8;
    if (c < h2) store16(g2s + ex * ldg2 + c, ex < nb ? load16(g2p + (b0 + ex) * h2 + c) : zero4);
  }

  // ---- layer 2: two fields of t1p at a time, then their terms of gx1 and gx0_a
  // lane owns gx1 columns k = 4*lane .. 4*lane + 3 of all 16 slots
  const int kc = 4 * lane;
  const bool owns_k = kc < h1;
  float gx1acc[kSlots][4];
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) gx1acc[r][j] = 0.f;

  for (int i0 = 0; i0 < m; i0 += kChunkFields) {
    const int nf = min(kChunkFields, m - i0);
    __syncthreads();  // tiles loaded; the previous chunk's t1s reads are done
    if (warp < nf * nt1) {
      // t1p tile: examples x (field i0 + warp / nt1, k tile warp % nt1)
      const int fi = warp / nt1;
      const int kt = warp - fi * nt1;
      const bf16* wb = w2 + (size_t)(kt * 16) * mh2 + (size_t)(i0 + fi) * h2;
      FragC c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int ns = 0; ns < kMaxTiles; ++ns) {  // unrolled: the w2 loads from L2 overlap
        if (ns < nt2) {
          FragA a;
          wmma::load_matrix_sync(a, g2s + ns * 16, ldg2);
          FragBT bw;  // B(n, k) = w2[k, i*h2 + n]
          wmma::load_matrix_sync(bw, wb + ns * 16, mh2);
          wmma::mma_sync(c, a, bw, c);
        }
      }
      wmma::store_matrix_sync(stage, c, kStageLd, wmma::mem_row_major);
      __syncwarp();
      for (int k = lane; k < 256; k += 32)
        t1s[(k >> 4) * ldt + fi * h1 + kt * 16 + (k & 15)] =
            __float2bfloat16_rn(stage[(k >> 4) * kStageLd + (k & 15)]);
    }
    __syncthreads();
    const bf16* t1e = t1s + e * ldt;  // this example's t1p chunk
    for (int fi = 0; fi < nf; ++fi) {
      const int i = i0 + fi;
      if (owns_k) {
        float tv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) tv[j] = bf(t1e[fi * h1 + kc + j]);
#pragma unroll
        for (int r = 0; r < kSlots; ++r) {
          const float xv = bf(x0s[(e * kSlots + r) * kX0Ld + i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) gx1acc[r][j] = __fadd_rn(gx1acc[r][j], __fmul_rn(tv[j], xv));
        }
      }
    }
    {  // gx0_a[r, i] for the chunk's fields: lane = (row, field); the bf16
       // pair products round as bf16(a*b) does
      const int r = lane & 15;
      const int fi = lane >> 4;
      if (fi < nf) {
        const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x1s + (e * kSlots + r) * ld1);
        const __nv_bfloat162* tr = reinterpret_cast<const __nv_bfloat162*>(t1e + fi * h1);
        float s0 = 0.f, s1 = 0.f;  // even and odd k: two short chains
#pragma unroll 8
        for (int k = 0; k < h1 / 2; ++k) {
          const __nv_bfloat162 p = __hmul2(tr[k], xr[k]);
          s0 = __fadd_rn(s0, __low2float(p));
          s1 = __fadd_rn(s1, __high2float(p));
        }
        gx0a[r * kAccLd + i0 + fi] = __fadd_rn(s0, s1);
      }
    }
  }
  __syncwarp();  // this warp's reads of its x1 rows are done: gx1 replaces them

  // gx1 = bf16(sum + g1): into the x1 slots of this example, and to scratch
  if (owns_k) {
    float g1v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) g1v[j] = e < nb ? bf(g1p[(b0 + e) * h1 + kc + j]) : 0.f;
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      __align__(8) bf16 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __float2bfloat16_rn(__fadd_rn(gx1acc[r][j], g1v[j]));
      const uint2 v2 = *reinterpret_cast<const uint2*>(v);
      *reinterpret_cast<uint2*>(x1s + (e * kSlots + r) * ld1 + kc) = v2;
      if (e < nb && r < d) *reinterpret_cast<uint2*>(gx1g + ((b0 + e) * d + r) * h1 + kc) = v2;
    }
  }
  __syncwarp();

  // ---- layer 1: gp = gx1 x w1^T, 16 pairs at a time; fold into gx0_b.
  // Each 16-pair tile of w1 ([16, h1], contiguous) is staged once for all
  // warps, with the tile's one-hot maps from pairs to their fields h and i;
  // the next tile is loaded into registers while this one multiplies.
  // The fold: each lane rounds its 8 of the tile's gp values and multiplies
  // them by x0 at the pair's other field (the bf16 products gx0_b sums);
  // two products on the tensor cores against the one-hot maps then add
  // them into gx0_b's two sums, held in registers for the whole loop.
  FragA ga[kMaxTiles];
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t)
    if (t < nt1) wmma::load_matrix_sync(ga[t], x1s + e * kSlots * ld1 + t * 16, ld1);
  FragC b1[2], b2[2];  // gx0_b's sums over i (index h) and over h (index i), fields 0-15, 16-31
#pragma unroll
  for (int jt = 0; jt < 2; ++jt) {
    wmma::fill_fragment(b1[jt], 0.f);
    wmma::fill_fragment(b2[jt], 0.f);
  }
  const int fr = lane >> 1;         // the fold: this lane's row
  const int fc = (lane & 1) * 8;    // and its 8 columns of the tile
  const bf16* x0row = x0s + (e * kSlots + fr) * kX0Ld;
  const int nvec = 2 * h1;  // 16-byte vectors of a [16, h1] tile
  const int wrow = (tid * 8) / h1;
  const int wcol = (tid * 8) % h1;
  const int npt = (mm + 15) / 16;
  uint4 wnext = tid < nvec ? load16(w1 + tid * 8) : zero4;  // tile 0 starts at pair 0
  for (int pt = 0; pt < npt; ++pt) {
    const int p_lo = pt * 16;                 // first pair not yet folded
    const int p0 = min(p_lo, mm - 16);        // the last tile ends at mm
    __syncthreads();  // every warp is done with the previous tile
    if (tid < nvec) store16(w1s + wrow * ld1 + wcol, wnext);
    {  // one-hot maps of pairs p0 .. p0 + 15: thread = (pair, field)
      const int pp = p0 + tid / 32;
      const int j = tid % 32;
      const int h = pp / m;
      onea[(tid / 32) * kOneLd + j] = __float2bfloat16_rn(h == j ? 1.f : 0.f);
      oneb[(tid / 32) * kOneLd + j] = __float2bfloat16_rn(pp - h * m == j ? 1.f : 0.f);
    }
    __syncthreads();
    if (pt + 1 < npt && tid < nvec)
      wnext = load16(w1 + (size_t)min((pt + 1) * 16, mm - 16) * h1 + tid * 8);
    FragC c[2];  // even and odd n tiles: two short dependency chains
    wmma::fill_fragment(c[0], 0.f);
    wmma::fill_fragment(c[1], 0.f);
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (t < nt1) {
        FragBT bw;  // B(n, p) = w1 row p0 + p = (h, i), column n
        wmma::load_matrix_sync(bw, w1s + t * 16, ld1);
        wmma::mma_sync(c[t & 1], ga[t], bw, c[t & 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < c[0].num_elements; ++k) c[0].x[k] = __fadd_rn(c[0].x[k], c[1].x[k]);
    wmma::store_matrix_sync(stage, c[0], kStageLd, wmma::mem_row_major);
    __syncwarp();
    {
      int h = (p0 + fc) / m;
      int i = p0 + fc - h * m;
      float v1[8], v2[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float gp = round_bf(stage[fr * kStageLd + fc + k]);
        const bool live = p0 + fc + k >= p_lo;  // the last tile's overlap adds nothing
        v1[k] = live ? gp * bf(x0row[i]) : 0.f;
        v2[k] = live ? gp * bf(x0row[h]) : 0.f;
        if (++i == m) {
          i = 0;
          ++h;
        }
      }
      store16(prod1 + fr * kPLd + fc, pack8(v1));  // rounded to bf16 here
      store16(prod2 + fr * kPLd + fc, pack8(v2));
    }
    __syncwarp();
    FragA a1, a2;
    wmma::load_matrix_sync(a1, prod1, kPLd);
    wmma::load_matrix_sync(a2, prod2, kPLd);
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      FragB oa, ob;
      wmma::load_matrix_sync(oa, onea + jt * 16, kOneLd);
      wmma::load_matrix_sync(ob, oneb + jt * 16, kOneLd);
      wmma::mma_sync(b1[jt], a1, oa, b1[jt]);
      wmma::mma_sync(b2[jt], a2, ob, b2[jt]);
    }
  }
  // gx0 = bf16(gx0_a + (sum over i + sum over h)), through the warp's scratch
  float* sums = reinterpret_cast<float*>(scratch);
  __syncwarp();
#pragma unroll
  for (int jt = 0; jt < 2; ++jt) {
#pragma unroll
    for (int k = 0; k < b1[jt].num_elements; ++k) b1[jt].x[k] = __fadd_rn(b1[jt].x[k], b2[jt].x[k]);
    wmma::store_matrix_sync(sums + jt * 16, b1[jt], kSumLd, wmma::mem_row_major);
  }
  __syncwarp();
  if (e < nb) {
    for (int k = lane; k < d * m; k += 32) {
      const int rr = k / m;
      const int j = k - rr * m;
      const float v = __fadd_rn(gx0a[rr * kAccLd + j], sums[rr * kSumLd + j]);
      gx0g[((b0 + e) * d + rr) * m + j] = __float2bfloat16_rn(v);
    }
  }
}

// ------------------------------------------------------------- launch 2
// gw2 partial of batch slice s for field i: part[s][k, i*h2 + n] =
// sum_{b in slice} g2p[b, n] * Q[b, i*h1 + k]. Each step stages 64
// examples of g2p and of Q's field-i columns; the next step's are loaded
// into registers while this one multiplies.
__global__ void __launch_bounds__(kGemmThreads)
    cin2_bwd_gw2_kernel(const bf16* __restrict__ g2p, const bf16* __restrict__ q,
                        float* __restrict__ part, int b, int m, int h1, int h2) {
  __shared__ __align__(128) bf16 g2c[kSub2 * kLdG];
  __shared__ __align__(128) bf16 qc[kSub2 * kLdG];
  constexpr int kVec = kSub2 * 16 / kGemmThreads;  // 16-byte vectors per thread per array
  const int i = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int nt1 = h1 / 16;
  const int nt2 = h2 / 16;
  const int mh1 = m * h1;
  const int mh2 = m * h2;
  const long long e_begin = (long long)s * kEx2;
  const long long e_end = min((long long)b, e_begin + kEx2);
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  uint4 gv[kVec], qv[kVec];
  auto load = [&](long long e0) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int v = threadIdx.x + j * kGemmThreads;
      const int ex = v / 16;
      const int c = (v % 16) * 8;
      const bool in = e0 + ex < e_end;
      gv[j] = (in && c < h2) ? load16(g2p + (e0 + ex) * h2 + c) : zero4;
      qv[j] = (in && c < h1) ? load16(q + (e0 + ex) * mh1 + (size_t)i * h1 + c) : zero4;
    }
  };
  FragC acc[kMaxTiles];
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) wmma::fill_fragment(acc[t], 0.f);
  load(e_begin);
  for (long long e0 = e_begin; e0 < e_end; e0 += kSub2) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int v = threadIdx.x + j * kGemmThreads;
      store16(g2c + (v / 16) * kLdG + (v % 16) * 8, gv[j]);
      store16(qc + (v / 16) * kLdG + (v % 16) * 8, qv[j]);
    }
    __syncthreads();
    if (e0 + kSub2 < e_end) load(e0 + kSub2);
    if (warp < nt2) {
#pragma unroll
      for (int ks = 0; ks < kSub2 / 16; ++ks) {
        FragAT a;  // A(n, ex) = g2p[ex, n]
        wmma::load_matrix_sync(a, g2c + ks * 16 * kLdG + warp * 16, kLdG);
#pragma unroll
        for (int t = 0; t < kMaxTiles; ++t) {
          if (t < nt1) {
            FragB bq;  // B(ex, k) = Q[ex, i*h1 + k]
            wmma::load_matrix_sync(bq, qc + ks * 16 * kLdG + t * 16, kLdG);
            wmma::mma_sync(acc[t], a, bq, acc[t]);
          }
        }
      }
    }
  }
  if (warp < nt2) {
    float* out = part + (size_t)s * h1 * mh2 + (size_t)i * h2 + warp * 16;
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t)  // C(n, k) -> gw2[k, i*h2 + n]
      if (t < nt1) wmma::store_matrix_sync(out + (size_t)t * 16 * mh2, acc[t], mh2, wmma::mem_col_major);
  }
}

// ------------------------------------------------------------- launch 3
// gw1 partial of row slice s for pairs [64*pb, 64*pb + 64): part[s][p, n] =
// sum_{r in slice} bf16(x0[r,h] * x0[r,i]) * gx1[r, n], p = h*m + i. Warp w
// takes 16 pairs and 64 columns n. Each step stages 64 rows of gx1 and x0
// and builds their pairs; the next step's rows are loaded into registers
// while this one multiplies.
__global__ void __launch_bounds__(kGemmThreads)
    cin2_bwd_gw1_kernel(const bf16* __restrict__ x0, const bf16* __restrict__ gx1,
                        float* __restrict__ part, long long rows, int m, int h1,
                        int mpad) {
  __shared__ __align__(128) bf16 pairs[kSub3 * (kPairs3 + kPad)];
  __shared__ __align__(128) bf16 gc[kSub3 * kLdG];
  __shared__ bf16 xc[kSub3 * kMaxFields];
  constexpr int kVec = kSub3 * 16 / kGemmThreads;  // 16-byte gx1 vectors per thread
  constexpr int kX = kSub3 * kMaxFields / kGemmThreads;  // x0 values per thread
  const int pb = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int ldp = kPairs3 + kPad;
  const int nt1 = h1 / 16;
  const int mm = m * m;
  const int pt = warp & 3;        // this warp's 16 pairs of the block's 64
  const int nq = (warp >> 2) * 4;  // and its four n tiles from nq
  const long long r_begin = (long long)s * kRows3;
  const long long r_end = min(rows, r_begin + kRows3);
  const bf16 zero = __float2bfloat16_rn(0.f);
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  // this thread's pair column and its fields, fixed for the whole block
  const int pl = threadIdx.x % kPairs3;
  const int p = pb * kPairs3 + pl;
  const int ph = p < mm ? p / m : 0;
  const int pi = p < mm ? p % m : 0;

  uint4 gv[kVec];
  bf16 xv[kX];
  auto load = [&](long long r0) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int v = threadIdx.x + j * kGemmThreads;
      const int rr = v / 16;
      const int c = (v % 16) * 8;
      gv[j] = (r0 + rr < r_end && c < h1) ? load16(gx1 + (r0 + rr) * h1 + c) : zero4;
    }
    const long long n = (min(r_end, r0 + kSub3) - r0) * m;  // x0 values of the step
#pragma unroll
    for (int j = 0; j < kX; ++j) {
      const int k = threadIdx.x + j * kGemmThreads;
      xv[j] = k < n ? x0[r0 * m + k] : zero;
    }
  };
  FragC acc[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) wmma::fill_fragment(acc[t], 0.f);
  load(r_begin);
  for (long long r0 = r_begin; r0 < r_end; r0 += kSub3) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int v = threadIdx.x + j * kGemmThreads;
      store16(gc + (v / 16) * kLdG + (v % 16) * 8, gv[j]);
    }
#pragma unroll
    for (int j = 0; j < kX; ++j) xc[threadIdx.x + j * kGemmThreads] = xv[j];
    __syncthreads();
    if (r0 + kSub3 < r_end) load(r0 + kSub3);
    const long long n_rows = min(r_end - r0, (long long)kSub3);
    for (int rr = threadIdx.x / kPairs3; rr < kSub3; rr += kGemmThreads / kPairs3) {
      bf16 v = zero;
      if (rr < n_rows && p < mm)
        v = __float2bfloat16_rn(bf(xc[rr * m + ph]) * bf(xc[rr * m + pi]));
      pairs[rr * ldp + pl] = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kSub3 / 16; ++ks) {
      FragAT a;  // A(p, r) = pairs[r, p]
      wmma::load_matrix_sync(a, pairs + ks * 16 * ldp + pt * 16, ldp);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (nq + t < nt1) {
          FragB bg;  // B(r, n) = gx1[r, n]
          wmma::load_matrix_sync(bg, gc + ks * 16 * kLdG + (nq + t) * 16, kLdG);
          wmma::mma_sync(acc[t], a, bg, acc[t]);
        }
      }
    }
  }
  float* out = part + (size_t)s * mpad * h1 + (size_t)(pb * kPairs3 + pt * 16) * h1;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (nq + t < nt1) wmma::store_matrix_sync(out + (nq + t) * 16, acc[t], h1, wmma::mem_row_major);
}

// ------------------------------------------------------------- launch 4
// out[j] = bf16(sum over slices s, in order, of part[s * stride + j])
__global__ void cin2_bwd_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                                       long long n, long long stride, int slices) {
  const long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (j >= n) return;
  float v = 0.f;
  for (int s = 0; s < slices; ++s) v = __fadd_rn(v, part[s * stride + j]);
  out[j] = __float2bfloat16_rn(v);
}

struct Scratch {
  size_t gx1, part1, part2, total;
  int s1, s2, mpad;
};

Scratch scratch_layout(long long b, int d, int m, int h1, int h2) {
  Scratch S;
  const long long rows = b * d;
  S.s1 = (int)((rows + kRows3 - 1) / kRows3);
  S.s2 = (int)((b + kEx2 - 1) / kEx2);
  S.mpad = (m * m + kPairs3 - 1) / kPairs3 * kPairs3;
  S.gx1 = 0;
  S.part1 = align128((size_t)rows * h1 * sizeof(bf16));
  S.part2 = S.part1 + align128((size_t)S.s1 * S.mpad * h1 * sizeof(float));
  S.total = S.part2 + (size_t)S.s2 * h1 * m * h2 * sizeof(float);
  return S;
}

bool supported(int d, int m, int h1, int h2) {
  return d >= 1 && d <= kSlots && m >= 4 && m <= kMaxFields && h1 % 16 == 0 &&
         h2 % 16 == 0 && h1 >= 16 && h2 >= 16 && h1 <= 16 * kMaxTiles &&
         h2 <= 16 * kMaxTiles && rows_layout(h1, h2).total <= kMaxSmem;
}

}  // namespace

// Bytes of scratch rm_cin2_backward needs (gx1 and the weight-grad
// partials), or -1 for shapes the kernels do not take.
extern "C" long long rm_cin2_backward_scratch(int b, int d, int m, int h1, int h2) {
  if (!supported(d, m, h1, h2) || b < 0) return -1;
  return (long long)scratch_layout(b, d, m, h1, h2).total;
}

// x0 [b*d, m], x1 [b*d, h1], w1 [m, m*h1], w2 [h1, m*h2], q [b, m*h1],
// g1p [b, h1], g2p [b, h2] -> gx0 [b*d, m], gw1 [m, m*h1], gw2 [h1, m*h2],
// all bf16; scratch of rm_cin2_backward_scratch bytes, 128-byte aligned.
// Pointers to w1 and w2 must be 32-byte aligned (WMMA reads them in place).
extern "C" int rm_cin2_backward(int device, const void* x0, const void* x1,
                                const void* w1, const void* w2, const void* q,
                                const void* g1p, const void* g2p, void* gx0,
                                void* gw1, void* gw2, void* scratch, int b,
                                int d, int m, int h1, int h2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!supported(d, m, h1, h2)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch S = scratch_layout(b, d, m, h1, h2);
  unsigned char* base = (unsigned char*)scratch;
  bf16* gx1 = (bf16*)(base + S.gx1);
  float* part1 = (float*)(base + S.part1);
  float* part2 = (float*)(base + S.part2);
  if (b == 0) {  // empty batch: the weight grads are zero
    err = cudaMemsetAsync(gw1, 0, (size_t)m * m * h1 * sizeof(bf16), st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(gw2, 0, (size_t)h1 * m * h2 * sizeof(bf16), st);
  }
  const Layout L = rows_layout(h1, h2);
  err = cudaFuncSetAttribute(cin2_bwd_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  cin2_bwd_rows_kernel<<<(b + kExamples - 1) / kExamples, kThreads, L.total, st>>>(
      (const bf16*)x0, (const bf16*)x1, (const bf16*)w1, (const bf16*)w2,
      (const bf16*)g1p, (const bf16*)g2p, (bf16*)gx0, gx1, b, d, m, h1, h2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cin2_bwd_gw2_kernel<<<dim3(m, S.s2), kGemmThreads, 0, st>>>(
      (const bf16*)g2p, (const bf16*)q, part2, b, m, h1, h2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cin2_bwd_gw1_kernel<<<dim3(S.mpad / kPairs3, S.s1), kGemmThreads, 0, st>>>(
      (const bf16*)x0, gx1, part1, (long long)b * d, m, h1, S.mpad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n1 = (long long)m * m * h1;
  const long long n2 = (long long)h1 * m * h2;
  cin2_bwd_reduce_kernel<<<(unsigned)((n1 + 255) / 256), 256, 0, st>>>(
      part1, (bf16*)gw1, n1, (long long)S.mpad * h1, S.s1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cin2_bwd_reduce_kernel<<<(unsigned)((n2 + 255) / 256), 256, 0, st>>>(
      part2, (bf16*)gw2, n2, n2, S.s2);
  return (int)cudaGetLastError();
}
