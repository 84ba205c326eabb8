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
// GMAC (0.124 ms at 989 TFLOP/s), against 82 MB of inputs and 8 MB of
// outputs.
//
// What held the previous design back (WMMA, PR 2; 2.67 ms in five launches
// on an NVIDIA H100 80GB HBM3 at 700 W, the split in PERF.md): the rows
// kernel, the largest, ran one 512-thread
// block an SM on 16 examples, read w2 from L2 as WMMA fragments for t1p at
// M = 16, ran gp per warp at M = 16 and folded gp into gx0_b with two more
// one-hot products; the weight grads went through 50 MB of f32 partials.
//
// This design: t1p becomes one GEMM at M = examples, gp a warpgroup product
// with its A operand (gx1) in registers, the folds stay in registers, and
// both weight grads are split-K warpgroup products over fixed slices of the
// batch, summed in slice order. Five launches on the caller's stream:
//  1. re-layout (cin2_permute): W1P [m*32, h1] (w1 with the pair rows
//     padded, cin2_common.cuh), W2R [m*h1, h2] (W2R[(i,k), n] = w2[k,
//     i*h2 + n]), g2p^T [h2, B] and x0 as 64-byte row slots;
//  2. t1p = g2p [B, h2] x W2R^T (cin2_gemm_tn, wgmma) into scratch;
//  3. rows: persistent blocks of two consumer warpgroups and a producer warp
//     walk tiles of 128 row slots (whole examples, as in the forward). Per
//     tile, with the tile's x0 and the examples' t1p in shared memory:
//     gx0_a on the CUDA cores (its products round one by one, two to a
//     bf16x2 product); gx1 per warp as x0 [16 rows, 32] x t1p_e [32, h1]
//     with mma.sync (its B operand is the example's own t1p, so M is one
//     example's 16 or 32 rows, not a warpgroup's 64; 0.9 GMAC), whose
//     accumulator fragments are, rounded, the A fragments of the next
//     product; gx1^T and x0^T (fields by slots) to scratch for launch 4;
//     then gp = gx1 x W1P^T with wgmma m64n64k16, 64 pairs (two fields h)
//     at a time, W1P streamed by TMA through a ring that runs ahead across
//     tiles; the next chunk's product runs while this one folds into
//     gx0_b: a 64-pair chunk holds fields h and all 32 i, so a thread's
//     columns are eight fixed i; the sum over i reduces across the four
//     lanes of a row, the sum over h stays in each lane's registers;
//  4. weight grads, split-K over fixed slices of slots or examples, no
//     atomics: gw1's blocks form pairs^T [128 pairs, 64 slots] in
//     registers (bf16x2 products of x0^T's rows) against gx1^T; gw2's
//     blocks load Q [64 examples, 64 (i,k)] by TMA and take Q^T's
//     fragments with ldmatrix.trans against g2p^T; both wgmma with
//     register A (each K tile retires before the next one's fragments are
//     formed), one f32 partial per slice, one wave of blocks;
//  5. both weight grads summed over their slices in slice order and
//     rounded, one launch.
// Two runs repeat bit for bit: every sum has a fixed order.
//
// Limits, those of the forward (cin2_takes): D <= 32, m <= 32, h1 and h2
// multiples of 16 from 16 to 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cin2_common.cuh"

namespace rm {
namespace {

constexpr int kX0Ld = 40;     // bf16 row stride of x0 tiles
constexpr int kGxLd = 33;     // f32 row stride of the gx0 sums
constexpr int kStageLd = kTileRows + 8;  // bf16 row stride of the gx1^T staging tile
constexpr int kWStages = 4;   // weight-grad ring

// ------------------------------------------------------------- rows
template <int N1>
__host__ __device__ constexpr int rows_stages() { return N1 == 128 ? 4 : 2; }

struct RowsLayout {
  size_t ring, x0, gx, zero, region, bars, total;
};

template <int N1>
__host__ __device__ inline RowsLayout rows_layout(int m, int h1, int slots) {
  RowsLayout L;
  const size_t stage = (size_t)(N1 / 64) * 8192;
  const int ne = kTileRows / slots;
  const size_t t1 = (size_t)ne * m * (h1 + 8) * 2;
  const size_t st = (size_t)h1 * kStageLd * 2;
  L.ring = 0;
  L.x0 = L.ring + rows_stages<N1>() * stage;
  L.gx = L.x0 + align1k((size_t)kTileRows * kX0Ld * 2);
  L.zero = L.gx + align1k((size_t)kTileRows * kGxLd * 4);
  L.region = L.zero + 1024;
  L.bars = L.region + align1k(t1 > st ? t1 : st);
  L.total = 1024 + L.bars + 2 * rows_stages<N1>() * 8;
  return L;
}

template <int N1>
__global__ void __launch_bounds__(kBlockThreads, 1)
    cin2_bwd_rows_kernel(const __grid_constant__ CUtensorMap mw1, const bf16* __restrict__ x0slot,
                         const bf16* __restrict__ x1g, const bf16* __restrict__ t1g,
                         const bf16* __restrict__ g1p, bf16* __restrict__ gx0g,
                         bf16* __restrict__ gx1t, bf16* __restrict__ x0field, long long slot_pitch,
                         int b, int d, int m, int h1,
                         int slots, int tiles) {
  constexpr int kStages = rows_stages<N1>();
  constexpr int kNK = N1 / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const RowsLayout L = rows_layout<N1>(m, h1, slots);
  const int kt1 = (h1 + 63) / 64;  // K tiles of a pair chunk
  const int stage_bytes = (N1 / 64) * 8192;
  bf16* x0s = reinterpret_cast<bf16*>(smem + L.x0);
  float* gxs = reinterpret_cast<float*>(smem + L.gx);
  bf16* zrow = reinterpret_cast<bf16*>(smem + L.zero);
  bf16* t1s = reinterpret_cast<bf16*>(smem + L.region);
  bf16* stg = t1s;  // gx1^T staging, after t1s is done with
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int chunks = (m + 1) / 2;  // pair chunks of 64: fields 2 pc, 2 pc + 1
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  if (tid < 512 / 8) reinterpret_cast<uint4*>(zrow)[tid] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer: W1P's pair chunks, tile after tile
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int pc = 0; pc < chunks; ++pc, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kt1 * 8192);
          for (int kt = 0; kt < kt1; ++kt)
            tma_load_2d(smem + L.ring + s * stage_bytes + kt * 8192, &mw1, &full[s], kt * 64, pc * 64);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rw = wg * 64 + (warp & 3) * 16;  // this warp's first row of the tile
  const int ra = rw + g;                     // this thread's rows ra, ra + 8
  const int per_tile = kTileRows / slots;
  const int ld1 = h1 + 8;
  const int nk = h1 / 16;
  const long long mh1 = (long long)m * h1;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long e0 = (long long)tile * per_tile;
    consumer_sync();  // the previous tile is done with every shared tile
    load_x0_tile(x0s, kX0Ld, x0slot + (long long)tile * kTileRows * kPairPad, tid);
    // t1p of the tile's examples, contiguous in t1p: [example][i < m][h1]
    // with rows padded to ld1, 16-byte vectors
    const int vecs = h1 / 8;
    const int e_live = (int)min((long long)per_tile, b - e0);  // examples of the tile in the batch
#pragma unroll 4
    for (int v = tid; v < per_tile * m * vecs; v += kConsumers) {
      const int row = v / vecs;  // example * m + i
      *reinterpret_cast<uint4*>(t1s + row * ld1 + (v - row * vecs) * 8) =
          row < e_live * m ? *reinterpret_cast<const uint4*>(t1g + e0 * mh1 + (long long)v * 8)
                           : make_uint4(0, 0, 0, 0);
    }
    consumer_sync();

    // this thread's rows: example, slot, and whether they are real rows
    long long xrow[2];
    bool live[2];
    const int el = rw / slots;  // one example per warp (slots >= 16)
    const long long e = e0 + el;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = (ra + 8 * half) % slots;
      live[half] = e < b && s < d;
      xrow[half] = e * d + s;
    }
    const bf16* t1e = t1s + el * m * ld1;

    // gx0_a[r, i] = sum_k bf16(t1p[i, k] * x1[r, k]): this thread's columns
    // k = 16 kb + 2 t + {0, 1, 8, 9} of x1 in registers, then the row's four lanes
    {
      uint32_t xr[2][kNK][2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int kb = 0; kb < kNK; ++kb) {
          const bool in = live[half] && kb < nk;
          const uint32_t* xp =
              reinterpret_cast<const uint32_t*>(x1g + (in ? xrow[half] * h1 + 16 * kb + 2 * t : 0));
          xr[half][kb][0] = in ? xp[0] : 0u;
          xr[half][kb][1] = in ? xp[4] : 0u;
        }
      }
#pragma unroll 2
      for (int i = 0; i < m; ++i) {
        float sum[2] = {0.f, 0.f};
        const bf16* ti = t1e + i * ld1 + 2 * t;
#pragma unroll
        for (int kb = 0; kb < kNK; ++kb) {
          if (kb < nk) {
            const __nv_bfloat162 ta = *reinterpret_cast<const __nv_bfloat162*>(ti + 16 * kb);
            const __nv_bfloat162 tb = *reinterpret_cast<const __nv_bfloat162*>(ti + 16 * kb + 8);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const __nv_bfloat162 pa = __hmul2(ta, *reinterpret_cast<const __nv_bfloat162*>(&xr[half][kb][0]));
              const __nv_bfloat162 pb = __hmul2(tb, *reinterpret_cast<const __nv_bfloat162*>(&xr[half][kb][1]));
              sum[half] += (__low2float(pa) + __high2float(pa)) + (__low2float(pb) + __high2float(pb));
            }
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
          sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
          if (t == 0) gxs[(ra + 8 * half) * kGxLd + i] = sum[half];
        }
      }
    }

    // gx1 = bf16(x0 [16 rows, 32] x t1p_e [32, h1] + g1p): accumulator
    // fragments of n8 tiles 2 kb and 2 kb + 1 are the A fragment of k16
    // block kb of gp's product; pad rows (past D, past B) are zero
    uint32_t ga[kNK][4];
    {
      uint32_t af[2][4];
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) load_a(af[kb], x0s, kX0Ld, rw, kb * 16, lane);
#pragma unroll
      for (int kb = 0; kb < kNK; ++kb) {
        if (kb < nk) {
          float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int fb = 0; fb < 2; ++fb) {
            if (fb * 16 < m) {
              const int i = fb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
              uint32_t bfr[4];
              ldmatrix_x4_trans(bfr, i < m ? t1e + i * ld1 + kb * 16 + (lane >> 4) * 8 : zrow);
              mma_bf16(c0, af[fb], bfr[0], bfr[1]);
              mma_bf16(c1, af[fb], bfr[2], bfr[3]);
            }
          }
          const int col = kb * 16 + 2 * t;
          float gv[4] = {0.f, 0.f, 0.f, 0.f};
          if (e < b) {
            const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g1p + e * h1 + col));
            const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g1p + e * h1 + col + 8));
            gv[0] = lo.x; gv[1] = lo.y; gv[2] = hi.x; gv[3] = hi.y;
          }
          const float l0 = live[0] ? 1.f : 0.f;
          const float l1 = live[1] ? 1.f : 0.f;
          ga[kb][0] = pack_bf16x2(l0 * (c0[0] + gv[0]), l0 * (c0[1] + gv[1]));
          ga[kb][1] = pack_bf16x2(l1 * (c0[2] + gv[0]), l1 * (c0[3] + gv[1]));
          ga[kb][2] = pack_bf16x2(l0 * (c1[0] + gv[2]), l0 * (c1[1] + gv[3]));
          ga[kb][3] = pack_bf16x2(l1 * (c1[2] + gv[2]), l1 * (c1[3] + gv[3]));
        } else {
          ga[kb][0] = ga[kb][1] = ga[kb][2] = ga[kb][3] = 0u;
        }
      }
    }
    consumer_sync();  // every warp is done with t1s: it becomes the staging tile
    // gx1^T [h1][128 slots] through shared memory, then 16-byte stores
#pragma unroll
    for (int kb = 0; kb < kNK; ++kb) {
      if (kb < nk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&ga[kb][q]);
          const int col = kb * 16 + 2 * t + (q >> 1) * 8;
          const int r = ra + (q & 1) * 8;
          stg[col * kStageLd + r] = __low2bfloat16(v);
          stg[(col + 1) * kStageLd + r] = __high2bfloat16(v);
        }
      }
    }
    consumer_sync();
    for (int idx = tid; idx < h1 * (kTileRows / 8); idx += kConsumers) {
      const int n = idx / (kTileRows / 8);
      const int c = (idx % (kTileRows / 8)) * 8;
      *reinterpret_cast<uint4*>(gx1t + n * slot_pitch + (long long)tile * kTileRows + c) =
          *reinterpret_cast<const uint4*>(stg + n * kStageLd + c);
    }
    // x0 transposed, fields by slots, for launch 4's pair products
    for (int idx = tid; idx < kPairPad * (kTileRows / 8); idx += kConsumers) {
      const int f = idx / (kTileRows / 8);
      const int c = (idx % (kTileRows / 8)) * 8;
      union {
        uint4 u;
        bf16 h[8];
      } v;
#pragma unroll
      for (int k = 0; k < 8; ++k) v.h[k] = x0s[(c + k) * kX0Ld + f];
      *reinterpret_cast<uint4*>(x0field + f * slot_pitch + (long long)tile * kTileRows + c) = v.u;
    }

    // gp = gx1 x W1P^T, 64 pairs (fields h = 2 pc, 2 pc + 1) at a time, and
    // its folds: b1[r, h] = sum_i bf16(gp * x0[r, i]) into gxs, b2[r, i] =
    // sum_h bf16(gp * x0[r, h]) in registers; i = 8 (q / 2) + 2 t + q % 2
    __nv_bfloat162 xi[2][4];  // x0[r, i], x0[r, i + 1] at i = 8 j4 + 2 t
    float b2[2][8];
#pragma unroll
    for (int q = 0; q < 8; ++q) b2[0][q] = b2[1][q] = 0.f;
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        xi[half][j4] = *reinterpret_cast<const __nv_bfloat162*>(x0s + (ra + 8 * half) * kX0Ld + 8 * j4 + 2 * t);
    // chunk pc + 1's product runs on the tensor cores while chunk pc folds
    // (gx1's fragments are not written during the loop; the accumulators
    // alternate)
    auto issue = [&](float (&acc)[32], int itx) {
      const int s = itx % kStages;
      mbar_wait(&full[s], (itx / kStages) & 1);
      const unsigned char* st = smem + L.ring + s * stage_bytes;
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < kNK; ++kb)
        if (kb < nk) Wgmma<64>::rs(acc, ga[kb], desc_k128(st + (kb >> 2) * 8192) + 2 * (kb & 3), 1);
      wgmma_commit();
    };
    // the products round as bf16(a*b) does: one bf16x2 product for two
    auto fold = [&](const float (&acc)[32], int pc) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = 2 * pc + hh;  // < 32: x0s is zero past m, so is gp
        float b1[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two partial sums a row
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const __nv_bfloat162 xh = __bfloat162bfloat162(x0s[(ra + 8 * half) * kX0Ld + h]);
#pragma unroll
          for (int j4 = 0; j4 < 4; ++j4) {
            const int j = hh * 4 + j4;
            const __nv_bfloat162 gp = __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
            const __nv_bfloat162 pi = __hmul2(gp, xi[half][j4]);
            const __nv_bfloat162 ph = __hmul2(gp, xh);
            b1[half][j4 >> 1] += __low2float(pi) + __high2float(pi);
            b2[half][2 * j4] += __low2float(ph);
            b2[half][2 * j4 + 1] += __high2float(ph);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v = b1[half][0] + b1[half][1];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0 && h < m) gxs[(ra + 8 * half) * kGxLd + h] += v;
        }
      }
    };
    float acc0[32], acc1[32];
    issue(acc0, it);
    for (int pc = 0; pc < chunks; pc += 2) {
      if (pc + 1 < chunks) {
        issue(acc1, it + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(acc0);
      if (lane == 0) mbar_arrive(&empty[it % kStages]);
      ++it;
      fold(acc0, pc);
      if (pc + 1 >= chunks) break;
      if (pc + 2 < chunks) {
        issue(acc0, it + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(acc1);
      if (lane == 0) mbar_arrive(&empty[it % kStages]);
      ++it;
      fold(acc1, pc + 1);
    }
    __syncwarp();  // gxs of this warp's rows is complete (its lanes wrote it)
    // gx0 = bf16((gx0_a + b1) + b2)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!live[half]) continue;
      const int r = ra + 8 * half;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = (q >> 1) * 8 + 2 * t + (q & 1);
        if (i < m) gx0g[xrow[half] * m + i] = __float2bfloat16_rn(gxs[r * kGxLd + i] + b2[half][q]);
      }
    }
  }
}

// ------------------------------------------------------- weight grads
// gw1 partial of slot slice s for pair tile pt (128 pairs, fields 4 pt ..
// 4 pt + 3): part1[s][p][n] = sum_{slots in s} pairs[slot, p] * gx1[slot, n];
// gw2 partial of example slice s for (i,k) tile qt: part2[s][(i,k)][n] =
// sum_{b in s} Q[b, (i,k)] * g2p[b, n]. Blocks [0, g1) take gw1, the rest
// gw2; K tiles of 64 through a 4-stage ring that the producer warp fills
// by TMA (for gw1, gx1^T's tile and x0^T's [32 fields, 64 slots]).
struct WgradArgs {
  float* part1;
  float* part2;
  int b, m, h1, h2;
  int pair_tiles, s1, s2, kt1, kt2;  // gw1's tiles; slices and K tiles of both grads
};

template <int NW>
__global__ void __launch_bounds__(kBlockThreads, 1)
    cin2_bwd_wgrad_kernel(const __grid_constant__ CUtensorMap mgx1, const __grid_constant__ CUtensorMap mx0,
                          const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mg2,
                          const WgradArgs A) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  constexpr int kBBytes = NW * 128;           // [NW][64] tile of gx1^T or g2p^T
  constexpr int kABytes = 2 * 8192;           // gw2: two Q tiles [64][64]; gw1: x0 fields [32][64 slots]
  constexpr int kStage = kABytes + kBBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWStages * kStage);
  uint64_t* empty = full + kWStages;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g1 = A.pair_tiles * A.s1;
  const bool is_gw1 = (int)blockIdx.x < g1;
  const int idx = is_gw1 ? blockIdx.x : blockIdx.x - g1;
  const int s1or2 = is_gw1 ? A.s1 : A.s2;
  const int tile = idx / s1or2;
  const int slice = idx % s1or2;
  const int kt_all = is_gw1 ? A.kt1 : A.kt2;
  const int kt_begin = (int)((long long)slice * kt_all / s1or2);
  const int kt_end = (int)((long long)(slice + 1) * kt_all / s1or2);
  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int n = kt - kt_begin;
        const int s = n % kWStages;
        unsigned char* st = smem + s * kStage;
        mbar_wait(&empty[s], ((n / kWStages) & 1) ^ 1);
        if (is_gw1) {
          mbar_expect_tx(&full[s], kBBytes + kPairPad * 64 * 2);
          tma_load_2d(st, &mx0, &full[s], kt * 64, 0);
          tma_load_2d(st + kABytes, &mgx1, &full[s], kt * 64, 0);
        } else {
          mbar_expect_tx(&full[s], kStage);
          tma_load_2d(st, &mq, &full[s], tile * 128, kt * 64);
          tma_load_2d(st + 8192, &mq, &full[s], tile * 128 + 64, kt * 64);
          tma_load_2d(st + kABytes, &mg2, &full[s], kt * 64, 0);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int w4 = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[NW / 2];
#pragma unroll
  for (int k = 0; k < NW / 2; ++k) acc[k] = 0.f;
  // gw1: this warp's 16 pairs are field h, i in [i0, i0 + 16)
  const int h = tile * 4 + wg * 2 + (w4 >> 1);
  const int i0 = (w4 & 1) * 16;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int n = kt - kt_begin;
    const int s = n % kWStages;
    const unsigned char* st = smem + s * kStage;
    uint32_t a[4][4];
    mbar_wait(&full[s], (n / kWStages) & 1);
    if (is_gw1) {
      // x0's fields by slots, 128-byte rows swizzled: the pair products of
      // two adjacent slots are one bf16x2 product (it rounds as bf16(a*b))
      const bf16* xc = reinterpret_cast<const bf16*>(st);
      auto pair2 = [&](int f, int slot) {  // x0[slot, f], x0[slot + 1, f]
        return *reinterpret_cast<const __nv_bfloat162*>(xc + f * 64 + (((slot >> 3) ^ (f & 7)) << 3) + (slot & 7));
      };
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int c = ks * 16 + 2 * t;
        const __nv_bfloat162 xh0 = pair2(h, c), xh1 = pair2(h, c + 8);
        const __nv_bfloat162 p0 = __hmul2(xh0, pair2(i0 + g, c));
        const __nv_bfloat162 p1 = __hmul2(xh0, pair2(i0 + g + 8, c));
        const __nv_bfloat162 p2 = __hmul2(xh1, pair2(i0 + g, c + 8));
        const __nv_bfloat162 p3 = __hmul2(xh1, pair2(i0 + g + 8, c + 8));
        a[ks][0] = *reinterpret_cast<const uint32_t*>(&p0);
        a[ks][1] = *reinterpret_cast<const uint32_t*>(&p1);
        a[ks][2] = *reinterpret_cast<const uint32_t*>(&p2);
        a[ks][3] = *reinterpret_cast<const uint32_t*>(&p3);
      }
    } else {
      const bf16* qt = reinterpret_cast<const bf16*>(st + wg * 8192);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) load_a_trans_sw128(a[ks], qt, w4 * 16, ks * 16, lane);
    }
    const uint64_t bd = desc_k128(st + kABytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<NW>::rs(acc, a[ks], bd + 2 * ks, 1);
    // the A fragments are read after issue: retire the group before the
    // next k tile's are formed
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  fence_regs(acc);
  // the partial: rows (pairs or (i,k)) of this warp, all NW columns
  const int ncols = is_gw1 ? A.h1 : A.h2;
  float* out;
  long long row0, rows_all;
  if (is_gw1) {
    rows_all = (long long)A.m * kPairPad;
    row0 = (long long)h * kPairPad + i0;
    out = A.part1 + (long long)slice * rows_all * A.h1;
    if (h >= A.m) return;
  } else {
    rows_all = (long long)A.m * A.h1;
    row0 = (long long)tile * 128 + wg * 64 + w4 * 16;
    out = A.part2 + (long long)slice * rows_all * A.h2;
  }
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col < ncols) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long r = row0 + g + 8 * half;
        if (r < rows_all)
          *reinterpret_cast<float2*>(out + r * ncols + col) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

// ------------------------------------------------------------- reduce
// gw1[h, i*h1 + n] = bf16(sum_s part1[s][h*32 + i][n]) and
// gw2[k, i*h2 + n] = bf16(sum_s part2[s][i*h1 + k][n]), slices in order.
__global__ void cin2_bwd_reduce_kernel(const float* __restrict__ part1, const float* __restrict__ part2,
                                       bf16* __restrict__ gw1, bf16* __restrict__ gw2, int m, int h1,
                                       int h2, int s1, int s2) {
  const long long n1 = (long long)m * m * h1;
  const long long n2 = (long long)h1 * m * h2;
  const long long stride1 = (long long)m * kPairPad * h1;
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < n1 + n2;
       o += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    if (o < n1) {
      const int n = (int)(o % h1);
      const long long hi = o / h1;  // h * m + i
      const long long src = ((hi / m) * kPairPad + hi % m) * h1 + n;
      for (int s = 0; s < s1; ++s) v = __fadd_rn(v, part1[s * stride1 + src]);
      gw1[o] = __float2bfloat16_rn(v);
    } else {
      const long long o2 = o - n1;
      const int n = (int)(o2 % h2);
      const long long ki = o2 / h2;  // k * m + i
      const long long src = ((ki % m) * h1 + ki / m) * h2 + n;
      for (int s = 0; s < s2; ++s) v = __fadd_rn(v, part2[s * n2 + src]);
      gw2[o2] = __float2bfloat16_rn(v);
    }
  }
}

struct Plan {
  int slots, tiles, s1, s2, kt1, kt2, pair_tiles, q_tiles;
  long long slot_pitch, bp;
  size_t w1p, w2r, g2t, x0slot, x0field, t1p, gx1t, part1, part2, total;
};

Plan plan(long long b, int d, int m, int h1, int h2, int sms) {
  Plan P;
  P.slots = cin2_slots(d);
  P.tiles = (int)((b * P.slots + kTileRows - 1) / kTileRows);
  P.slot_pitch = (long long)P.tiles * kTileRows;
  P.bp = (b + 7) / 8 * 8;
  P.kt1 = (int)(P.slot_pitch / 64);
  P.kt2 = (int)((b + 63) / 64);
  P.pair_tiles = (m + 3) / 4;
  P.q_tiles = (m * h1 + 127) / 128;
  // one wave of blocks (one an SM), K tiles shared out evenly: the fewest
  // K tiles a block such that the slices of both grads fit the SMs
  const long long work = (long long)P.pair_tiles * P.kt1 + (long long)P.q_tiles * P.kt2;
  for (long long per = (work + sms - 1) / sms;; ++per) {
    P.s1 = (int)((P.kt1 + per - 1) / per);
    P.s2 = (int)((P.kt2 + per - 1) / per);
    if ((long long)P.pair_tiles * P.s1 + (long long)P.q_tiles * P.s2 <= sms || (P.s1 == 1 && P.s2 == 1))
      break;
  }
  P.w1p = 0;
  P.w2r = align1k((size_t)m * kPairPad * h1 * 2);
  P.g2t = P.w2r + align1k((size_t)m * h1 * h2 * 2);
  P.x0slot = P.g2t + align1k((size_t)h2 * P.bp * 2);
  P.x0field = P.x0slot + align1k((size_t)P.slot_pitch * kPairPad * 2);
  P.t1p = P.x0field + align1k((size_t)P.slot_pitch * kPairPad * 2);
  P.gx1t = P.t1p + align1k((size_t)b * m * h1 * 2);
  P.part1 = P.gx1t + align1k((size_t)h1 * P.slot_pitch * 2);
  P.part2 = P.part1 + align1k((size_t)P.s1 * m * kPairPad * h1 * 4);
  P.total = P.part2 + (size_t)P.s2 * m * h1 * h2 * 4;
  return P;
}

template <int N1>
int rows_launch(const Plan& P, const bf16* w1p, const bf16* x0slot, const bf16* x1, const bf16* t1p,
                const bf16* g1p, bf16* gx0, bf16* gx1t, bf16* x0field, int b, int d, int m, int h1,
                int sms, cudaStream_t st) {
  CUtensorMap mw1;
  int err = make_map_bf16(&mw1, w1p, h1, (long long)m * kPairPad, h1, 64);
  if (err) return err;
  const RowsLayout L = rows_layout<N1>(m, h1, P.slots);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(cin2_bwd_rows_kernel<N1>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const int grid = P.tiles < sms ? P.tiles : sms;
  cin2_bwd_rows_kernel<N1><<<grid, kBlockThreads, L.total, st>>>(
      mw1, x0slot, x1, t1p, g1p, gx0, gx1t, x0field, P.slot_pitch, b, d, m, h1, P.slots, P.tiles);
  return (int)cudaGetLastError();
}

template <int NW>
int wgrad_launch(const Plan& P, const bf16* gx1t, const bf16* x0field, const bf16* q, const bf16* g2t,
                 const WgradArgs& A, cudaStream_t st) {
  CUtensorMap mgx1, mx0, mq, mg2;
  int err = make_map_bf16(&mgx1, gx1t, P.slot_pitch, A.h1, P.slot_pitch, NW);
  if (err) return err;
  err = make_map_bf16(&mx0, x0field, P.slot_pitch, kPairPad, P.slot_pitch, kPairPad);
  if (err) return err;
  err = make_map_bf16(&mq, q, (long long)A.m * A.h1, A.b, (long long)A.m * A.h1, 64);
  if (err) return err;
  err = make_map_bf16(&mg2, g2t, A.b, A.h2, P.bp, NW);
  if (err) return err;
  const size_t smem = 1024 + kWStages * (size_t)(2 * 8192 + NW * 128) + 2 * kWStages * 8;
  cudaError_t e = cudaFuncSetAttribute(cin2_bwd_wgrad_kernel<NW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = P.pair_tiles * P.s1 + P.q_tiles * P.s2;
  cin2_bwd_wgrad_kernel<NW><<<blocks, kBlockThreads, smem, st>>>(mgx1, mx0, mq, mg2, A);
  return (int)cudaGetLastError();
}

int sm_count(int device, int* sms) {
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace
}  // namespace rm

using namespace rm;

extern "C" int rm_cin2_takes(int d, int m, int h1, int h2);

// Bytes of scratch rm_cin2_backward needs (re-laid weights and g2p, t1p,
// gx1^T and the weight-grad partials), or -1 for shapes it does not take.
extern "C" long long rm_cin2_backward_scratch(int device, int b, int d, int m, int h1, int h2) {
  int sms = 0;
  if (!rm_cin2_takes(d, m, h1, h2) || b < 0 || sm_count(device, &sms)) return -1;
  return (long long)plan(b, d, m, h1, h2, sms).total;
}

// x0 [b*d, m], x1 [b*d, h1], w1 [m, m*h1], w2 [h1, m*h2], q [b, m*h1],
// g1p [b, h1], g2p [b, h2] -> gx0 [b*d, m], gw1 [m, m*h1], gw2 [h1, m*h2],
// all bf16; scratch of rm_cin2_backward_scratch bytes. q, g1p, g2p, x1
// 16-byte aligned.
extern "C" int rm_cin2_backward(int device, const void* x0, const void* x1, const void* w1,
                                const void* w2, const void* q, const void* g1p, const void* g2p,
                                void* gx0, void* gw1, void* gw2, void* scratch, int b, int d,
                                int m, int h1, int h2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!rm_cin2_takes(d, m, h1, h2)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (b == 0) {  // empty batch: the weight grads are zero
    err = cudaMemsetAsync(gw1, 0, (size_t)m * m * h1 * sizeof(bf16), st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(gw2, 0, (size_t)h1 * m * h2 * sizeof(bf16), st);
  }
  int sms = 0;
  int e = sm_count(device, &sms);
  if (e) return e;
  const Plan P = plan(b, d, m, h1, h2, sms);
  unsigned char* base = (unsigned char*)scratch;
  bf16* w1p = (bf16*)(base + P.w1p);
  bf16* w2r = (bf16*)(base + P.w2r);
  bf16* g2t = (bf16*)(base + P.g2t);
  bf16* x0slot = (bf16*)(base + P.x0slot);
  bf16* x0field = (bf16*)(base + P.x0field);
  bf16* t1p = (bf16*)(base + P.t1p);
  bf16* gx1t = (bf16*)(base + P.gx1t);
  float* part1 = (float*)(base + P.part1);
  float* part2 = (float*)(base + P.part2);
  // W1P[h][i][n] = w1[h, i*h1 + n] (zero for i >= m); W2R[i][k][n] =
  // w2[k, i*h2 + n]; g2p^T[n][b]; x0 in row slots
  const Perm jobs[4] = {
      {(const bf16*)w1, w1p, m, kPairPad, h1, m, m, h1, (long long)m * h1, h1, 1},
      {(const bf16*)w2, w2r, m, h1, h2, m, h1, h2, h2, (long long)m * h2, 1},
      {(const bf16*)g2p, g2t, 1, h2, (int)P.bp, 1, h2, b, 0, 1, h2},
      x0_slot_job((const bf16*)x0, x0slot, b, d, m, P.slots, P.tiles),
  };
  e = cin2_permute(jobs, 4, st);
  if (e) return e;
  e = cin2_gemm_tn((const bf16*)g2p, w2r, t1p, b, m * h1, h2, st);
  if (e) return e;
  e = h1 <= 128 ? rows_launch<128>(P, w1p, x0slot, (const bf16*)x1, t1p, (const bf16*)g1p, (bf16*)gx0,
                                   gx1t, x0field, b, d, m, h1, sms, st)
                : rows_launch<256>(P, w1p, x0slot, (const bf16*)x1, t1p, (const bf16*)g1p, (bf16*)gx0,
                                   gx1t, x0field, b, d, m, h1, sms, st);
  if (e) return e;
  const WgradArgs A = {part1, part2, b, m, h1, h2, P.pair_tiles, P.s1, P.s2, P.kt1, P.kt2};
  e = (h1 <= 128 && h2 <= 128) ? wgrad_launch<128>(P, gx1t, x0field, (const bf16*)q, g2t, A, st)
                               : wgrad_launch<256>(P, gx1t, x0field, (const bf16*)q, g2t, A, st);
  if (e) return e;
  const long long n = (long long)m * m * h1 + (long long)h1 * m * h2;
  const long long blocks = (n + 255) / 256;
  cin2_bwd_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      part1, part2, (bf16*)gw1, (bf16*)gw2, m, h1, h2, P.s1, P.s2);
  return (int)cudaGetLastError();
}
