// One generic CIN layer, backward (xDeepFM): all three cotangents.
//
// Replaces: recmodels_tpu/ops/pallas/interactions_tpu.py::_cin_bwd_pallas
// (its _cin_bwd_kernel). Rows r = (b, d); xk [R, Hk], x0 [R, m], the flat
// weight w2 [Hk, m*Hn] and the output's cotangent g [R, Hn], all bf16, give,
// with w2_i = w2[:, i*Hn:(i+1)*Hn] and every sum in f32:
//   t1_i = bf16( g @ w2_i^T )                   [R, Hk]
//   gxk  = bf16( sum_i t1_i * x0[:, i] )        [R, Hk]
//   q_i  = bf16( t1_i * xk ),  gx0[:, i] = bf16( sum_h q_i )
//   z_i  = bf16( xk * x0[:, i] ), gw[:, i*Hn:(i+1)*Hn] = bf16( z_i^T @ g )
// These are the TPU kernel's rounding points (its t1 chunks, q and z are
// bf16, its gxk, gx0 and gw sums f32); its mechanism (the wpT scratch, the
// ONES dot, the gw scratch carried across an in-order grid) is not carried.
//
// Bound on this card: operations, 2 * 2 * R * Hk * m * Hn (the t1 products
// and the gw products), 446 GFLOP at the training shape (R = 262,144,
// Hk = Hn = 128, m = 26): 0.4516 ms at 989 TFLOP/s.
//
// What held the previous design back (mma.sync; 3.2885 ms on an NVIDIA H100
// 80GB HBM3 at 700 W by chip_smoke.py, by launch 1.9993 rows, 1.2125 gw,
// 0.0423 sum, PERF.md): the rows kernel gave each warp 16 rows and had every
// warp read the whole [128 h x 128 n] w2_i block from shared memory as B
// fragments (8 warps x 32 KB a field for 4.2 MFLOP: shared memory, not the
// tensor cores, set its pace), ran one block an SM with a barrier and a
// cp.async wait per field, and folded on every warp at once while the tensor
// cores idled. The gw kernel, one field a block, staged the g and xk rows of
// its slice again for every field (3.4 GB from L2 a call), formed z_i in
// shared memory between two barriers with x0 read at a stride of m, ran a
// two-deep ring, and wrote 64 slices of f32 partials (109 MB) that a third
// kernel read back.
//
// This design, three launches on the caller's stream (four when an input is
// not laid out for TMA, see below):
//  1. rows: t1 = g [R, Hn] x W [Hn, m*Hk] as one GEMM whose 128-wide N blocks
//     are the fields i, folded in its epilogue. Persistent blocks of a
//     producer warpgroup (one thread issues the copies; setmaxnreg hands its
//     registers to the consumers, 232 a thread) and two consumer warpgroups
//     (64 rows each) walk tiles of 128 rows. The producer loads a tile's g
//     rows once (TMA, K-major as they lie) and, per h block of 128, its xk
//     rows, and streams w2's [128 h x 64 n] boxes (a 3-D map [h][i][n], so a
//     box stops at its field's edge) through a ring of up to eight stages
//     that runs ahead across fields and tiles. Products are wgmma m64n128k16
//     with both operands in shared memory, so no register A operand is in
//     flight while the fold runs. The fold keeps the contract's rounding
//     points: t1_i rounds to bf16; gxk's f32 accumulators (64 a thread,
//     across i) take t1_i * x0[r, i]; q_i forms as bf16x2 products with xk's
//     values at the accumulator's positions (read once per h block into
//     registers), and those products lie as mma.m16n8k16 A fragments, so
//     q_i's row sums are one mma.sync against ones (f32 sums on the tensor
//     cores, not 64 adds and shuffles a thread); they go to an f32 partial
//     per (row, i) in shared memory, rounded once per tile. The two
//     warpgroups take turns issuing (two named barriers), so one's products
//     run while the other folds. Hk > 128 walks h blocks with their own gxk
//     pass; Hn > 128 is the K loop (past Hn = 256 the g tiles stream through
//     the ring with w2's). A field's K tiles go in windows of at most the
//     ring's depth, one window a turn: a window's stages are waited for
//     together, its products issue unbroken, and both warpgroups release
//     them before the ring must refill them. Where the ring holds a field
//     (as at the training shape) a field is one window and the loop unrolls
//     (a template instance a K-tile count). Ragged R, Hk and Hn
//     read TMA's zero fill and mask the stores. The kernel also writes x0^T
//     [m][R] (the x0 values it loads anyway) for launch 2.
//  2. gw: split-K over a fixed number of row slices, so that the blocks of
//     (field pair, h block, n block, slice) fill the SMs once (10 slices at
//     m = 26: 17 MB of partials, not 109). Each warpgroup takes one field
//     of the pair; the two share every staged K tile of 64 rows, so a slice
//     is read m / 2 times from L2, not m times. A = z_i^T in registers:
//     xk's fragments by ldmatrix.trans from the TMA tile [64 r x 128 h],
//     each scaled by its row's x0[r, i] (one bf16x2 product rounds as
//     bf16(xk * x0)), with x0's column pair staged by TMA from x0^T beside
//     the tiles (x0 read at a stride of m cost more than the products);
//     each K tile retires before the registers are written again
//     (wgmma_sm90.cuh), and the warpgroups take turns issuing, so one forms
//     its fragments while the other's products run. B = g's TMA tile
//     [64 r x 128 n] read MN-major with the transpose-B bit, so no g^T is
//     written (a layout probe on the card checked the descriptor first). A
//     6-stage ring; blocks with field pair fastest share a slice's rows in
//     L2. An odd m's last warpgroup runs on TMA's zero fill and stores
//     nothing, so no branch surrounds the products.
//  3. sum: the slices' partials summed in slice order, rounded to bf16.
// No atomics: every sum has a fixed order, so a run repeats bit for bit.
// Measured the same way: 1.0820 ms (rows 0.7268, gw 0.3310, sum 0.0045),
// 2.4x the bound; the rows kernel's fold and the issue of its products,
// not its w2 stream, hold it now (PERF.md).
//
// Inputs that TMA cannot read as they lie (a row pitch that is not a
// multiple of 16 bytes, or a base off 16 bytes) are first copied by one
// re-layout launch (cin2_permute) into scratch with padded rows; the
// kernels are the same. m is bounded by the rows kernel's shared memory:
// the (row, i) partials take 512 m bytes beside a ring of at least two
// stages, g's and xk's tiles: m <= 291 at Hn up to 64, 259 from 65 to 128,
// 227 from 129 to 192, 195 from 193 to 256, 259 above 256.

#include "cin2_common.cuh"

namespace rm {
namespace {

constexpr int kBox = 128 * 128;       // bytes of a [128 rows][64] bf16 box
constexpr int kHalfBox = 64 * 128;    // bytes of a [64 rows][64] box
constexpr int kGResident = 4;         // K tiles of g a rows tile holds: Hn <= 256
constexpr int kGwStages = 6;
// xk [64 r][128 h], g [64 r][128 n] and x0^T [2 fields][64 r]
constexpr int kGwX0 = 4 * kHalfBox;
constexpr int kGwStage = kGwX0 + 1024;
constexpr int kOrder0 = 2, kOrder1 = 3, kWgSync = 4;  // named barriers (0: __syncthreads)
constexpr uint32_t kOnes = 0x3F803F80u;                 // bf16x2 (1, 1)
// two consumer warpgroups and a producer warpgroup (one thread of it issues
// the copies): the producer gives its registers up to the consumers
constexpr int kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// ------------------------------------------------------------------ rows
struct RowsLayout {
  int nkt, nhb, stage_bytes, stages;
  bool g_resident;
  size_t g, x, ring, sp, bars, total;
};

__host__ __device__ inline RowsLayout rows_layout(int hk, int m, int hn, int stages) {
  RowsLayout L;
  L.nkt = (hn + 63) / 64;
  L.nhb = (hk + 127) / 128;
  L.g_resident = L.nkt <= kGResident;
  L.stage_bytes = L.g_resident ? kBox : 2 * kBox;  // w2's box (and g's when streamed)
  L.stages = stages;
  L.g = 0;
  L.x = L.g + (L.g_resident ? (size_t)L.nkt * kBox : 0);
  L.ring = L.x + 2 * (size_t)kBox;
  L.sp = L.ring + (size_t)stages * L.stage_bytes;
  L.bars = L.sp + (((size_t)kTileRows * m * 4 + 15) & ~(size_t)15);
  L.total = 1024 + L.bars + (2 * (size_t)stages + 4) * 8;
  return L;
}

// the deepest ring (8 down to 2 stages) that fits, or 0
int rows_stages(int hk, int m, int hn) {
  for (int s = 8; s >= 2; --s) {
    if (rows_layout(hk, m, hn, s).total <= kMaxSmem) return s;
  }
  return 0;
}

// Up to Hn = 256 g's K tiles are held for the tile; past it they stream
// through the ring with w2's. NKT > 0: a field is one window of NKT K tiles
// (g held, a ring of at least NKT stages), so its K loop unrolls into
// straight-line waits and products; 0: any Hn and ring, a field in windows
// of at most `stages` tiles. ptxas serialises the wgmma of a function whose
// K loop it cannot unroll (C7520: 0.70 -> 1.12 ms at the training shape on
// the H100), so only the shapes that need more windows take NKT = 0.
// Besides gxk and gx0 the kernel writes x0^T [m][rows8] for the gw kernel.
template <int NKT>
__global__ void __launch_bounds__(kThreads, 1)
    cin_bwd_rows_kernel(const __grid_constant__ CUtensorMap mg, const __grid_constant__ CUtensorMap mx,
                        const __grid_constant__ CUtensorMap mw, const bf16* __restrict__ x0,
                        bf16* __restrict__ gxk, bf16* __restrict__ gx0, bf16* __restrict__ x0t,
                        long long rows8, long long rows, int hk, int m, int hn, int stages, int tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const RowsLayout L = rows_layout(hk, m, hn, stages);
  float* sp = reinterpret_cast<float*>(smem + L.sp);  // gx0 partials [128 rows][m]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  uint64_t* g_full = empty + stages;
  uint64_t* g_empty = g_full + 1;
  uint64_t* x_full = g_full + 2;
  uint64_t* x_empty = g_full + 3;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(g_full, 1);
    mbar_init(g_empty, kConsumers / 32);
    mbar_init(x_full, 1);
    mbar_init(x_empty, kConsumers / 32);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // producer: per tile g, per h block xk, per field w2
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      int it = 0, nt = 0, nu = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++nt) {
        const int row0 = tile * kTileRows;
        if (L.g_resident) {
          mbar_wait(g_empty, (nt & 1) ^ 1);
          mbar_expect_tx(g_full, L.nkt * kBox);
          for (int kt = 0; kt < L.nkt; ++kt) tma_load_2d(smem + L.g + kt * kBox, &mg, g_full, kt * 64, row0);
        }
        for (int hb = 0; hb < L.nhb; ++hb, ++nu) {
          mbar_wait(x_empty, (nu & 1) ^ 1);
          mbar_expect_tx(x_full, 2 * kBox);
          tma_load_2d(smem + L.x, &mx, x_full, hb * 128, row0);
          tma_load_2d(smem + L.x + kBox, &mx, x_full, hb * 128 + 64, row0);
          for (int i = 0; i < m; ++i) {
            for (int kt = 0; kt < L.nkt; ++kt, ++it) {
              const int s = it % stages;
              unsigned char* st = smem + L.ring + (size_t)s * L.stage_bytes;
              mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
              mbar_expect_tx(&full[s], L.stage_bytes);
              tma_load_3d(st, &mw, &full[s], kt * 64, i, hb * 128);
              if (!L.g_resident) tma_load_2d(st + kBox, &mg, &full[s], kt * 64, row0);
            }
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rl = wg * 64 + (warp & 3) * 16 + g;  // tile rows rl, rl + 8 of this thread
  const int nkt = NKT ? NKT : L.nkt;
  const int window = NKT ? NKT : stages;
  const bool g_resident = NKT || L.g_resident;
  int it = 0, nt = 0, nu = 0, turn = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++nt) {
    const long long ra = (long long)tile * kTileRows + rl;
    const long long rb = ra + 8;
    if (L.g_resident) mbar_wait(g_full, nt & 1);
    for (int hb = 0; hb < L.nhb; ++hb, ++nu) {
      // xk at the accumulator's positions (row rl or rl + 8, cols 8 j + 2 t,
      // + 1) from the swizzled tile, kept for the h block; then the tile is
      // the producer's again
      mbar_wait(x_full, nu & 1);
      uint32_t xr[16][2];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const unsigned char* xb = smem + L.x + (j >> 3) * kBox + (((j & 7) ^ (rl & 7)) << 4) + 4 * t;
        xr[j][0] = *reinterpret_cast<const uint32_t*>(xb + rl * 128);
        xr[j][1] = *reinterpret_cast<const uint32_t*>(xb + (rl + 8) * 128);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(x_empty);

      float gacc[64];
#pragma unroll
      for (int k = 0; k < 64; ++k) gacc[k] = 0.f;
      const bf16 zero = __float2bfloat16_rn(0.f);
      bf16 xa = ra < rows ? x0[ra * m] : zero;
      bf16 xb = rb < rows ? x0[rb * m] : zero;
      for (int i = 0; i < m; ++i) {
        bf16 na = zero, nb = zero;  // the next field's x0, loaded ahead
        if (i + 1 < m) {
          if (ra < rows) na = x0[ra * m + i + 1];
          if (rb < rows) nb = x0[rb * m + i + 1];
        }
        if (hb == 0 && t == 0) {  // x0^T: 16 consecutive rows a warp, 32 bytes
          if (ra < rows) x0t[i * rows8 + ra] = xa;
          if (rb < rows) x0t[i * rows8 + rb] = xb;
        }
        // t1_i for the warpgroup's 64 rows: its K tiles in windows of at most
        // `window` (one when NKT > 0), a window's stages waited for together,
        // its products issued unbroken and its stages released once they
        // retire. The warpgroups take turns, a window a turn, so both release
        // a window before the ring must refill it
        float acc[64];
#pragma unroll
        for (int c = 0; c < 64; ++c) acc[c] = 0.f;
        for (int k0 = 0; k0 < nkt; k0 += window, ++turn) {
          const int k1 = k0 + window < nkt ? k0 + window : nkt;
          if (wg == 1) bar_sync(kOrder1, kConsumers);
          else if (turn > 0) bar_sync(kOrder0, kConsumers);
#pragma unroll
          for (int kt = k0; kt < k1; ++kt) mbar_wait(&full[(it + kt) % stages], ((it + kt) / stages) & 1);
          wgmma_fence();
#pragma unroll
          for (int kt = k0; kt < k1; ++kt) {
            const unsigned char* st = smem + L.ring + (size_t)((it + kt) % stages) * L.stage_bytes;
            const unsigned char* gt = g_resident ? smem + L.g + kt * kBox : st + kBox;
            const uint64_t da = desc_k128(gt + wg * kHalfBox), db = desc_k128(st);
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) Wgmma<128>::ss(acc, da + 2 * ks, db + 2 * ks, 1);
          }
          wgmma_commit();
          bar_arrive(wg == 0 ? kOrder1 : kOrder0, kConsumers);
          wgmma_wait<0>();
          fence_regs(acc);
          if (lane == 0) {
            for (int kt = k0; kt < k1; ++kt) mbar_arrive(&empty[(it + kt) % stages]);
          }
        }
        it += nkt;
        // the fold: gxk += bf16(t1) * x0[r, i]; q = sum_h bf16(bf16(t1) * xk).
        // The bf16x2 products lie as mma.m16n8k16's A fragments (k block kb:
        // j = 2 kb, 2 kb + 1), so q's row sums are one product with a B of
        // ones on the tensor cores, summed in f32
        const float fxa = __bfloat162float(xa), fxb = __bfloat162float(xb);
        float qd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kb = 0; kb < 8; ++kb) {
          uint32_t qa_frag[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kb + jj;
            const uint32_t ta = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
            const uint32_t tb = pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
            const float2 fa = unpack_bf16x2(ta), fb = unpack_bf16x2(tb);
            gacc[4 * j] = fmaf(fa.x, fxa, gacc[4 * j]);
            gacc[4 * j + 1] = fmaf(fa.y, fxa, gacc[4 * j + 1]);
            gacc[4 * j + 2] = fmaf(fb.x, fxb, gacc[4 * j + 2]);
            gacc[4 * j + 3] = fmaf(fb.y, fxb, gacc[4 * j + 3]);
            const __nv_bfloat162 pa = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&ta),
                                              *reinterpret_cast<const __nv_bfloat162*>(&xr[j][0]));
            const __nv_bfloat162 pb = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&tb),
                                              *reinterpret_cast<const __nv_bfloat162*>(&xr[j][1]));
            qa_frag[2 * jj] = *reinterpret_cast<const uint32_t*>(&pa);
            qa_frag[2 * jj + 1] = *reinterpret_cast<const uint32_t*>(&pb);
          }
          mma_bf16(qd, qa_frag, kOnes, kOnes);
        }
        if (t == 0) {  // one writer per (row, i): the same lane in every h block
          float* pa = sp + rl * m + i;
          float* pb = sp + (rl + 8) * m + i;
          if (hb == 0) {
            *pa = qd[0];
            *pb = qd[2];
          } else {
            *pa += qd[0];
            *pb += qd[2];
          }
        }
        xa = na;
        xb = nb;
      }
      // every product of the tile has retired: g's tiles are the producer's
      if (L.g_resident && hb == L.nhb - 1 && lane == 0) mbar_arrive(g_empty);
      // this h block of gxk
      const int h0 = hb * 128;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = h0 + 8 * j + 2 * t;
        if (col >= hk) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long r = half ? rb : ra;
          if (r >= rows) continue;
          bf16* dst = gxk + r * hk + col;
          const float v0 = gacc[4 * j + 2 * half], v1 = gacc[4 * j + 2 * half + 1];
          if ((hk & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
          } else {
            dst[0] = __float2bfloat16_rn(v0);
            if (col + 1 < hk) dst[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
    // gx0 of the warpgroup's 64 rows, contiguous in gx0
    bar_sync(kWgSync + wg, 128);
    const long long w0 = (long long)tile * kTileRows + wg * 64;
    const int tw = tid & 127;
    for (int idx = tw; idx < 64 * m; idx += 128) {
      if (w0 + idx / m < rows) gx0[w0 * m + idx] = __float2bfloat16_rn(sp[wg * 64 * m + idx]);
    }
    bar_sync(kWgSync + wg, 128);  // the partials are free for the next tile
  }
  if (wg == 0 && turn > 0) bar_sync(kOrder0, kConsumers);  // warpgroup 1's last turn
}

// -------------------------------------------------------------------- gw
// Partial of slice s for field i, h block hb, n block nb:
//   part[s][h][i*hn + n] = sum_{r in s} bf16(xk[r, h] * x0[r, i]) * g[r, n]
// Block = (field pair, h block, n block, slice), field pair fastest;
// warpgroup w takes field 2 * pair + w over the block's 128 h x 128 n.
struct GwArgs {
  float* part;
  int hk, m, hn, pairs, nhb, nnb, slices, kt_total;
};

__global__ void __launch_bounds__(kThreads, 1)
    cin_bwd_gw_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mg,
                      const __grid_constant__ CUtensorMap mx0, const GwArgs A) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGwStages * kGwStage);
  uint64_t* empty = full + kGwStages;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int b = blockIdx.x;
  const int pair = b % A.pairs;
  b /= A.pairs;
  const int nb = b % A.nnb;
  b /= A.nnb;
  const int hb = b % A.nhb;
  const int slice = b / A.nhb;
  const int kt_begin = (int)((long long)slice * A.kt_total / A.slices);
  const int kt_end = (int)((long long)(slice + 1) * A.kt_total / A.slices);
  if (tid == 0) {
    for (int s = 0; s < kGwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // producer: xk's and g's K tiles of 64 rows
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int n = kt - kt_begin;
        const int s = n % kGwStages;
        unsigned char* st = smem + s * kGwStage;
        mbar_wait(&empty[s], ((n / kGwStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kGwX0 + 2 * 64 * 2);
        tma_load_2d(st, &mx, &full[s], hb * 128, kt * 64);
        tma_load_2d(st + kHalfBox, &mx, &full[s], hb * 128 + 64, kt * 64);
        tma_load_2d(st + 2 * kHalfBox, &mg, &full[s], nb * 128, kt * 64);
        tma_load_2d(st + 3 * kHalfBox, &mg, &full[s], nb * 128 + 64, kt * 64);
        tma_load_2d(st + kGwX0, &mx0, &full[s], kt * 64, 2 * pair);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int w4 = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int i = 2 * pair + wg;
  // an odd m leaves the last pair's second field empty: that warpgroup runs
  // on TMA's zero fill (no branch around the products) and stores nothing
  const bool live = i < A.m;
  float acc[2][64];
#pragma unroll
  for (int k = 0; k < 64; ++k) acc[0][k] = acc[1][k] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int n = kt - kt_begin;
    const int s = n % kGwStages;
    const unsigned char* st = smem + s * kGwStage;
    mbar_wait(&full[s], (n / kGwStages) & 1);
    // x0[r, i] for rows 16 ks + 2 t + {0, 1, 8, 9} of the K tile, as bf16x2
    const bf16* xo = reinterpret_cast<const bf16*>(st + kGwX0) + wg * 64 + 2 * t;
    __nv_bfloat162 xs[4][2];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      xs[ks][0] = *reinterpret_cast<const __nv_bfloat162*>(xo + ks * 16);
      xs[ks][1] = *reinterpret_cast<const __nv_bfloat162*>(xo + ks * 16 + 8);
    }
    // z_i^T's fragments: A[h][r] = bf16(xk[r, h] * x0[r, i]), formed while
    // the other warpgroup's products run
    uint32_t a[2][4][4];
#pragma unroll
    for (int mh = 0; mh < 2; ++mh) {
      const bf16* xt = reinterpret_cast<const bf16*>(st + mh * kHalfBox);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        load_a_trans_sw128(a[mh][ks], xt, w4 * 16, ks * 16, lane);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 z = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a[mh][ks][q]),
                                           xs[ks][q >> 1]);
          a[mh][ks][q] = *reinterpret_cast<const uint32_t*>(&z);
        }
      }
    }
    // the warpgroups issue in turn
    if (wg == 1) bar_sync(kOrder1, kConsumers);
    else if (n > 0) bar_sync(kOrder0, kConsumers);
    const uint64_t bd = desc_mn128(st + 2 * kHalfBox, kHalfBox);
    wgmma_fence();
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_rs_n128_mn(acc[mh], a[mh][ks], bd + 128 * ks, 1);
    wgmma_commit();
    bar_arrive(wg == 0 ? kOrder1 : kOrder0, kConsumers);
    // the A fragments are read after issue: retire the group before the
    // next K tile's are formed
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (wg == 0 && kt_end > kt_begin) bar_sync(kOrder0, kConsumers);  // warpgroup 1's last turn
  if (!live) return;
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  const long long ld = (long long)A.m * A.hn;
  float* out = A.part + (long long)slice * A.hk * ld + (long long)i * A.hn;
#pragma unroll
  for (int mh = 0; mh < 2; ++mh) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int h = hb * 128 + mh * 64 + w4 * 16 + g + 8 * half;
      if (h >= A.hk) continue;
      float* row = out + h * ld;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = nb * 128 + 8 * j + 2 * t;
        const float v0 = acc[mh][4 * j + 2 * half], v1 = acc[mh][4 * j + 2 * half + 1];
        if (col + 1 < A.hn && (A.hn & 1) == 0) {
          *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
        } else {
          if (col < A.hn) row[col] = v0;
          if (col + 1 < A.hn) row[col + 1] = v1;
        }
      }
    }
  }
}

__global__ void cin_bwd_gw_sum_kernel(const float* __restrict__ part, bf16* __restrict__ gw,
                                      long long e_total, int slices) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= e_total) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += part[k * e_total + e];
  gw[e] = __float2bfloat16_rn(s);
}

// ------------------------------------------------------------------ plan
struct Plan {
  int stages, tiles, pairs, nhb, nnb, slices, kt_total;
  long long rows8;  // row pitch of x0^T
  size_t part, x0t, total;
  TmaRows g, x, w;  // the inputs as TMA reads them (cin2_common.cuh)
};

// -1 if the kernels do not take these sizes
int plan(Plan* P, int sms, const void* g, const void* xk, const void* w2, long long rows, int hk,
         int m, int hn) {
  if (rows < 0 || hk < 1 || m < 1 || hn < 1) return -1;
  P->stages = rows_stages(hk, m, hn);
  if (P->stages == 0) return -1;
  P->tiles = (int)((rows + kTileRows - 1) / kTileRows);
  P->pairs = (m + 1) / 2;
  P->nhb = (hk + 127) / 128;
  P->nnb = (hn + 127) / 128;
  P->kt_total = (int)((rows + 63) / 64);
  const long long blocks = (long long)P->pairs * P->nhb * P->nnb;
  long long s = sms / blocks;
  s = s < 1 ? 1 : s;
  s = s > P->kt_total ? P->kt_total : s;
  P->slices = (int)(s < 1 ? 1 : s);
  if (blocks * P->slices > 0x7fffffffLL || rows > 0x7fffffffLL - kTileRows) return -1;
  P->rows8 = (rows + 7) / 8 * 8;
  if (P->rows8 * m >= (1LL << 31)) return -1;
  Scratch S;
  P->part = S.take((size_t)P->slices * hk * m * hn * 4);
  P->x0t = S.take((size_t)m * P->rows8 * 2);
  P->g = S.rows(g, rows, hn);
  P->x = S.rows(xk, rows, hk);
  P->w = S.rows(w2, (long long)hk * m, hn);
  P->total = S.total;
  return 0;
}

template <int NKT>
int rows_launch(const CUtensorMap& mg, const CUtensorMap& mx, const CUtensorMap& mw, const void* x0,
                void* gxk, void* gx0, bf16* x0t, long long rows, int hk, int m, int hn, const Plan& P,
                const RowsLayout& L, int grid, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(cin_bwd_rows_kernel<NKT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  cin_bwd_rows_kernel<NKT><<<grid, kThreads, L.total, st>>>(mg, mx, mw, (const bf16*)x0, (bf16*)gxk,
                                                            (bf16*)gx0, x0t, P.rows8, rows, hk, m, hn,
                                                            P.stages, P.tiles);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rm

using namespace rm;

// Scratch bytes rm_cin_layer_backward needs for these inputs (the gw
// partials, and padded copies of inputs TMA cannot read as they lie), or -1
// when the kernels do not take these sizes.
extern "C" long long rm_cin_layer_backward_scratch(int device, const void* g, const void* xk,
                                                   const void* w2, long long rows, int hk, int m,
                                                   int hn) {
  int sms = 0;
  Plan P;
  if (multiprocessors(device, &sms) || plan(&P, sms, g, xk, w2, rows, hk, m, hn)) return -1;
  return (long long)P.total;
}

// g [rows, hn], xk [rows, hk], x0 [rows, m], w2 [hk, m*hn], all bf16
// row-major -> gxk [rows, hk], gx0 [rows, m], gw [hk, m*hn] bf16; scratch of
// rm_cin_layer_backward_scratch bytes, 1024-byte aligned.
extern "C" int rm_cin_layer_backward(int device, const void* g, const void* xk, const void* x0,
                                     const void* w2, void* gxk, void* gx0, void* gw,
                                     void* scratch, long long rows, int hk, int m, int hn,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  int e = multiprocessors(device, &sms);
  if (e) return e;
  Plan P;
  if (plan(&P, sms, g, xk, w2, rows, hk, m, hn)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long e_total = (long long)hk * m * hn;
  if (rows == 0) return (int)cudaMemsetAsync(gw, 0, e_total * sizeof(bf16), st);
  unsigned char* base = (unsigned char*)scratch;
  float* part = (float*)(base + P.part);
  // x0^T [m][rows8], the gw kernel's per-row scales by TMA (the rows kernel
  // writes it)
  bf16* x0t = (bf16*)(base + P.x0t);
  // inputs as TMA reads them: rows of 16-byte multiples at 16-byte bases
  const TmaRows ins[3] = {P.g, P.x, P.w};
  if ((e = tma_copy(ins, 3, base, st))) return e;
  const bf16* gt = P.g.at(base);
  const bf16* xt = P.x.at(base);
  const bf16* wt = P.w.at(base);
  const long long g_pitch = P.g.pitch, x_pitch = P.x.pitch, w_pitch = P.w.pitch;
  CUtensorMap mg_rows, mx_rows, mw, mx_gw, mg_gw, mx0;
  if ((e = make_map_bf16(&mg_rows, gt, hn, rows, g_pitch, 128))) return e;
  if ((e = make_map_bf16(&mx_rows, xt, hk, rows, x_pitch, 128))) return e;
  if ((e = make_map_bf16_3d(&mw, wt, hn, m, hk, w_pitch, (long long)m * w_pitch, 1, 128))) return e;
  if ((e = make_map_bf16(&mx_gw, xt, hk, rows, x_pitch, 64))) return e;
  if ((e = make_map_bf16(&mg_gw, gt, hn, rows, g_pitch, 64))) return e;
  if ((e = make_map_bf16(&mx0, x0t, rows, m, P.rows8, 2, 64, false))) return e;

  const RowsLayout L = rows_layout(hk, m, hn, P.stages);
  const int grid = P.tiles < sms ? P.tiles : sms;
  const bool one_window = L.g_resident && P.stages >= L.nkt;
  switch (one_window ? L.nkt : 0) {
    case 1: e = rows_launch<1>(mg_rows, mx_rows, mw, x0, gxk, gx0, x0t, rows, hk, m, hn, P, L, grid, st); break;
    case 2: e = rows_launch<2>(mg_rows, mx_rows, mw, x0, gxk, gx0, x0t, rows, hk, m, hn, P, L, grid, st); break;
    case 3: e = rows_launch<3>(mg_rows, mx_rows, mw, x0, gxk, gx0, x0t, rows, hk, m, hn, P, L, grid, st); break;
    case 4: e = rows_launch<4>(mg_rows, mx_rows, mw, x0, gxk, gx0, x0t, rows, hk, m, hn, P, L, grid, st); break;
    default: e = rows_launch<0>(mg_rows, mx_rows, mw, x0, gxk, gx0, x0t, rows, hk, m, hn, P, L, grid, st);
  }
  if (e) return e;

  const size_t smem_gw = 1024 + kGwStages * (size_t)kGwStage + 2 * kGwStages * 8;
  err = cudaFuncSetAttribute(cin_bwd_gw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_gw);
  if (err != cudaSuccess) return (int)err;
  const GwArgs A = {part, hk, m, hn, P.pairs, P.nhb, P.nnb, P.slices, P.kt_total};
  const unsigned gw_blocks = (unsigned)((long long)P.pairs * P.nhb * P.nnb * P.slices);
  cin_bwd_gw_kernel<<<gw_blocks, kThreads, smem_gw, st>>>(mx_gw, mg_gw, mx0, A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cin_bwd_gw_sum_kernel<<<(unsigned)((e_total + 255) / 256), 256, 0, st>>>(part, (bf16*)gw, e_total,
                                                                          P.slices);
  return (int)cudaGetLastError();
}
