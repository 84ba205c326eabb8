// One generic CIN layer, forward (xDeepFM), on flat (b, d) rows.
//
// Replaces: recmodels_tpu/ops/pallas/interactions_tpu.py::_cin_forward_2d
// (its _cin_kernel). Rows r = (b, d): xk [R, Hk], x0 [R, m] and the flat
// weight w2 [Hk, m*Hn] (column i*Hn + n = w[n, h, i]) give out [R, Hn]:
//   out[r, n] = sum_i x0[r, i] * sum_h xk[r, h] * w2[h, i*Hn + n]
// in bf16 or f32 (every tensor of one type).
//
// Bound on this card: operations, 2 * R * Hk * m * Hn. At the training shape
// (R = 262,144, m = 26, Hn = 128) that is 223 GFLOP for Hk = 128 and 45 GFLOP
// for Hk = 26, against 67-93 MB of input and output: over the tensor cores'
// 989 TFLOP/s in bf16, over the 67 TFLOP/s of FFMA in f32 (no TF32: the
// reference is full f32).
//
// bf16. t_i[r, n] = sum_h xk[r, h] * w2[h, i*Hn + n] in f32, never rounded,
// then out = cast(sum_i t_i * x0[:, i]) (an f32 fold in field order, one
// cast): the pair products xk * x0 are never formed, so nothing rounds
// before the final cast. The TPU kernel forms t as one [TR, m*Hn] MXU
// product in VMEM and folds it lane-slice by lane-slice.
//
// What held the previous design back (mma.sync; layer 2 1.1086 ms, layer 1
// 0.5584 ms warm on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md): one
// 128 x 128 block an SM; every warp read its whole [128 h x 64 n] half of
// field i's w2 slice from shared memory as B fragments, for every field, so
// shared memory and not the tensor cores set the pace; one cp.async wait
// and one barrier a field, with one slice in flight; and the fold ran on
// all eight warps at once while the tensor cores idled. At layer 1 (Hk =
// 26) a field was two k-steps against a barrier, a wait and a 32 KB copy.
//
// This design: one GEMM per item (a 128-row tile, a 128-wide n block) whose
// N blocks are the fields, folded in its epilogue, as the backward's rows
// kernel (cin_layer_bwd.cu). Persistent blocks of a producer warpgroup (one
// thread issues the copies; setmaxnreg hands its registers to the
// consumers) and two consumer warpgroups of 64 rows walk the items. The
// producer loads an item's xk rows once (TMA, K-major as they lie; two
// buffers, so the next item's rows land while this one multiplies) and
// streams w2 as [kb h x 64 n] boxes of a 3-D map [h][i][n] (a box stops at
// its field's edge) through a ring of up to eight stages that runs ahead
// across fields and items. A step takes two fields: four boxes, MN-major
// (K = h down the rows), that wgmma m64n256k16 reads with the transpose-B
// bit into one accumulator holding t_i and t_{i+1}, both operands from
// shared memory, started with scale-d 0. The fold acc += t_i * x0[r, i],
// then t_{i+1}, takes the thread's two rows' x0, loaded a step ahead from
// device memory. The two warpgroups take turns issuing (two named
// barriers), so one's products run while the other folds. At Hk <= 32
// (layer 1: Hk = m = 26) a box has 32 h rows and a step two K slices, not
// four. A step's K tiles go in windows of at most the ring's depth, one
// window a turn, so no step waits for more K tiles than the ring holds (Hk
// > 256 streams xk's K tiles through the ring beside w2's); where the ring
// holds a step, a template instance per K-tile count unrolls the loop
// (ptxas serialises the wgmma of a loop it cannot unroll). Ragged R, Hk and
// Hn read TMA's zero fill and mask the stores. Inputs TMA cannot read as
// they lie (xk at Hk % 8 != 0, as layer 1's 52-byte rows; w2 at Hn % 8 !=
// 0, as CIN(100,100); a base off 16 bytes) are first copied by one
// re-layout launch into scratch with padded rows (cin2_common.cuh); the
// kernel is the same. No atomics: a run repeats bit for bit.
//
// What the measurements chose (chip runs on an NVIDIA H100 80GB HBM3 at
// 700.00 W, PERF.md): one field a step, turns as above, 0.4420 ms at layer
// 2 and 0.2857 at layer 1; a second accumulator set issued a field ahead,
// or t copied out of the accumulator so the next field could issue before
// the fold, made ptxas serialise the products (C7514, C7515) or cost 64
// moves a field (0.39, 0.25 ms); two fields a step, 0.34, 0.21 ms. Passing
// the turn only after a warpgroup's products retire was slower (0.42,
// 0.25); w2's stream switched off moved it by 1-5%. With the fold switched
// off layer 1 takes about half the time (0.12 ms): there the turns do not
// hide the fold.
//
// Measured the same way (chip_smoke.py, parent and change in turn): layer
// 2 0.3480, 0.3469 ms by launch (the mma.sync kernel 1.0943, 1.0956), 1.5x
// its 0.2258 ms bound; layer 1 0.2158, 0.2181 plus a 0.0122 ms re-layout
// (0.5700, 0.5699), 4.8x its 0.0459 ms bound.
//
// f32. One product with K = m * Hk and one accumulator:
//   A[r, (i, h)] = xk[r, h] * x0[r, i],   B[(i, h), n] = w2[h, i*Hn + n].
// Each pair product is rounded once to f32 before it is summed (a few ulps
// of each term against the t-then-fold order, far inside the 1e-4 of
// max |out| that the checks allow). A block takes 128 rows x 128 columns,
// 16 x 16 threads of 8 x 8 outputs, and walks K in tiles of 16; a tile may
// span two fields, so Hk = 26 pads no lanes. What held the earlier FFMA
// kernel (4 x 4 outputs a thread, 64 x 64 a block) back, and what this one
// does about it:
//  - shared-memory bandwidth: 16 FFMA per five shared loads. Here 64 FFMA
//    per four 16-byte loads: A and B are k-major in shared memory, a thread
//    takes rows ty*4 and 64 + ty*4 and columns tx*4 and 64 + tx*4, so its
//    float4 loads are broadcasts (A) or hit 32 banks (B).
//  - stalls on device memory: every stage read w2 with scalar loads between
//    two barriers. Here w2's k-tiles come by cp.async into a ring of three
//    stages, issued two tiles ahead; the block's xk rows are staged once per
//    64 of Hk, transposed, and the scaled A tile of the next k-tile is
//    written into the second of two buffers while this one multiplies (one
//    barrier a tile; the scaling is 1/128 of the FFMA work, and x0[r, i] is
//    loaded once a field).
//  - L2 traffic: every block reads its column block of w2 whole, so 128 rows
//    a block instead of 64 halves it (2,048 blocks x 1.7 MB at layer 2).
// Ragged R, Hk, Hn and any m are zero-filled at the tile edges and masked
// at the store; w2 rows that are not 16-byte aligned (Hn % 4 != 0) are
// copied by scalar loads and the output then stored by scalars. No atomics
// and a fixed order: a run repeats bit for bit.

#include "cin2_common.cuh"

namespace rm {
namespace {

// bf16: two consumer warpgroups and a producer warpgroup (one thread of it
// issues the copies), which gives its registers up to the consumers
constexpr int kFwdThreads = kConsumers + 128;
constexpr int kFwdProducerRegs = 40, kFwdConsumerRegs = 232;
constexpr int kATile = 128 * 128;  // bytes of xk's K tile: [128 rows][64 h]
constexpr int kAHalf = 64 * 128;   // a consumer warpgroup's 64 rows of it
constexpr int kAResident = 4;      // K tiles of xk an item holds: Hk <= 256
constexpr int kMaxStages = 8;
constexpr int kOrder0 = 2, kOrder1 = 3;  // named barriers (0: __syncthreads)
constexpr long long kChunkRows = 1LL << 30;  // rows a launch takes: TMA's coordinates are 32-bit

struct FwdLayout {
  int nkt;          // K tiles of 64 h
  int kb;           // h rows of a w2 box: 32 at Hk <= 32, else 64
  int stage_bytes;  // four w2 boxes [kb h][64 n] (two fields), and xk's K tile when it streams
  int stages;
  bool a_resident;  // xk's K tiles held for the item, in two buffers
  size_t a, ring, bars, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int hk, int stages) {
  FwdLayout L;
  L.nkt = (hk + 63) / 64;
  L.kb = hk <= 32 ? 32 : 64;
  L.a_resident = L.nkt <= kAResident;
  L.stage_bytes = 4 * L.kb * 128 + (L.a_resident ? 0 : kATile);
  L.stages = stages;
  L.a = 0;
  L.ring = L.a + (L.a_resident ? 2 * (size_t)L.nkt * kATile : 0);
  L.bars = L.ring + (size_t)stages * L.stage_bytes;
  L.total = 1024 + L.bars + (2 * (size_t)stages + 4) * 8;
  return L;
}

// the deepest ring, up to 8 stages, that fits (3 at the least, at any Hk)
int fwd_stages(int hk) {
  int s = kMaxStages;
  while (s > 2 && fwd_layout(hk, s).total > kMaxSmem) --s;
  return s;
}

// Out's bf16 values of one item's rows ra, ra + 8 from the f32 fold,
// masked at ragged R and Hn.
__device__ __forceinline__ void store_rows(const float (&acc)[64], bf16* __restrict__ out, long long ra,
                                           long long rows, int n0, int hn, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= hn) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long r = ra + 8 * half;
      if (r >= rows) continue;
      bf16* dst = out + r * hn + col;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if ((hn & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16_rn(v0);
        if (col + 1 < hn) dst[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// x0[r, i] for the thread's two rows (0 past the rows or the fields).
struct X0Pair {
  bf16 a, b;
};

__device__ __forceinline__ X0Pair load_x0(const bf16* __restrict__ x0, long long ra, long long rows, int m,
                                          int i) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  X0Pair x{zero, zero};
  if (i < m) {
    if (ra < rows) x.a = x0[ra * m + i];
    if (ra + 8 < rows) x.b = x0[(ra + 8) * m + i];
  }
  return x;
}

// Items (128-row tile, 128-wide n block), n block fastest. A step is two
// fields i, i + 1: one product of N = 256 whose accumulator holds t_i and
// t_{i+1} side by side (an odd m's last step has a second field of zeros
// or an old box, folded with x0 = 0). NKT > 0 (Hk <= 192): xk held and a
// step one window of NKT K tiles of KS slices each, so the K loop unrolls;
// 0 (Hk > 192, where the ring holds fewer stages than a step has K tiles;
// past 256 xk's K tiles stream with w2's): a step in windows of at most
// `stages` K tiles (ptxas serialises the wgmma of a loop it cannot unroll,
// so only these shapes take NKT = 0).
template <int NKT, int KS>
__global__ void __launch_bounds__(kFwdThreads, 1)
    cin_layer_bf16_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                          const bf16* __restrict__ x0, bf16* __restrict__ out, long long rows, int hk, int m,
                          int hn, int stages, long long items, int nnb) {
  extern __shared__ __align__(1024) unsigned char smem_fwd[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_fwd + 1023) & ~(uintptr_t)1023);
  const FwdLayout L = fwd_layout(hk, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  uint64_t* a_full = empty + stages;  // one per xk buffer
  uint64_t* a_empty = a_full + 2;
  const int box = L.kb * 128;  // bytes of one w2 box
  const int steps = (m + 1) / 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&a_full[b], 1);
      mbar_init(&a_empty[b], kConsumers / 32);
    }
    mbar_fence_init();
  }
  if (m & 1) {  // an odd m's last step reads its second field from an old box or zeros: finite
    for (int o = tid * 16; o < stages * L.stage_bytes; o += kFwdThreads * 16)
      *reinterpret_cast<uint4*>(smem + L.ring + o) = make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // producer: per item xk, per step two fields' w2
    setmaxnreg_dec<kFwdProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      int it = 0, nt = 0;
      for (long long item = blockIdx.x; item < items; item += gridDim.x, ++nt) {
        const int row0 = (int)(item / nnb) * kTileRows;
        const int n0 = (int)(item % nnb) * 128;
        const int halves = n0 + 64 < hn ? 2 : 1;  // boxes of 64 n a field that hold columns of out
        if (L.a_resident) {
          const int b = nt & 1;
          mbar_wait(&a_empty[b], ((nt >> 1) & 1) ^ 1);
          mbar_expect_tx(&a_full[b], L.nkt * kATile);
          for (int kt = 0; kt < L.nkt; ++kt)
            tma_load_2d(smem + L.a + (size_t)(b * L.nkt + kt) * kATile, &mx, &a_full[b], kt * 64, row0);
        }
        for (int i = 0; i < m; i += 2) {
          const int fields = i + 1 < m ? 2 : 1;
          for (int kt = 0; kt < L.nkt; ++kt, ++it) {
            const int s = it % stages;
            unsigned char* st = smem + L.ring + (size_t)s * L.stage_bytes;
            mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
            mbar_expect_tx(&full[s], fields * halves * box + (L.a_resident ? 0 : kATile));
            for (int f = 0; f < fields; ++f)
              for (int h = 0; h < halves; ++h)
                tma_load_3d(st + (2 * f + h) * box, &mw, &full[s], n0 + 64 * h, i + f, kt * 64);
            if (!L.a_resident) tma_load_2d(st + 4 * box, &mx, &full[s], kt * 64, row0);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kFwdConsumerRegs>();
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rl = wg * 64 + (warp & 3) * 16 + g;  // tile rows rl, rl + 8 of this thread
  const int nkt = NKT ? NKT : L.nkt;
  const int window = NKT ? NKT : stages;
  float acc[64];
  float tt[128];  // t_i, t_{i+1}; a step's first K slice overwrites it (scale-d 0)
  int it = 0, nt = 0, turn = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x, ++nt) {
    const long long ra = (item / nnb) * kTileRows + rl;
    const int b = nt & 1;
    const unsigned char* at = smem + L.a + (size_t)b * L.nkt * kATile;
    if (L.a_resident) mbar_wait(&a_full[b], (nt >> 1) & 1);
#pragma unroll
    for (int c = 0; c < 64; ++c) acc[c] = 0.f;
    X0Pair x_i = load_x0(x0, ra, rows, m, 0), x_j = load_x0(x0, ra, rows, m, 1);
    for (int step = 0; step < steps; ++step) {
      // the next step's x0, loaded ahead
      const X0Pair n_i = load_x0(x0, ra, rows, m, 2 * step + 2);
      const X0Pair n_j = load_x0(x0, ra, rows, m, 2 * step + 3);
      // the step's products for the warpgroup's 64 rows: its K tiles in
      // windows of at most `window` (one when NKT > 0), a window's stages
      // waited for together, its products issued unbroken and its stages
      // released once they retire. The warpgroups take turns, a window a
      // turn, so one folds while the other's products run, and both release
      // a window before the ring must refill it
      for (int k0 = 0; k0 < nkt; k0 += window, ++turn) {
        const int k1 = k0 + window < nkt ? k0 + window : nkt;
        if (wg == 1) bar_sync(kOrder1, kConsumers);
        else if (turn > 0) bar_sync(kOrder0, kConsumers);
#pragma unroll
        for (int kt = k0; kt < k1; ++kt) mbar_wait(&full[(it + kt) % stages], ((it + kt) / stages) & 1);
        fence_regs(tt);
        wgmma_fence();
#pragma unroll
        for (int kt = k0; kt < k1; ++kt) {
          const unsigned char* st = smem + L.ring + (size_t)((it + kt) % stages) * L.stage_bytes;
          const unsigned char* a = L.a_resident ? at + kt * kATile : st + 4 * box;
          const uint64_t da = desc_k128(a + wg * kAHalf), db = desc_mn128(st, box);
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) wgmma_ss_n256_mn(tt, da + 2 * ks, db + 128 * ks, kt | ks);
        }
        wgmma_commit();
        bar_arrive(wg == 0 ? kOrder1 : kOrder0, kConsumers);
        wgmma_wait<0>();
        fence_regs(tt);
        if (lane == 0) {
          for (int kt = k0; kt < k1; ++kt) mbar_arrive(&empty[(it + kt) % stages]);
        }
      }
      it += nkt;
      // the fold, in f32 and field order: acc += t_i * x0[r, i], then t_{i+1}
      const float fa = __bfloat162float(x_i.a), fb = __bfloat162float(x_i.b);
      const float ga = __bfloat162float(x_j.a), gb = __bfloat162float(x_j.b);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[4 * j] = fmaf(tt[4 * j], fa, acc[4 * j]);
        acc[4 * j + 1] = fmaf(tt[4 * j + 1], fa, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(tt[4 * j + 2], fb, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(tt[4 * j + 3], fb, acc[4 * j + 3]);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[4 * j] = fmaf(tt[64 + 4 * j], ga, acc[4 * j]);
        acc[4 * j + 1] = fmaf(tt[64 + 4 * j + 1], ga, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(tt[64 + 4 * j + 2], gb, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(tt[64 + 4 * j + 3], gb, acc[4 * j + 3]);
      }
      x_i = n_i;
      x_j = n_j;
    }
    // every product of the item has retired: xk's buffer is the producer's
    if (L.a_resident && lane == 0) mbar_arrive(&a_empty[b]);
    store_rows(acc, out, ra, rows, (int)(item % nnb) * 128, hn, t);
  }
  if (wg == 0 && turn > 0) bar_sync(kOrder0, kConsumers);  // warpgroup 1's last turn
}

struct FwdPlan {
  int stages;
  long long chunk;  // rows a launch takes
  TmaRows x, w;     // a chunk's xk and w2 as TMA reads them (cin2_common.cuh)
  size_t total;     // scratch bytes: the padded copies
};

void fwd_plan(FwdPlan* P, const void* xk, const void* w2, long long rows, int hk, int m, int hn) {
  P->stages = fwd_stages(hk);
  P->chunk = rows < kChunkRows ? rows : kChunkRows;
  Scratch S;
  P->w = S.rows(w2, (long long)hk * m, hn);
  P->x = S.rows(xk, P->chunk, hk);
  P->total = S.total;
}

template <int NKT, int KS>
int fwd_launch(const CUtensorMap& mx, const CUtensorMap& mw, const bf16* x0, bf16* out, long long rows,
               int hk, int m, int hn, int stages, long long items, int nnb, int grid, size_t smem,
               cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(cin_layer_bf16_kernel<NKT, KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cin_layer_bf16_kernel<NKT, KS><<<grid, kFwdThreads, smem, st>>>(mx, mw, x0, out, rows, hk, m, hn, stages,
                                                                  items, nnb);
  return (int)cudaGetLastError();
}

int cin_layer_bf16(int device, const bf16* xk, const bf16* x0, const bf16* w2, bf16* out,
                   unsigned char* scratch, long long rows, int hk, int m, int hn, cudaStream_t st) {
  int sms = 0;
  int e = multiprocessors(device, &sms);
  if (e) return e;
  FwdPlan P;
  fwd_plan(&P, xk, w2, rows, hk, m, hn);
  const FwdLayout L = fwd_layout(hk, P.stages);
  const int nnb = (hn + 127) / 128;
  // where the ring holds a step (Hk <= 192): one window, unrolled
  const int key = L.a_resident && P.stages >= L.nkt ? L.nkt * 8 + L.kb / 16 : 0;
  for (long long r0 = 0; r0 < rows; r0 += P.chunk) {
    const long long n = rows - r0 < P.chunk ? rows - r0 : P.chunk;
    TmaRows ins[2] = {P.w, P.x};
    ins[0].copy = P.w.copy && r0 == 0;  // w2's copy serves every chunk
    ins[1].src = xk + r0 * hk;
    ins[1].outer = n;
    if ((e = tma_copy(ins, 2, scratch, st))) return e;
    CUtensorMap mx, mw;
    if ((e = make_map_bf16(&mx, ins[1].at(scratch), hk, n, P.x.pitch, 128))) return e;
    if ((e = make_map_bf16_3d(&mw, P.w.at(scratch), hn, m, hk, P.w.pitch, (long long)m * P.w.pitch, 1,
                              L.kb)))
      return e;
    const long long items = (n + kTileRows - 1) / kTileRows * nnb;
    const int grid = (int)(items < sms ? items : sms);
    const bf16* x0c = x0 + r0 * m;
    bf16* outc = out + r0 * hn;
#define RM_FWD(NKT, KS) \
  fwd_launch<NKT, KS>(mx, mw, x0c, outc, n, hk, m, hn, P.stages, items, nnb, grid, L.total, st)
    switch (key) {
      case 8 + 2: e = RM_FWD(1, 2); break;
      case 8 + 4: e = RM_FWD(1, 4); break;
      case 16 + 4: e = RM_FWD(2, 4); break;
      case 24 + 4: e = RM_FWD(3, 4); break;
      default: e = RM_FWD(0, 4);
    }
#undef RM_FWD
    if (e) return e;
  }
  return 0;
}

// f32: 128 rows x 128 columns per block, threads of kTmF x 8 outputs (16
// threads across), K in tiles of 16, xk^T staged per 64 of Hk (73 KB of
// shared memory a block: two blocks an SM leave 100 KB of L1 for x0)
constexpr int kBmF = 128;
constexpr int kBnF = 128;
constexpr int kBkF = 16;
constexpr int kKcF = 64;
constexpr int kTmF = 8;                         // rows a thread, in groups of 4
constexpr int kThreadsF = kBmF / kTmF * 16;
constexpr int kRowGapF = kBmF / (kTmF / 4);     // between a thread's groups of rows
constexpr int kLdXF = kBmF + 1;  // padded row of xk^T: the transposing stores hit 32 banks
constexpr int kStagesF = 3;      // the ring of w2 tiles
constexpr int kPerA = kBkF * kBmF / kThreadsF;  // a thread's share of an A tile: one row, kPerA k
constexpr size_t kSmemF32 =
    (size_t)(kKcF * kLdXF + 2 * kBkF * kBmF + kStagesF * kBkF * kBnF) * sizeof(float);

__global__ void __launch_bounds__(kThreadsF, 2)
    cin_layer_f32_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
                         const float* __restrict__ w2, float* __restrict__ out, long long rows,
                         int hk, int m, int hn) {
  extern __shared__ uint4 smem_raw[];
  float* sxt = reinterpret_cast<float*>(smem_raw);  // [kKcF][kLdXF]: the block's xk^T
  float* sa = sxt + kKcF * kLdXF;                   // [2][kBkF][kBmF]: scaled A tiles
  float* sb = sa + 2 * kBkF * kBmF;                 // [kStagesF][kBkF][kBnF]: w2 tiles
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)blockIdx.x * kBmF;
  const int n0 = blockIdx.y * kBnF;
  const int ncols = min(kBnF, hn - n0);
  const long long avail = rows - row0;
  const long long ld_w = (long long)m * hn;
  const bool vec_w = ((reinterpret_cast<uintptr_t>(w2) | (uintptr_t)hn * 4) & 15) == 0;
  // the thread's share of each A tile: row br, kPerA k from bkh * kPerA
  const int br = tid & (kBmF - 1), bkh = tid / kBmF;
  const bool live_row = br < avail;
  const float* x0r = x0 + (row0 + br) * m;

  float acc[kTmF][8];
#pragma unroll
  for (int u = 0; u < kTmF; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;

  for (int h0 = 0; h0 < hk; h0 += kKcF) {
    const int kwc = min(kKcF, hk - h0);
    const int ktot = m * kwc;  // this chunk's K: k = i * kwc + (h - h0)
    const int tiles = (ktot + kBkF - 1) / kBkF;

    // w2's rows for tile s into ring slot s % kStagesF; one commit group a
    // tile, empty past the last
    auto issue_b = [&](int s) {
      if (s < tiles) {
        float* dst = sb + (s % kStagesF) * (kBkF * kBnF);
#pragma unroll
        for (int q = 0; q < kBkF * kBnF / 4 / kThreadsF; ++q) {
          const int idx = tid + q * kThreadsF;
          const int kk = idx >> 5, c = (idx & 31) * 4;
          const int k = s * kBkF + kk;
          float* d = dst + kk * kBnF + c;
          if (k >= ktot) {
            *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
            continue;
          }
          const int i = k / kwc;
          const float* src = w2 + (long long)(h0 + k - i * kwc) * ld_w + (long long)i * hn + n0 + c;
          if (vec_w && c + 4 <= ncols) {
            rm::cp_async16(d, src);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) d[j] = c + j < ncols ? src[j] : 0.f;
          }
        }
      }
      rm::cp_async_commit();
    };
    // A tile s into buffer s & 1: A[k][r] = xk[r, h] * x0[r, i], rounded once
    int xi = -1;  // the field whose x0[br, xi] is in xcur
    float xcur = 0.f;
    auto build_a = [&](int s) {
      float* dst = sa + (s & 1) * (kBkF * kBmF) + bkh * kPerA * kBmF + br;
      const int k0 = s * kBkF + bkh * kPerA;
      int i = k0 / kwc, h = k0 - i * kwc;
      if (i != xi) {
        xi = i;
        xcur = live_row && i < m ? __ldg(x0r + i) : 0.f;
      }
      float xv = xcur;
#pragma unroll
      for (int kk = 0; kk < kPerA; ++kk) {
        dst[kk * kBmF] = i < m ? __fmul_rn(sxt[h * kLdXF + br], xv) : 0.f;
        if (++h == kwc) {
          h = 0;
          ++i;
          xv = live_row && i < m ? __ldg(x0r + i) : 0.f;
        }
      }
    };

    __syncthreads();  // the previous chunk's tiles are done with sxt, sa and sb
    for (int s = 0; s < kStagesF - 1; ++s) issue_b(s);
    // the chunk's xk^T, rows past R as 0; four loads in flight a thread
    const int n_el = kBmF * kwc;
    for (int base = tid; base < n_el; base += 4 * kThreadsF) {
      float v[4];
      int off[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = base + q * kThreadsF;
        const int r = idx / kwc, h = idx - r * kwc;
        off[q] = idx < n_el ? h * kLdXF + r : -1;
        v[q] = idx < n_el && r < avail ? __ldg(xk + (row0 + r) * hk + h0 + h) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (off[q] >= 0) sxt[off[q]] = v[q];
    }
    __syncthreads();
    build_a(0);
    for (int s = 0; s < tiles; ++s) {
      rm::cp_async_wait<kStagesF - 2>();
      __syncthreads();  // tile s's A and B are in place; every thread is done with tile s - 1
      issue_b(s + kStagesF - 1);
      if (s + 1 < tiles) build_a(s + 1);
      const float* at = sa + (s & 1) * (kBkF * kBmF);
      const float* bt = sb + (s % kStagesF) * (kBkF * kBnF);
#pragma unroll
      for (int k = 0; k < kBkF; ++k) {
        float a[kTmF];
#pragma unroll
        for (int q = 0; q < kTmF / 4; ++q) {
          const float4 av = *reinterpret_cast<const float4*>(at + k * kBmF + q * kRowGapF + ty * 4);
          a[4 * q] = av.x, a[4 * q + 1] = av.y, a[4 * q + 2] = av.z, a[4 * q + 3] = av.w;
        }
        const float4 b0 = *reinterpret_cast<const float4*>(bt + k * kBnF + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(bt + k * kBnF + 64 + tx * 4);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int u = 0; u < kTmF; ++u)
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
      }
    }
  }

  // rows (u / 4) * kRowGapF + ty*4 + u % 4, columns tx*4 and 64 + tx*4
  const bool vec_out = ((reinterpret_cast<uintptr_t>(out) | (uintptr_t)hn * 4) & 15) == 0;
#pragma unroll
  for (int u = 0; u < kTmF; ++u) {
    const int r = (u >> 2) * kRowGapF + ty * 4 + (u & 3);
    if (r >= avail) continue;
    float* dst = out + (row0 + r) * hn + n0;
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      const int c = hv * 64 + tx * 4;
      if (vec_out && c + 4 <= ncols) {
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(acc[u][hv * 4], acc[u][hv * 4 + 1], acc[u][hv * 4 + 2], acc[u][hv * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < ncols) dst[c + j] = acc[u][hv * 4 + j];
      }
    }
  }
}

}  // namespace
}  // namespace rm

using namespace rm;

// Scratch bytes rm_cin_layer_forward needs for these inputs (bf16: padded
// copies of the inputs TMA cannot read as they lie; f32: none), or -1 for
// sizes it does not take.
extern "C" long long rm_cin_layer_forward_scratch(const void* xk, const void* w2, long long rows,
                                                  int hk, int m, int hn, int is_bf16) {
  if (hk < 1 || m < 1 || hn < 1 || rows < 0) return -1;
  if (!is_bf16) return 0;
  FwdPlan P;
  fwd_plan(&P, xk, w2, rows, hk, m, hn);
  return (long long)P.total;
}

// xk [rows, hk], x0 [rows, m], w2 [hk, m*hn] row-major, all bf16 or all
// f32 -> out [rows, hn]; scratch of rm_cin_layer_forward_scratch bytes,
// 1024-byte aligned.
extern "C" int rm_cin_layer_forward(int device, const void* xk, const void* x0,
                                    const void* w2, void* out, void* scratch, long long rows,
                                    int hk, int m, int hn, int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hk < 1 || m < 1 || hn < 1 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    return cin_layer_bf16(device, (const bf16*)xk, (const bf16*)x0, (const bf16*)w2, (bf16*)out,
                          (unsigned char*)scratch, rows, hk, m, hn, st);
  }
  err = cudaFuncSetAttribute(cin_layer_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemF32);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((rows + kBmF - 1) / kBmF), (unsigned)((hn + kBnF - 1) / kBnF));
  cin_layer_f32_kernel<<<grid, kThreadsF, kSmemF32, st>>>(
      (const float*)xk, (const float*)x0, (const float*)w2, (float*)out, rows, hk, m, hn);
  return (int)cudaGetLastError();
}
