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
// product); Q's products are exact f32 products of bf16 values.
//
// Bound on this card: operations. At the serving shape (B = 16,384, D = 16,
// m = 26, h1 = h2 = 128) the three products are 22.7 + 0.9 + 7.0 GMAC, about
// 61 GFLOP (0.062 ms at 989 TFLOP/s), against 31 MB of input and 8 MB of
// pools.
//
// What held the previous design back (WMMA, PR 1; 1.06 ms): one block of 16
// warps per 16 examples and one block an SM; the pair operand built 32
// columns at a time by scalar loops into shared memory between barriers; the
// w1 fragments reloaded by every warp; and p2 as [16 examples, 3,328] x
// [3,328, 128] inside each block, every block streaming all of w2 (852 KB)
// from L2 as fragments in a 104-step chain at M = 16.
//
// This design, three launches on the caller's stream:
//  1. re-layout (cin2_permute): w1 as W1T [h1, m*32], K-major over the
//     padded pairs (cin2_common.cuh), w2 as W2T [h2, m*h1], K-major over
//     (j, k), and x0 as 64-byte row slots (x0_slot_job);
//  2. the layer-1 kernel: persistent blocks of two consumer warpgroups and
//     one producer warp walk tiles of 128 row slots (whole examples: each
//     example owns 16 or 32 slots, its D rows then zero rows). The producer
//     streams W1T by TMA in K tiles of 64 pairs through a 4-stage ring that
//     runs ahead across tiles, so one tile's epilogue overlaps the next
//     tile's loads. Each consumer warpgroup takes 64 slots and issues
//     wgmma m64nNk16 (N = h1 padded to 128 or 256) with the pair products
//     formed in registers in wgmma's A-fragment layout: a 16-pair slice
//     shares its field h, so a thread multiplies x0[r, h] by the eight
//     x0[r, i] it keeps in registers (no pair tile, no barrier). wgmma
//     reads those registers after issue, so each K tile's products retire
//     before the next tile's fragments are formed; the other warpgroup
//     keeps the tensor cores busy meanwhile. The
//     epilogue rounds x1 to bf16 into shared memory (and to x1 when asked),
//     sums p1 per example, and forms Q per example, x0^T [32, slots] x x1
//     [slots, h1], with mma.sync (m16n8k16): 0.9 GMAC at M = 32, K = the
//     example's slots, too small a product for a warpgroup's 64 rows;
//  3. p2 = Q [B, m*h1] x W2T^T as a GEMM with M = examples (cin2_gemm_tn:
//     128 x N tiles, K streamed by TMA, wgmma with both operands from
//     shared memory). Q goes through device memory (to the caller's Q in
//     training, else to scratch): about 2 x 109 MB at the serving shape,
//     0.065 ms of memory time, against a p2 at M = 16 per block before.
// Examples past the batch's end are zero rows whose results are not stored,
// so any B works.
//
// Limits, checked here and by the wrapper (cin2_takes): D <= 32, m <= 32,
// h1 and h2 multiples of 16 from 16 to 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cin2_common.cuh"

namespace rm {

namespace {

constexpr int kStages = 4;
constexpr int kX0Ld = 40;  // bf16 row stride of the x0 tile: 80 bytes, conflict-free ldmatrix
constexpr int kGemmStages = 4;

struct Perms {
  Perm p[4];
};

// Eight outputs along o2 a thread (every job's n2 is a multiple of 8), one
// 16-byte store.
__global__ void permute_kernel(const __grid_constant__ Perms jobs) {
  const Perm& p = jobs.p[blockIdx.y];
  const unsigned o = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (o >= (unsigned)p.n0 * p.n1 * p.n2) return;
  const unsigned o2 = o % p.n2;
  const unsigned r = o / p.n2;
  const unsigned o1 = r % p.n1;
  const unsigned o0 = r / p.n1;
  union {
    uint4 u;
    bf16 h[8];
  } v;
  const bool row = (int)o0 < p.lim0 && (int)o1 < p.lim1;
  const bf16* in = p.in + o0 * p.s0 + o1 * p.s1;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v.h[k] = row && (int)(o2 + k) < p.lim2 ? in[(o2 + k) * p.s2] : __float2bfloat16_rn(0.f);
  *reinterpret_cast<uint4*>(p.out + o) = v.u;
}

// ------------------------------------------------------------------ GEMM
// c [m, n] = bf16(a [m, k] . b [n, k]^T). Block (n tile, m tile): two
// consumer warpgroups of 64 rows each and a producer warp that streams the
// K tiles of a ([128, 64]) and b ([BN, 64]) by TMA through a 4-stage ring.
template <int BN>
__global__ void __launch_bounds__(kBlockThreads, 1)
    gemm_tn_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                   bf16* __restrict__ c, long long m, int n, int k) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  constexpr int kABytes = kTileRows * 64 * 2;
  constexpr int kBBytes = BN * 64 * 2;
  constexpr int kStage = kABytes + kBBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGemmStages * kStage);
  uint64_t* empty = full + kGemmStages;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long m0 = (long long)blockIdx.y * kTileRows;
  const int n0 = blockIdx.x * BN;
  const int kt_n = (k + 63) / 64;
  if (tid == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % kGemmStages;
        mbar_wait(&empty[s], ((kt / kGemmStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStage);
        tma_load_2d(smem + s * kStage, &ma, &full[s], kt * 64, (int)m0);
        tma_load_2d(smem + s * kStage + kABytes, &mb, &full[s], kt * 64, n0);
      }
    }
    return;
  }
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % kGemmStages;
    mbar_wait(&full[s], (kt / kGemmStages) & 1);
    const unsigned char* st = smem + s * kStage;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Wgmma<BN>::ss(acc, desc_k128(st + wg * 64 * 128) + 2 * ks, desc_k128(st + kABytes) + 2 * ks, 1);
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kGemmStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  // c through shared memory (the ring is free once both warpgroups are
  // done with it), then 16-byte stores of whole rows
  consumer_sync();
  constexpr int kLdc = BN + 8;
  bf16* ct = reinterpret_cast<bf16*>(smem);
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(ct + r0 * kLdc + col) = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(ct + (r0 + 8) * kLdc + col) = pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  consumer_sync();
  for (int idx = tid; idx < kTileRows * (BN / 8); idx += kConsumers) {
    const int r = idx / (BN / 8);
    const int cv = (idx % (BN / 8)) * 8;
    const long long row = m0 + r;
    if (row < m && n0 + cv < n)
      *reinterpret_cast<uint4*>(c + row * n + n0 + cv) = *reinterpret_cast<const uint4*>(ct + r * kLdc + cv);
  }
}

template <int BN>
int gemm_launch(const bf16* a, const bf16* b, bf16* c, long long m, int n, int k, cudaStream_t st) {
  CUtensorMap ma, mb;
  int err = make_map_bf16(&ma, a, k, m, k, kTileRows);
  if (err) return err;
  err = make_map_bf16(&mb, b, k, n, k, BN);
  if (err) return err;
  const size_t smem = 1024 + kGemmStages * (size_t)(kTileRows + BN) * 128 + 2 * kGemmStages * 8;
  cudaError_t e = cudaFuncSetAttribute(gemm_tn_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + BN - 1) / BN, (unsigned)((m + kTileRows - 1) / kTileRows));
  gemm_tn_kernel<BN><<<grid, kBlockThreads, smem, st>>>(ma, mb, c, m, n, k);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- layer 1
struct FwdLayout {
  size_t ring, x0, x1, bars, total;
};

template <int N1>
__host__ __device__ inline FwdLayout fwd_layout() {
  FwdLayout L;
  L.ring = 0;
  L.x0 = L.ring + (size_t)kStages * N1 * 128;
  L.x1 = L.x0 + align1k((size_t)kTileRows * kX0Ld * 2);
  L.bars = L.x1 + align1k((size_t)kTileRows * (N1 + 8) * 2);
  L.total = 1024 + L.bars + 2 * kStages * 8;
  return L;
}

template <int N1>
__global__ void __launch_bounds__(kBlockThreads, 1)
    cin2_fwd_kernel(const __grid_constant__ CUtensorMap mw1, const bf16* __restrict__ x0slot,
                    bf16* __restrict__ x1g, bf16* __restrict__ p1g, bf16* __restrict__ qg, int b,
                    int d, int m, int h1, int slots, int tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const FwdLayout L = fwd_layout<N1>();
  constexpr int kStage = N1 * 128;  // bytes of a [N1, 64] tile of W1T
  constexpr int kX1Ld = N1 + 8;
  bf16* x0s = reinterpret_cast<bf16*>(smem + L.x0);
  bf16* x1s = reinterpret_cast<bf16*>(smem + L.x1);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kt_n = (m + 1) / 2;  // K tiles of 64 pairs: two fields h each
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer: W1T's K tiles, tile after tile
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int kt = 0; kt < kt_n; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kStage);
          tma_load_2d(smem + L.ring + s * kStage, &mw1, &full[s], kt * 64, 0);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ra = wg * 64 + (warp & 3) * 16 + g;  // this thread's rows ra, ra + 8 of the tile
  const int per_tile = kTileRows / slots;        // examples per tile
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long e0 = (long long)tile * per_tile;
    consumer_sync();  // the previous tile's epilogue is done with x0s and x1s
    load_x0_tile(x0s, kX0Ld, x0slot + (long long)tile * kTileRows * kPairPad, tid);
    consumer_sync();
    // x0[r, i], x0[r, i + 1] at this thread's A-fragment columns i = 8 p + 2 t
    __nv_bfloat162 xi[2][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      xi[0][p] = *reinterpret_cast<const __nv_bfloat162*>(x0s + ra * kX0Ld + 8 * p + 2 * t);
      xi[1][p] = *reinterpret_cast<const __nv_bfloat162*>(x0s + (ra + 8) * kX0Ld + 8 * p + 2 * t);
    }
    float acc[N1 / 2];
#pragma unroll
    for (int i = 0; i < N1 / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < kt_n; ++kt, ++it) {
      // the tile's four k16 slices: fields h = 2 kt + hh, i in [16 ib, 16 ib + 16)
      uint32_t a[4][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = 2 * kt + hh;  // < 32; x0s is zero past m
        const __nv_bfloat162 xh0 = __bfloat162bfloat162(x0s[ra * kX0Ld + h]);
        const __nv_bfloat162 xh1 = __bfloat162bfloat162(x0s[(ra + 8) * kX0Ld + h]);
#pragma unroll
        for (int ib = 0; ib < 2; ++ib) {  // bf16x2 products round as bf16(a*b)
          const __nv_bfloat162 p[4] = {__hmul2(xh0, xi[0][2 * ib]), __hmul2(xh1, xi[1][2 * ib]),
                                       __hmul2(xh0, xi[0][2 * ib + 1]), __hmul2(xh1, xi[1][2 * ib + 1])};
#pragma unroll
          for (int r = 0; r < 4; ++r) a[hh * 2 + ib][r] = *reinterpret_cast<const uint32_t*>(&p[r]);
        }
      }
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint64_t bd = desc_k128(smem + L.ring + s * kStage);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) Wgmma<N1>::rs(acc, a[ks], bd + 2 * ks, 1);
      // wgmma reads its A registers after issue: retire the group before
      // the next k tile's fragments are formed (the other warpgroup keeps
      // the tensor cores busy meanwhile)
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    fence_regs(acc);

    // x1 = bf16(acc): into the x1 tile, and to x1 when asked
#pragma unroll
    for (int j = 0; j < N1 / 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ra + 8 * half;
        const uint32_t v = pack_bf16x2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        *reinterpret_cast<uint32_t*>(x1s + r * kX1Ld + col) = v;
        const long long e = e0 + r / slots;
        const int s = r % slots;
        if (x1g != nullptr && col < h1 && e < b && s < d)
          *reinterpret_cast<uint32_t*>(x1g + (e * d + s) * h1 + col) = v;
      }
    }
    consumer_sync();
    // p1 = sum over the example's D rows of x1
    for (int idx = tid; idx < per_tile * h1; idx += kConsumers) {
      const int el = idx / h1;
      const int n = idx % h1;
      const long long e = e0 + el;
      if (e < b) {
        float sum = 0.f;
        for (int s = 0; s < d; ++s) sum += __bfloat162float(x1s[(el * slots + s) * kX1Ld + n]);
        p1g[e * h1 + n] = __float2bfloat16_rn(sum);
      }
    }
    // Q_e = x0_e^T [32, slots] x x1_e [slots, h1]; warp w takes (example,
    // 16 fields) items w, w + 8, ...
    const long long mh1 = (long long)m * h1;
    for (int item = warp; item < per_tile * 2; item += kConsumers / 32) {
      const int el = item >> 1;
      const int jt = item & 1;
      const long long e = e0 + el;
      if (e >= b || jt * 16 >= m) continue;
      uint32_t af[kMaxSlots / 16][4];
#pragma unroll
      for (int kb = 0; kb < kMaxSlots / 16; ++kb)
        if (kb * 16 < slots) load_a_trans(af[kb], x0s, kX0Ld, jt * 16, el * slots + kb * 16, lane);
      const int j0 = jt * 16 + g;
      for (int np = 0; np * 16 < h1; ++np) {
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kb = 0; kb < kMaxSlots / 16; ++kb) {
          if (kb * 16 < slots) {
            uint32_t bf[4];
            load_b_kn(bf, x1s, kX1Ld, el * slots + kb * 16, np * 16, lane);
            mma_bf16(c0, af[kb], bf[0], bf[1]);
            mma_bf16(c1, af[kb], bf[2], bf[3]);
          }
        }
        bf16* qe = qg + e * mh1 + np * 16 + 2 * t;
        if (j0 < m) {
          *reinterpret_cast<uint32_t*>(qe + j0 * h1) = pack_bf16x2(c0[0], c0[1]);
          *reinterpret_cast<uint32_t*>(qe + j0 * h1 + 8) = pack_bf16x2(c1[0], c1[1]);
        }
        if (j0 + 8 < m) {
          *reinterpret_cast<uint32_t*>(qe + (j0 + 8) * h1) = pack_bf16x2(c0[2], c0[3]);
          *reinterpret_cast<uint32_t*>(qe + (j0 + 8) * h1 + 8) = pack_bf16x2(c1[2], c1[3]);
        }
      }
    }
  }
}

template <int N1>
int fwd_launch(const bf16* w1t, const bf16* x0slot, bf16* x1, bf16* p1, bf16* q, int b, int d, int m,
               int h1, int device, cudaStream_t st) {
  CUtensorMap mw1;
  int err = make_map_bf16(&mw1, w1t, (long long)m * kPairPad, h1, (long long)m * kPairPad, N1);
  if (err) return err;
  const FwdLayout L = fwd_layout<N1>();
  cudaError_t e = cudaFuncSetAttribute(cin2_fwd_kernel<N1>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int slots = cin2_slots(d);
  const int tiles = (int)(((long long)b * slots + kTileRows - 1) / kTileRows);
  const int grid = tiles < sms ? tiles : sms;
  cin2_fwd_kernel<N1><<<grid, kBlockThreads, L.total, st>>>(mw1, x0slot, x1, p1, q, b, d, m, h1,
                                                            slots, tiles);
  return (int)cudaGetLastError();
}

struct FwdScratch {
  size_t w1t, w2t, x0slot, q, total;
  int tiles;
};

FwdScratch fwd_scratch(long long b, int d, int m, int h1, int h2, bool own_q) {
  FwdScratch S;
  S.tiles = (int)((b * cin2_slots(d) + kTileRows - 1) / kTileRows);
  S.w1t = 0;
  S.w2t = align1k((size_t)h1 * m * kPairPad * 2);
  S.x0slot = S.w2t + align1k((size_t)h2 * m * h1 * 2);
  S.q = S.x0slot + align1k((size_t)S.tiles * kTileRows * kPairPad * 2);
  S.total = S.q + (own_q ? (size_t)b * m * h1 * 2 : 0);
  return S;
}

}  // namespace

int cin2_permute(const Perm* jobs, int njobs, cudaStream_t st) {
  if (njobs < 1 || njobs > 4) return (int)cudaErrorInvalidValue;
  Perms p;
  long long most = 0;
  for (int j = 0; j < njobs; ++j) {
    p.p[j] = jobs[j];
    const long long n = (long long)jobs[j].n0 * jobs[j].n1 * jobs[j].n2;
    if (n >= (1LL << 31) || jobs[j].n2 % 8) return (int)cudaErrorInvalidValue;
    most = n > most ? n : most;
  }
  if (most == 0) return 0;
  permute_kernel<<<dim3((unsigned)((most / 8 + 255) / 256), njobs), 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

int cin2_gemm_tn(const bf16* a, const bf16* b, bf16* c, long long m, int n, int k, cudaStream_t st) {
  if (m == 0) return 0;
  return n <= 128 ? gemm_launch<128>(a, b, c, m, n, k, st) : gemm_launch<256>(a, b, c, m, n, k, st);
}

}  // namespace rm

using namespace rm;

// 1 if the fused kernels (this file's and cin2_bwd.cu's) take the shape.
extern "C" int rm_cin2_takes(int d, int m, int h1, int h2) {
  return d >= 1 && d <= kMaxSlots && m >= 1 && m <= kPairPad && h1 % 16 == 0 && h2 % 16 == 0 &&
         h1 >= 16 && h2 >= 16 && h1 <= 256 && h2 <= 256;
}

// Bytes of scratch rm_cin2_forward needs: the re-laid weights, and Q when
// the caller passes none.
extern "C" long long rm_cin2_forward_scratch(int b, int d, int m, int h1, int h2, int want_q) {
  if (!rm_cin2_takes(d, m, h1, h2) || b < 0) return -1;
  return (long long)fwd_scratch(b, d, m, h1, h2, !want_q).total;
}

// x0 [b*d, m], w1 [m, m*h1], w2 [h1, m*h2], p1 [b, h1], p2 [b, h2], all bf16;
// x1 [b*d, h1] and q [b, m*h1] may be null; scratch of
// rm_cin2_forward_scratch bytes, 1024-byte aligned. q 16-byte aligned.
extern "C" int rm_cin2_forward(int device, const void* x0, const void* w1, const void* w2, void* x1,
                               void* p1, void* p2, void* q, void* scratch, int b, int d, int m,
                               int h1, int h2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!rm_cin2_takes(d, m, h1, h2)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const FwdScratch S = fwd_scratch(b, d, m, h1, h2, q == nullptr);
  unsigned char* base = (unsigned char*)scratch;
  bf16* w1t = (bf16*)(base + S.w1t);
  bf16* w2t = (bf16*)(base + S.w2t);
  bf16* x0slot = (bf16*)(base + S.x0slot);
  bf16* qq = q != nullptr ? (bf16*)q : (bf16*)(base + S.q);
  // W1T[n][h][i] = w1[h, i*h1 + n] (zero for i >= m); W2T[n][j][k] = w2[k, j*h2 + n]
  const Perm jobs[3] = {
      {(const bf16*)w1, w1t, h1, m, kPairPad, h1, m, m, 1, (long long)m * h1, h1},
      {(const bf16*)w2, w2t, h2, m, h1, h2, m, h1, 1, h2, (long long)m * h2},
      x0_slot_job((const bf16*)x0, x0slot, b, d, m, cin2_slots(d), S.tiles),
  };
  int e = cin2_permute(jobs, 3, st);
  if (e) return e;
  e = h1 <= 128 ? fwd_launch<128>(w1t, x0slot, (bf16*)x1, (bf16*)p1, qq, b, d, m, h1, device, st)
                : fwd_launch<256>(w1t, x0slot, (bf16*)x1, (bf16*)p1, qq, b, d, m, h1, device, st);
  if (e) return e;
  return cin2_gemm_tn(qq, w2t, (bf16*)p2, b, h2, m * h1, st);
}
