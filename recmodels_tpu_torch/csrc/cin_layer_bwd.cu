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
// Hk = Hn = 128, m = 26).
//
// Design. Two products with different reductions, so two kernels and an
// in-order sum:
//   rows: a block of 128 rows (8 warps of 16) holds its g rows and xk rows
//     in shared memory and walks the fields i; w2_i's [128, Hn] slice is
//     staged per i (by cp.async, into a second buffer while field i - 1
//     multiplies) and read in place as the B operand ([h][n] rows are B's
//     columns), so no transposed weight exists. Each warp forms t1_i on the
//     tensor cores (mma.sync, f32 accumulate), rounds it, folds it into its
//     gxk accumulators with x0[r, i] and into q_i with the xk values at the
//     same fragment positions; q_i's row sums reduce over the quad's lanes
//     and add into an f32 per-row partial in shared memory, rounded once at
//     the end (Hk > 128 walks blocks of 128 h and adds across them).
//   gw: the weight grad is a sum over all rows. A block forms one
//     [128 h x 128 n] tile of field i over a slice of 4,096 rows, 64 rows
//     at a time: the next chunk's g and xk rows are copied by cp.async
//     while this one forms z_i = bf16(xk * x0_i) in shared memory and
//     multiplies; it writes f32 partials per slice, and a third kernel sums
//     the slices in slice order and rounds. No atomics, so a run repeats
//     bit for bit.
// Ragged R, Hk, Hn are zero-filled at the tile edges and masked at the
// store; m is limited by the rows kernel's shared memory (m <= 182).

#include "mma_sm90.cuh"

using rm::bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;          // rows per block (rows kernel)
constexpr int kChunk = 64;          // rows per staged chunk (gw kernel)
constexpr int kTile = 128;          // h, n (and K chunk) width of a block
constexpr int kLd = kTile + 8;      // padded shared row (bf16)
constexpr long long kSlice = 4096;  // rows per gw partial
constexpr size_t kTileBytes = (size_t)kRows * kLd * sizeof(bf16);
constexpr size_t kMaxSmem = 232448;

// g rows, xk rows, two w2 blocks and the gx0 partials
size_t rows_smem(int m) { return 4 * kTileBytes + (size_t)kRows * m * sizeof(float); }
// two buffers each of g rows and xk rows, and z
constexpr size_t kGwSmem = 5 * (size_t)kChunk * kLd * sizeof(bf16);

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads, 1)
    cin_bwd_rows_kernel(const bf16* __restrict__ g, const bf16* __restrict__ xk,
                        const bf16* __restrict__ x0, const bf16* __restrict__ w2,
                        bf16* __restrict__ gxk, bf16* __restrict__ gx0, long long rows, int hk,
                        int m, int hn) {
  extern __shared__ uint4 smem_raw[];
  bf16* sg = reinterpret_cast<bf16*>(smem_raw);  // g rows, one K chunk of n
  bf16* sx = sg + kRows * kLd;                   // xk rows, one block of h
  bf16* sw = sx + kRows * kLd;                   // two buffers of the w2_i block [h][n]
  float* sp = reinterpret_cast<float*>(sw + 2 * kTile * kLd);  // gx0 partials [kRows][m]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const long long row0 = (long long)blockIdx.x * kRows;
  const long long avail = rows - row0;
  const int la = warp * 16 + grp, lb = la + 8;  // the thread's two rows, in the block
  const long long ra = row0 + la, rb = row0 + lb;
  const int nkc = (hn + kTile - 1) / kTile;
  const int nhb = (hk + kTile - 1) / kTile;
  const int stages = nhb * m * nkc;  // stage s: h block, field, K chunk (K chunk fastest)
  const long long ld_w = (long long)m * hn;

  // w2[h block, field i's K chunk] of stage s into buffer s & 1
  auto issue_w = [&](int s) {
    const int kc = s % nkc, i = (s / nkc) % m, hb = s / (nkc * m);
    const int h0 = hb * kTile, k0 = kc * kTile;
    const int kw = min(kTile, hn - k0);
    rm::stage_tile(sw + (s & 1) * kTile * kLd, kLd,
                         w2 + (long long)h0 * ld_w + (long long)i * hn + k0, ld_w,
                         min(kTile, hk - h0), kw, kTile, ((kw + 15) >> 4) * 16);
    rm::cp_async_commit();
  };

  for (int idx = threadIdx.x; idx < kRows * m; idx += kThreads) sp[idx] = 0.f;
  float gacc[16][4], t[16][4];
  issue_w(0);
  for (int s = 0; s < stages; ++s) {
    const int kc = s % nkc, i = (s / nkc) % m, hb = s / (nkc * m);
    const int h0 = hb * kTile, k0 = kc * kTile;
    const int hw = min(kTile, hk - h0);
    const int kw = min(kTile, hn - k0);
    const int ksteps = (kw + 15) >> 4;
    rm::cp_async_wait_all();
    __syncthreads();  // stage s's block has landed; every warp is done with stage s - 1
    const bool new_g = s == 0 || nkc > 1;
    const bool new_x = i == 0 && kc == 0;
    if (new_g) rm::stage_tile(sg, kLd, g + row0 * hn + k0, hn, avail, kw, kRows, ksteps * 16);
    if (new_x) rm::stage_tile(sx, kLd, xk + row0 * hk + h0, hk, avail, hw, kRows, kTile);
    if (new_g || new_x) rm::cp_async_wait_all();
    if (s + 1 < stages) issue_w(s + 1);  // lands while this stage multiplies
    if (new_g || new_x) __syncthreads();
    const bool last = kc == nkc - 1;
    float xa = 0.f, xb = 0.f;  // loaded ahead of the products
    if (last) {
      if (ra < rows) xa = __bfloat162float(x0[ra * m + i]);
      if (rb < rows) xb = __bfloat162float(x0[rb * m + i]);
    }
    if (new_x) {
#pragma unroll
      for (int j = 0; j < 16; ++j) gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
    }
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.f;
    }
    const bf16* swb = sw + (s & 1) * kTile * kLd;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[4];
      rm::load_a(a, sg, kLd, warp * 16, ks * 16, lane);
#pragma unroll
      for (int hp = 0; hp < 8; ++hp) {
        uint32_t b[4];
        rm::load_b_nk(b, swb, kLd, ks * 16, hp * 16, lane);
        rm::mma_bf16(t[2 * hp], a, b[0], b[1]);
        rm::mma_bf16(t[2 * hp + 1], a, b[2], b[3]);
      }
    }
    if (!last) continue;
    float qa = 0.f, qb = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = j * 8 + tig * 2;
      const float2 ka = rm::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(sx + la * kLd + col));
      const float2 kb = rm::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(sx + lb * kLd + col));
      const float t0 = round_bf16(t[j][0]), t1 = round_bf16(t[j][1]);
      const float t2 = round_bf16(t[j][2]), t3 = round_bf16(t[j][3]);
      gacc[j][0] = fmaf(t0, xa, gacc[j][0]);
      gacc[j][1] = fmaf(t1, xa, gacc[j][1]);
      gacc[j][2] = fmaf(t2, xb, gacc[j][2]);
      gacc[j][3] = fmaf(t3, xb, gacc[j][3]);
      qa += round_bf16(t0 * ka.x) + round_bf16(t1 * ka.y);
      qb += round_bf16(t2 * kb.x) + round_bf16(t3 * kb.y);
    }
    qa += __shfl_xor_sync(0xffffffffu, qa, 1);
    qa += __shfl_xor_sync(0xffffffffu, qa, 2);
    qb += __shfl_xor_sync(0xffffffffu, qb, 1);
    qb += __shfl_xor_sync(0xffffffffu, qb, 2);
    if (tig == 0) {  // one writer per (row, i); the same lane in every h block
      sp[la * m + i] += qa;
      sp[lb * m + i] += qb;
    }
    if (i < m - 1) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // this h block of gxk is complete
      const int col = j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = h ? rb : ra;
        if (r >= rows) continue;
        bf16* dst = gxk + r * hk + h0 + col;
        const float v0 = gacc[j][2 * h], v1 = gacc[j][2 * h + 1];
        if (col + 1 < hw && (hk & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < hw) dst[0] = __float2bfloat16_rn(v0);
          if (col + 1 < hw) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * m; idx += kThreads) {
    const int r = idx / m;
    if (r < avail) gx0[(row0 + r) * m + (idx - r * m)] = __float2bfloat16_rn(sp[idx]);
  }
}

__global__ void __launch_bounds__(kThreads)
    cin_bwd_gw_kernel(const bf16* __restrict__ g, const bf16* __restrict__ xk,
                      const bf16* __restrict__ x0, float* __restrict__ partial, long long rows,
                      int hk, int m, int hn, int nhb, int nnb) {
  extern __shared__ uint4 smem_raw[];
  bf16* sg = reinterpret_cast<bf16*>(smem_raw);  // two buffers of g rows [r][n]
  bf16* sx = sg + 2 * kChunk * kLd;              // two buffers of xk rows [r][h]
  bf16* sz = sx + 2 * kChunk * kLd;              // z_i rows [r][h]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wh = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 h x 32 n
  const int nb = blockIdx.x % nnb;
  const int hb = (blockIdx.x / nnb) % nhb;
  const int i = blockIdx.x / (nnb * nhb);
  const int h0 = hb * kTile, n0 = nb * kTile;
  const int hw = min(kTile, hk - h0), nw = min(kTile, hn - n0);
  const long long r_begin = (long long)blockIdx.y * kSlice;
  const long long r_end = min(rows, r_begin + kSlice);
  const int chunks = (int)((r_end - r_begin + kChunk - 1) / kChunk);

  // the g and xk rows of chunk c into buffer c & 1
  auto issue = [&](int c) {
    const long long c0 = r_begin + (long long)c * kChunk;
    const int b = (c & 1) * kChunk * kLd;
    rm::stage_tile(sg + b, kLd, g + c0 * hn + n0, hn, r_end - c0, nw, kChunk, kTile);
    rm::stage_tile(sx + b, kLd, xk + c0 * hk + h0, hk, r_end - c0, hw, kChunk, kTile);
    rm::cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  issue(0);
  for (int c = 0; c < chunks; ++c) {
    const long long c0 = r_begin + (long long)c * kChunk;
    const long long avail = r_end - c0;
    const int ksteps = (int)((min(avail, (long long)kChunk) + 15) >> 4);
    rm::cp_async_wait_all();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    if (c + 1 < chunks) issue(c + 1);  // lands while this chunk multiplies
    // z_i = bf16(xk * x0[:, i]) from the staged xk rows (zero rows stay zero)
    const bf16* sxb = sx + (c & 1) * kChunk * kLd;
    for (int idx = threadIdx.x; idx < kChunk * (kTile / 8); idx += kThreads) {
      const int r = idx / (kTile / 8);
      const int col = (idx - r * (kTile / 8)) * 8;
      union Chunk {
        uint4 u;
        bf16 h[8];
      } v;
      v.u = *reinterpret_cast<const uint4*>(sxb + r * kLd + col);
      const float xv = r < avail ? __bfloat162float(x0[(c0 + r) * m + i]) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) v.h[j] = __float2bfloat16_rn(__bfloat162float(v.h[j]) * xv);
      *reinterpret_cast<uint4*>(sz + r * kLd + col) = v.u;
    }
    __syncthreads();
    const bf16* sgb = sg + (c & 1) * kChunk * kLd;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) rm::load_a_trans(a[mt], sz, kLd, wh * 64 + mt * 16, ks * 16, lane);
#pragma unroll
      for (int p = 0; p < 2; ++p) rm::load_b_kn(b[p], sgb, kLd, ks * 16, wn * 32 + p * 16, lane);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          rm::mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }

  const long long e_total = (long long)hk * m * hn;
  float* out = partial + (long long)blockIdx.y * e_total;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int hl = wh * 64 + mt * 16 + grp + h * 8;
      if (hl >= hw) continue;
      float* row = out + (long long)(h0 + hl) * m * hn + (long long)i * hn + n0;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int nl = wn * 32 + nt * 8 + tig * 2;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (nl + 1 < nw && (hn & 1) == 0) {
          *reinterpret_cast<float2*>(row + nl) = make_float2(v0, v1);
        } else {
          if (nl < nw) row[nl] = v0;
          if (nl + 1 < nw) row[nl + 1] = v1;
        }
      }
    }
  }
}

__global__ void cin_bwd_gw_reduce_kernel(const float* __restrict__ partial, bf16* __restrict__ gw,
                                         long long e_total, int n_slices) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= e_total) return;
  float s = 0.f;
  for (int k = 0; k < n_slices; ++k) s += partial[k * e_total + e];
  gw[e] = __float2bfloat16_rn(s);
}

bool supported(long long rows, int hk, int m, int hn) {
  return rows >= 0 && hk >= 1 && m >= 1 && hn >= 1 && rows_smem(m) <= kMaxSmem &&
         (rows + kSlice - 1) / kSlice <= 65535;
}

long long n_slices(long long rows) { return rows == 0 ? 0 : (rows + kSlice - 1) / kSlice; }

}  // namespace

// Scratch bytes rm_cin_layer_backward needs (the gw partials), or -1 when the
// kernels do not take these sizes.
extern "C" long long rm_cin_layer_backward_scratch(long long rows, int hk, int m, int hn) {
  if (!supported(rows, hk, m, hn)) return -1;
  return n_slices(rows) * hk * (long long)m * hn * (long long)sizeof(float);
}

// g [rows, hn], xk [rows, hk], x0 [rows, m], w2 [hk, m*hn], all bf16
// row-major -> gxk [rows, hk], gx0 [rows, m], gw [hk, m*hn] bf16; scratch of
// rm_cin_layer_backward_scratch bytes.
extern "C" int rm_cin_layer_backward(int device, const void* g, const void* xk, const void* x0,
                                     const void* w2, void* gxk, void* gx0, void* gw,
                                     void* scratch, long long rows, int hk, int m, int hn,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!supported(rows, hk, m, hn)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long e_total = (long long)hk * m * hn;
  if (rows == 0) return (int)cudaMemsetAsync(gw, 0, e_total * sizeof(bf16), st);
  const size_t smem_rows = rows_smem(m);
  err = cudaFuncSetAttribute(cin_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_rows);
  if (err != cudaSuccess) return (int)err;
  cin_bwd_rows_kernel<<<(unsigned)((rows + kRows - 1) / kRows), kThreads, smem_rows, st>>>(
      (const bf16*)g, (const bf16*)xk, (const bf16*)x0, (const bf16*)w2, (bf16*)gxk, (bf16*)gx0,
      rows, hk, m, hn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nhb = (hk + kTile - 1) / kTile, nnb = (hn + kTile - 1) / kTile;
  const size_t smem_gw = kGwSmem;
  err = cudaFuncSetAttribute(cin_bwd_gw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_gw);
  if (err != cudaSuccess) return (int)err;
  const int slices = (int)n_slices(rows);
  cin_bwd_gw_kernel<<<dim3((unsigned)(m * nhb * nnb), (unsigned)slices), kThreads, smem_gw, st>>>(
      (const bf16*)g, (const bf16*)xk, (const bf16*)x0, (float*)scratch, rows, hk, m, hn, nhb,
      nnb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cin_bwd_gw_reduce_kernel<<<(unsigned)((e_total + 255) / 256), 256, 0, st>>>(
      (const float*)scratch, (bf16*)gw, e_total, slices);
  return (int)cudaGetLastError();
}
