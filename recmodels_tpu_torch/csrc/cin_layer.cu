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
// then out = cast(sum_i t_i * x0[:, i]) (an f32 fold, one cast): the pair
// products xk * x0 are never formed, so nothing rounds before the final
// cast. The TPU kernel forms t as one [TR, m*Hn] MXU product in VMEM and
// folds it lane-slice by lane-slice. Here a block takes 128 rows and 128
// output columns (8 warps of 32 rows x 64 columns) and walks i: w2's
// [Hk, 128] slice for field i is staged in shared memory (k-chunks of 128
// when Hk > 128), each warp forms its 32 x 64 t_i on the tensor cores
// (mma.sync, bf16 in, f32 accumulate; the xk rows stay in shared memory),
// and then folds t_i into its f32 output accumulators with the row's
// x0[r, i], which the C fragment's known layout puts in registers. The next
// field's slice is copied by cp.async into a second buffer while this one
// multiplies.
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

#include "mma_sm90.cuh"

using rm::bf16;

namespace {

constexpr int kThreads = 256;
// bf16: 128 rows x 128 columns per block, k-chunks of 128
constexpr int kRows = 128;
constexpr int kCols = 128;
constexpr int kKc = 128;
constexpr int kLd = kKc + 8;   // padded row of the xk tile (bf16)
constexpr int kLdW = kCols + 8;  // padded row of the w2 slice (bf16)
constexpr size_t kSmemBf16 = (size_t)(kRows * kLd + 2 * kKc * kLdW) * sizeof(bf16);
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

__global__ void __launch_bounds__(kThreads, 1)
    cin_layer_bf16_kernel(const bf16* __restrict__ xk, const bf16* __restrict__ x0,
                          const bf16* __restrict__ w2, bf16* __restrict__ out, long long rows,
                          int hk, int m, int hn) {
  extern __shared__ uint4 smem_raw[];
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);  // xk rows, one k-chunk
  bf16* sw = sx + kRows * kLd;                   // two buffers of the w2 slice
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;  // 4 x 2 warps of 32 rows x 64 columns
  const long long row0 = (long long)blockIdx.x * kRows;
  const int n0 = blockIdx.y * kCols;
  const int ncols = min(kCols, hn - n0);
  const int nkc = (hk + kKc - 1) / kKc;
  const int stages = m * nkc;  // stage s: field s / nkc, k-chunk s % nkc
  const long long ld_w = (long long)m * hn;
  long long r[2][2];  // the thread's rows: m-tile, upper/lower half of the C fragment
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    r[mt][0] = row0 + wr * 32 + mt * 16 + grp;
    r[mt][1] = r[mt][0] + 8;
  }

  // w2[k-chunk, field i's columns n0..] of stage s into buffer s & 1
  auto issue_w = [&](int s) {
    const int i = s / nkc, k0 = (s - i * nkc) * kKc;
    const int kw = min(kKc, hk - k0);
    rm::stage_tile(sw + (s & 1) * kKc * kLdW, kLdW,
                         w2 + (long long)k0 * ld_w + (long long)i * hn + n0, ld_w, kw, ncols,
                         ((kw + 15) >> 4) * 16, kCols);
    rm::cp_async_commit();
  };

  float acc[2][8][4], t[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  issue_w(0);
  for (int s = 0; s < stages; ++s) {
    const int i = s / nkc, kc = s - i * nkc;
    const int k0 = kc * kKc;
    const int kw = min(kKc, hk - k0);
    const int ksteps = (kw + 15) >> 4;
    rm::cp_async_wait_all();
    __syncthreads();  // stage s's slice has landed; every warp is done with stage s - 1
    const bool new_x = s == 0 || nkc > 1;
    if (new_x) {
      rm::stage_tile(sx, kLd, xk + row0 * hk + k0, hk, rows - row0, kw, kRows, ksteps * 16);
      rm::cp_async_wait_all();
    }
    if (s + 1 < stages) issue_w(s + 1);  // lands while this stage multiplies
    if (new_x) __syncthreads();
    const bool last = kc == nkc - 1;
    float xv[2][2] = {};  // x0[r, i], loaded ahead of the products
    if (last) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (r[mt][h] < rows) xv[mt][h] = __bfloat162float(x0[r[mt][h] * m + i]);
    }
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j) t[mt][j][0] = t[mt][j][1] = t[mt][j][2] = t[mt][j][3] = 0.f;
    }
    const bf16* swb = sw + (s & 1) * kKc * kLdW;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) rm::load_a(a[mt], sx, kLd, wr * 32 + mt * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        rm::load_b_kn(b, swb, kLdW, ks * 16, wc * 64 + np * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          rm::mma_bf16(t[mt][2 * np], a[mt], b[0], b[1]);
          rm::mma_bf16(t[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    if (last) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[mt][j][0] = fmaf(t[mt][j][0], xv[mt][0], acc[mt][j][0]);
          acc[mt][j][1] = fmaf(t[mt][j][1], xv[mt][0], acc[mt][j][1]);
          acc[mt][j][2] = fmaf(t[mt][j][2], xv[mt][1], acc[mt][j][2]);
          acc[mt][j][3] = fmaf(t[mt][j][3], xv[mt][1], acc[mt][j][3]);
        }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = wc * 64 + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r[mt][h] >= rows) continue;
        bf16* dst = out + r[mt][h] * hn + n0 + c;
        const float v0 = acc[mt][j][2 * h], v1 = acc[mt][j][2 * h + 1];
        if (c + 1 < ncols && (hn & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < ncols) dst[0] = __float2bfloat16_rn(v0);
          if (c + 1 < ncols) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

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

extern "C" int rm_cin_layer_forward(int device, const void* xk, const void* x0,
                                    const void* w2, void* out, long long rows, int hk,
                                    int m, int hn, int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hk < 1 || m < 1 || hn < 1 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    err = cudaFuncSetAttribute(cin_layer_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBf16);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((rows + kRows - 1) / kRows), (unsigned)((hn + kCols - 1) / kCols));
    cin_layer_bf16_kernel<<<grid, kThreads, kSmemBf16, st>>>(
        (const bf16*)xk, (const bf16*)x0, (const bf16*)w2, (bf16*)out, rows, hk, m, hn);
  } else {
    err = cudaFuncSetAttribute(cin_layer_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemF32);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((rows + kBmF - 1) / kBmF), (unsigned)((hn + kBnF - 1) / kBnF));
    cin_layer_f32_kernel<<<grid, kThreadsF, kSmemF32, st>>>(
        (const float*)xk, (const float*)x0, (const float*)w2, (float*)out, rows, hk, m, hn);
  }
  return (int)cudaGetLastError();
}
