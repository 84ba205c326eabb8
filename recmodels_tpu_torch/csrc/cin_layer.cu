// One generic CIN layer, forward (xDeepFM), on flat (b, d) rows.
//
// Replaces: recmodels_tpu/ops/pallas/interactions_tpu.py::_cin_forward_2d
// (its _cin_kernel). Rows r = (b, d): xk [R, Hk], x0 [R, m] and the flat
// weight w2 [Hk, m*Hn] (column i*Hn + n = w[n, h, i]) give out [R, Hn]:
//   t_i[r, n] = sum_h xk[r, h] * w2[h, i*Hn + n]        (f32, never rounded)
//   out[r, n] = cast( sum_i t_i[r, n] * x0[r, i] )     (f32 fold, one cast)
// in bf16 or f32 (every tensor of one type). The pair products xk * x0 are
// never formed, so nothing rounds before the final cast.
//
// Bound on this card: operations, 2 * R * Hk * m * Hn. At the training shape
// (R = 262,144, m = 26, Hn = 128) that is 223 GFLOP for Hk = 128 and 45 GFLOP
// for Hk = 26, against 67-93 MB of input and output.
//
// Design. The TPU kernel forms t = xk @ w2 as one [TR, m*Hn] MXU product in
// VMEM and folds it lane-slice by lane-slice. Here a block takes 128 rows
// and 128 output columns (8 warps of 32 rows x 64 columns), and walks i:
// w2's [Hk, 128] slice for field i is staged in shared memory (k-chunks of
// 128 when Hk > 128), each warp forms its 32 x 64 t_i on the tensor cores
// (mma.sync, bf16 in, f32 accumulate; the xk rows stay in shared memory),
// and then folds t_i into its f32 output accumulators with the row's
// x0[r, i], which the C fragment's known layout puts in registers. The next field's slice is
// copied by cp.async into a second buffer while this one multiplies. f32
// takes the same walk with FFMA on 64 x 64 tiles (no TF32: the reference is
// full f32). Ragged R, Hk, Hn and any m are zero-filled at the tile edges
// and masked at the store.

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
// f32: 16 x 16 threads of 4 x 4 outputs
constexpr int kRowsF = 64;
constexpr int kColsF = 64;
constexpr int kLdF = kKc + 1;
constexpr size_t kSmemF32 = (size_t)(kRowsF * kLdF + kKc * kColsF) * sizeof(float);

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

__global__ void __launch_bounds__(kThreads)
    cin_layer_f32_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
                         const float* __restrict__ w2, float* __restrict__ out, long long rows,
                         int hk, int m, int hn) {
  extern __shared__ uint4 smem_raw[];
  float* sx = reinterpret_cast<float*>(smem_raw);  // [kRowsF][kLdF]
  float* sw = sx + kRowsF * kLdF;                  // [kKc][kColsF]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long row0 = (long long)blockIdx.x * kRowsF;
  const int n0 = blockIdx.y * kColsF;
  const int ncols = min(kColsF, hn - n0);
  const int nkc = (hk + kKc - 1) / kKc;
  const long long ld_w = (long long)m * hn;
  const long long avail = rows - row0;

  float acc[4][4] = {};
  for (int i = 0; i < m; ++i) {
    float t[4][4] = {};
    for (int kc = 0; kc < nkc; ++kc) {
      const int k0 = kc * kKc;
      const int kw = min(kKc, hk - k0);
      __syncthreads();
      if (i == 0 || nkc > 1) {
        for (int idx = threadIdx.x; idx < kRowsF * kw; idx += kThreads) {
          const int r = idx / kw, k = idx - r * kw;
          sx[r * kLdF + k] = r < avail ? xk[(row0 + r) * hk + k0 + k] : 0.f;
        }
      }
      for (int idx = threadIdx.x; idx < kw * kColsF; idx += kThreads) {
        const int k = idx / kColsF, c = idx - k * kColsF;
        sw[k * kColsF + c] =
            c < ncols ? w2[(long long)(k0 + k) * ld_w + (long long)i * hn + n0 + c] : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kw; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = sx[(ty * 4 + u) * kLdF + k];
        const float4 bv = *reinterpret_cast<const float4*>(sw + k * kColsF + tx * 4);
        b[0] = bv.x, b[1] = bv.y, b[2] = bv.z, b[3] = bv.w;
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) t[u][w] = fmaf(a[u], b[w], t[u][w]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long r = row0 + ty * 4 + u;
      const float xv = r < rows ? x0[r * m + i] : 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(t[u][w], xv, acc[u][w]);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const long long r = row0 + ty * 4 + u;
    if (r >= rows) continue;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (tx * 4 + w < ncols) out[r * hn + n0 + tx * 4 + w] = acc[u][w];
  }
}

}  // namespace

// xk [rows, hk], x0 [rows, m], w2 [hk, m*hn] -> out [rows, hn], all bf16
// (is_bf16) or all f32, row-major.
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
    const dim3 grid((unsigned)((rows + kRowsF - 1) / kRowsF),
                    (unsigned)((hn + kColsF - 1) / kColsF));
    cin_layer_f32_kernel<<<grid, kThreads, kSmemF32, st>>>(
        (const float*)xk, (const float*)x0, (const float*)w2, (float*)out, rows, hk, m, hn);
  }
  return (int)cudaGetLastError();
}
