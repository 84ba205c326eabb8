// The front end of a Wukong layer (recmodels_tpu_torch/nn/wukong_fm.py,
// models/wukong.py): for each example's X [n, d] (n <= 32 embeddings of
// width d), the optimised FM's two products, the LayerNorm over their n k
// values and the Linear Compress Block, forward and back.
//
//   wukong_fm_fwd_kernel: Z = bf16(X^T Y) [d, k]; F = X Z [n, k] summed in
//     f32; a = bf16(LN_F(flatten(F))) (mean and variance of the n k values
//     in f32, then scale and shift); l = bf16(W_L X) [n_L, d]; and the LN's
//     mean and rstd of the example (f32).
//   wukong_fm_bwd_kernel: Z and F again from X; g_F = bf16(LN_F's backward
//     of g_a); g_Z^T = bf16(g_F^T X); g_x = bf16(g_F Z^T + Y g_Z^T + W_L^T
//     g_L + g_res), the sum in f32; and, per block, partial sums over its
//     examples of g_Y = sum X g_Z, g_W = sum X g_L^T (W_L^T's grad),
//     g_scale = sum g_a x_hat, g_shift = sum g_a.
//   wukong_fm_grad_sum_kernel: the blocks' partials summed in a fixed order
//     into the four weight grads (f32). No atomics: two calls give the same
//     bits, an eager step and a graph's replay too.
//
// Replaces: none. The JAX package has no Wukong; the port's plain version
// (two bmm's, layer_norm and a matmul) moves Z, F and the LN's f32
// intermediates through device memory, some 1 KB a value of X.
//
// Bound on this card: bytes. The products are 32 x 128 x 32 a pair per
// example (about 0.66 MFLOP forward, 2 MFLOP back), far too small for a
// batched cuBLAS call and too many for CUDA cores at the byte rate, so they
// run on the tensor cores by mma.sync (m16n8k16, bf16 in, f32 sums). At the
// Wukong cell's shapes (B 16,384, n 32, d 128, k 32, n_L 16) the forward
// reads X (134 MB) and writes a (34 MB) and l (67 MB); the backward reads X,
// g_a, g_s and g_res and writes g_x (about 0.47 GB).
//
// Design: a warp takes one example at a time; its X rows go to shared memory
// by cp.async (rows n..31 are zero, as are Y's and W_L^T's past n), and every
// product reads them there through ldmatrix. The forward's warps stay for the
// whole batch (a block per free slot of the card), each walking the examples
// a grid's warps apart with the next example's X loading into a second
// buffer while it computes; the backward's take 16 examples in a row (a
// fixed partition, so the partial sums are fixed), load g_a and the LN's
// statistics before computing F again, and g_res a chunk ahead. d is walked in chunks of 16: a chunk's Z^T = Y^T X[:, c]
// stays in registers, its accumulator fragments rounded to bf16 ARE the B
// fragments of F += X[:, c] Z[c, :] (an m16n8 accumulator's (row, 2 cols)
// pairs are the (2 rows, col) pairs of its transpose's B operand), so Z
// never leaves the registers. The LN's statistics are warp sums by a fixed
// butterfly, two passes over the registers. The backward recomputes Z^T and
// F (cheaper than reading them back), turns g_F's accumulator fragments
// into A fragments the same way, and stages each chunk's bf16 Z^T and g_Z^T
// in shared memory for the products that need them as B operands. Each
// thread owns fixed elements of g_scale and g_shift (in its warp's shared
// memory) and of g_Y and g_W (in registers); a block sums its warps in
// warp order and writes one row of partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_sm90.cuh"

namespace {

using rm::bf16;

constexpr int kWarps = 4;
constexpr int kNP = 32;          // n, padded
constexpr int kBwdPerWarp = 16;  // likewise in the backward
constexpr int kBwdPerBlock = kWarps * kBwdPerWarp;
constexpr int kLDS = 24;         // leading dimension of a staged [k][16] chunk
constexpr int kSumRows = 8;      // threads a column in the grad sum kernel

template <int K, int LT>
struct Shape {
  static constexpr int KT = K / 8;   // 8-wide tiles of k
  static constexpr int KM = K / 16;  // 16-wide tiles of k
  static constexpr int LP = 16 * LT; // n_L, padded
  static constexpr int LDY = K + 8;
  static constexpr int LDW = LP + 8;
  // one block's row of partials: g_Y [32][K], g_W [32][LP], g_scale, g_shift [32 K]
  static constexpr int kRed = kNP * K + kNP * LP;
  static constexpr int kCols = kRed + 2 * kNP * K;
};

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [0, avail) of a row-major bf16 matrix g (row stride ld elements, 16-byte
// aligned rows) into s (leading dimension lds), rows [avail, rows) zeroed; the
// warp's lanes share the chunks (the caller commits and waits).
__device__ __forceinline__ void stage_rows(bf16* s, int lds, const bf16* __restrict__ g, long long ld, int avail,
                                           int rows, int d, int lane) {
  const int chunks = d >> 3;
  for (int idx = lane; idx < rows * chunks; idx += 32) {
    const int r = idx / chunks, c = (idx - r * chunks) * 8;
    bf16* dst = s + r * lds + c;
    if (r < avail)
      rm::cp_async16(dst, g + r * ld + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Y [n][K] and W_L^T [n][n_l] into shared memory, zero past n and n_l.
template <int K, int LT>
__device__ __forceinline__ void stage_weights(bf16* ys, bf16* wts, const bf16* __restrict__ y,
                                              const bf16* __restrict__ w, int n, int n_l) {
  using S = Shape<K, LT>;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < kNP * S::LDY; i += blockDim.x) {
    const int r = i / S::LDY, c = i - r * S::LDY;
    ys[i] = (r < n && c < K) ? y[r * K + c] : zero;
  }
  for (int i = threadIdx.x; i < kNP * S::LDW; i += blockDim.x) {
    const int r = i / S::LDW, c = i - r * S::LDW;
    wts[i] = (r < n && c < n_l) ? w[r * n_l + c] : zero;
  }
}

// A fragments of Y^T [k][n] (M = k, K = n) from Y [n][k] in shared memory.
template <int K>
__device__ __forceinline__ void y_t_fragments(uint32_t (&yta)[K / 16][2][4], const bf16* ys, int ldy, int lane) {
#pragma unroll
  for (int mt = 0; mt < K / 16; ++mt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) rm::load_a_trans(yta[mt][ks], ys, ldy, mt * 16, ks * 16, lane);
}

// A chunk's Z^T [K][16] = Y^T X[:, kd..kd+16) (f32 sums) into zt, with the
// chunk's X B fragments bx[ks] for other products.
template <int K>
__device__ __forceinline__ void z_t_chunk(float (&zt)[K / 16][2][4], uint32_t (&bx)[2][4], const bf16* xs, int ldx,
                                          const uint32_t (&yta)[K / 16][2][4], int kd, int lane) {
#pragma unroll
  for (int mt = 0; mt < K / 16; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) zt[mt][j][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    rm::load_b_kn(bx[ks], xs, ldx, ks * 16, kd, lane);
#pragma unroll
    for (int mt = 0; mt < K / 16; ++mt) {
      rm::mma_bf16(zt[mt][0], yta[mt][ks], bx[ks][0], bx[ks][1]);
      rm::mma_bf16(zt[mt][1], yta[mt][ks], bx[ks][2], bx[ks][3]);
    }
  }
}

// acc[mt][nt] += X[:, c] T[c, :], where tt holds T^T [K][16] as accumulator
// fragments (rows of k, the chunk's 16 columns): rounded to bf16 they are the
// B fragments of T [16][K].
template <int K>
__device__ __forceinline__ void times_transposed(float (&acc)[2][K / 8][4], const uint32_t (&xa)[2][4],
                                                 const float (&tt)[K / 16][2][4]) {
#pragma unroll
  for (int nt = 0; nt < K / 8; ++nt) {
    const int h = (nt & 1) * 2;
    const uint32_t b0 = pack(tt[nt >> 1][0][h], tt[nt >> 1][0][h + 1]);
    const uint32_t b1 = pack(tt[nt >> 1][1][h], tt[nt >> 1][1][h + 1]);
    rm::mma_bf16(acc[0][nt], xa[0], b0, b1);
    rm::mma_bf16(acc[1][nt], xa[1], b0, b1);
  }
}

// F = X Z (f32) of the example in xs; with WITH_L also l = bf16(W_L X), rows
// below n_l stored to l_out [n_l][d].
template <int K, int LT, bool WITH_L>
__device__ __forceinline__ void fm_products(float (&f)[2][K / 8][4], const bf16* xs, int ldx,
                                            const uint32_t (&yta)[K / 16][2][4], const bf16* wts, int d, int lane,
                                            bf16* __restrict__ l_out, int n_l) {
  using S = Shape<K, LT>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) f[mt][nt][i] = 0.f;
  for (int kd = 0; kd < d; kd += 16) {
    float zt[K / 16][2][4];
    uint32_t bx[2][4];
    z_t_chunk<K>(zt, bx, xs, ldx, yta, kd, lane);
    uint32_t xa[2][4];
    rm::load_a(xa[0], xs, ldx, 0, kd, lane);
    rm::load_a(xa[1], xs, ldx, 16, kd, lane);
    times_transposed<K>(f, xa, zt);
    if constexpr (WITH_L) {
#pragma unroll
      for (int lt = 0; lt < LT; ++lt) {
        float lc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t wa[4];
          rm::load_a_trans(wa, wts, S::LDW, lt * 16, ks * 16, lane);  // W [l][n] from W^T [n][l]
          rm::mma_bf16(lc[0], wa, bx[ks][0], bx[ks][1]);
          rm::mma_bf16(lc[1], wa, bx[ks][2], bx[ks][3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = lt * 16 + g + 8 * half;
            if (row < n_l)
              *reinterpret_cast<uint32_t*>(l_out + (long long)row * d + kd + j * 8 + 2 * t) =
                  pack(lc[j][2 * half], lc[j][2 * half + 1]);
          }
      }
    }
  }
}

template <int K, int LT>
__global__ void __launch_bounds__(kWarps * 32)
    wukong_fm_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const bf16* __restrict__ w,
                         const float* __restrict__ scale, const float* __restrict__ shift, bf16* __restrict__ a,
                         bf16* __restrict__ l, float* __restrict__ mean, float* __restrict__ rstd, int b, int n,
                         int d, int n_l, float eps) {
  using S = Shape<K, LT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ldx = d + 8;
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* wts = ys + kNP * S::LDY;
  bf16* xbuf = wts + kNP * S::LDW + warp * 2 * kNP * ldx;  // two X buffers a warp
  stage_weights<K, LT>(ys, wts, y, w, n, n_l);
  __syncthreads();
  uint32_t yta[K / 16][2][4];
  y_t_fragments<K>(yta, ys, S::LDY, lane);
  const float count = (float)(n * K);
  const long long stride = (long long)gridDim.x * kWarps;
  long long e = (long long)blockIdx.x * kWarps + warp;
  if (e < b) stage_rows(xbuf, ldx, x + e * n * d, d, n, kNP, d, lane);
  rm::cp_async_commit();
  for (int buf = 0; e < b; e += stride, buf ^= 1) {
    // the next example's X goes in while this one's is read
    const long long next = e + stride;
    if (next < b) stage_rows(xbuf + (buf ^ 1) * kNP * ldx, ldx, x + next * n * d, d, n, kNP, d, lane);
    rm::cp_async_commit();
    rm::cp_async_wait<1>();
    __syncwarp();
    const bf16* xs = xbuf + buf * kNP * ldx;
    float f[2][K / 8][4];
    fm_products<K, LT, true>(f, xs, ldx, yta, wts, d, lane, l + e * n_l * d, n_l);
    float s = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (mt * 16 + g + 8 * (i >> 1) < n) s += f[mt][nt][i];
    const float mu = warp_sum(s) / count;
    float v = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (mt * 16 + g + 8 * (i >> 1) < n) {
            const float dv = f[mt][nt][i] - mu;
            v += dv * dv;
          }
    const float rs = 1.f / sqrtf(warp_sum(v) / count + eps);
    bf16* ae = a + e * n * K;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mt * 16 + g + 8 * half;
          if (row >= n) continue;
          const int idx = row * K + nt * 8 + 2 * t;
          const float o0 = (f[mt][nt][2 * half] - mu) * rs * scale[idx] + shift[idx];
          const float o1 = (f[mt][nt][2 * half + 1] - mu) * rs * scale[idx + 1] + shift[idx + 1];
          *reinterpret_cast<uint32_t*>(ae + idx) = pack(o0, o1);
        }
    if (lane == 0) {
      mean[e] = mu;
      rstd[e] = rs;
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
  }
  rm::cp_async_wait_all();
}

template <int K, int LT>
__global__ void __launch_bounds__(kWarps * 32)
    wukong_fm_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const bf16* __restrict__ w,
                         const float* __restrict__ scale, const float* __restrict__ mean,
                         const float* __restrict__ rstd, const bf16* __restrict__ g_a, const bf16* __restrict__ g_s,
                         const bf16* __restrict__ g_res, bf16* __restrict__ g_x, float* __restrict__ partials, int b,
                         int n, int d, int n_l, int m, int n_f) {
  using S = Shape<K, LT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ldx = d + 8;
  // block: Y, W^T; then each warp's X, g_L, g_F, the two staged chunks; then
  // each warp's g_scale, g_shift (f32). The block's sum of g_Y and g_W lies
  // over the warps' X buffers once every warp is done with them.
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* wts = ys + kNP * S::LDY;
  const int warp_elems = kNP * ldx + S::LP * ldx + kNP * S::LDY + 2 * K * kLDS;
  bf16* warps0 = wts + kNP * S::LDW;
  bf16* xs = warps0 + warp * warp_elems;
  bf16* gls = xs + kNP * ldx;
  bf16* gfs = gls + S::LP * ldx;
  bf16* stz = gfs + kNP * S::LDY;
  bf16* stg = stz + K * kLDS;
  float* acc0 = reinterpret_cast<float*>(warps0 + kWarps * warp_elems);
  float* gsc = acc0 + warp * 2 * kNP * K;
  float* gsh = gsc + kNP * K;
  float* red = reinterpret_cast<float*>(warps0);

  stage_weights<K, LT>(ys, wts, y, w, n, n_l);
  for (int i = lane; i < 2 * kNP * K; i += 32) gsc[i] = 0.f;  // gsc, then gsh
  __syncthreads();
  uint32_t yta[K / 16][2][4];
  y_t_fragments<K>(yta, ys, S::LDY, lane);
  float gy[2][K / 8][4], gw[2][S::LP / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) gy[mt][nt][i] = 0.f;
#pragma unroll
    for (int nt = 0; nt < S::LP / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) gw[mt][nt][i] = 0.f;
  }
  const float count = (float)(n * K);
  const long long first = (long long)blockIdx.x * kBwdPerBlock + warp * kBwdPerWarp;
  for (int j = 0; j < kBwdPerWarp; ++j) {
    const long long e = first + j;
    if (e >= b) break;
    __syncwarp();
    stage_rows(xs, ldx, x + e * n * d, d, n, kNP, d, lane);
    stage_rows(gls, ldx, g_s + (e * m + n_f) * d, d, n_l, S::LP, d, lane);
    rm::cp_async_commit();
    // the LN's statistics and g_a's elements of this thread load while the
    // copies land and F is computed again
    const float mu = mean[e], rs = rstd[e];
    const bf16* gae = g_a + e * n * K;
    uint32_t gar[2][K / 8][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mt * 16 + g + 8 * half;
          gar[mt][nt][half] = row < n ? *reinterpret_cast<const uint32_t*>(gae + row * K + nt * 8 + 2 * t) : 0u;
        }
    rm::cp_async_wait_all();
    __syncwarp();

    // F again, then LN_F's backward: f becomes x_hat, gf g_x_hat and then g_F
    float f[2][K / 8][4], gf[2][K / 8][4];
    fm_products<K, LT, false>(f, xs, ldx, yta, wts, d, lane, nullptr, 0);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mt * 16 + g + 8 * half, i0 = 2 * half, i1 = 2 * half + 1;
          if (row >= n) {
            f[mt][nt][i0] = f[mt][nt][i1] = gf[mt][nt][i0] = gf[mt][nt][i1] = 0.f;
            continue;
          }
          const int idx = row * K + nt * 8 + 2 * t;
          const float2 ga = rm::unpack_bf16x2(gar[mt][nt][half]);
          const float x0 = (f[mt][nt][i0] - mu) * rs, x1 = (f[mt][nt][i1] - mu) * rs;
          const float h0 = ga.x * scale[idx], h1 = ga.y * scale[idx + 1];
          f[mt][nt][i0] = x0;
          f[mt][nt][i1] = x1;
          gf[mt][nt][i0] = h0;
          gf[mt][nt][i1] = h1;
          gsc[idx] += ga.x * x0;
          gsc[idx + 1] += ga.y * x1;
          gsh[idx] += ga.x;
          gsh[idx + 1] += ga.y;
          s1 += h0 + h1;
          s2 += h0 * x0 + h1 * x1;
        }
    const float m1 = warp_sum(s1) / count, m2 = warp_sum(s2) / count;
    uint32_t gfa[2][K / 16][4];  // g_F as A fragments [n][k]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < K / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool valid = mt * 16 + g + 8 * (i >> 1) < n;
          gf[mt][nt][i] = valid ? rs * (gf[mt][nt][i] - m1 - f[mt][nt][i] * m2) : 0.f;
        }
        const uint32_t lo = pack(gf[mt][nt][0], gf[mt][nt][1]), hi = pack(gf[mt][nt][2], gf[mt][nt][3]);
        *reinterpret_cast<uint32_t*>(gfs + (mt * 16 + g) * S::LDY + nt * 8 + 2 * t) = lo;
        *reinterpret_cast<uint32_t*>(gfs + (mt * 16 + g + 8) * S::LDY + nt * 8 + 2 * t) = hi;
        gfa[mt][nt >> 1][(nt & 1) * 2] = lo;
        gfa[mt][nt >> 1][(nt & 1) * 2 + 1] = hi;
      }
    }
    __syncwarp();

    const bf16* gre = g_res + e * n * d;
    bf16* gxe = g_x + e * n * d;
    // g_res's elements of this thread in a chunk, loaded a chunk ahead
    auto load_res = [&](uint32_t (&r)[2][2][2], int kd) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int dt = 0; dt < 2; ++dt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = mt * 16 + g + 8 * half;
            r[mt][dt][half] = (row < n && kd < d)
                ? *reinterpret_cast<const uint32_t*>(gre + (long long)row * d + kd + dt * 8 + 2 * t) : 0u;
          }
    };
    uint32_t res[2][2][2];
    load_res(res, 0);
    for (int kd = 0; kd < d; kd += 16) {
      uint32_t res_next[2][2][2];
      load_res(res_next, kd + 16);
      float zt[K / 16][2][4], gzt[K / 16][2][4];
      uint32_t bx[2][4];
      z_t_chunk<K>(zt, bx, xs, ldx, yta, kd, lane);
#pragma unroll
      for (int mt = 0; mt < K / 16; ++mt)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) gzt[mt][jj][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int mt = 0; mt < K / 16; ++mt) {
          uint32_t ga[4];
          rm::load_a_trans(ga, gfs, S::LDY, mt * 16, ks * 16, lane);  // g_F^T [k][n]
          rm::mma_bf16(gzt[mt][0], ga, bx[ks][0], bx[ks][1]);
          rm::mma_bf16(gzt[mt][1], ga, bx[ks][2], bx[ks][3]);
        }
      uint32_t xa[2][4];
      rm::load_a(xa[0], xs, ldx, 0, kd, lane);
      rm::load_a(xa[1], xs, ldx, 16, kd, lane);
      times_transposed<K>(gy, xa, gzt);  // g_Y += X[:, c] g_Z[c, :]
#pragma unroll
      for (int lt = 0; lt < LT; ++lt) {  // g_W += X[:, c] g_L[:, c]^T
        uint32_t bl[4];
        rm::load_b_nk(bl, gls, ldx, kd, lt * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          rm::mma_bf16(gw[mt][2 * lt], xa[mt], bl[0], bl[1]);
          rm::mma_bf16(gw[mt][2 * lt + 1], xa[mt], bl[2], bl[3]);
        }
      }
      // the chunk's bf16 Z^T and g_Z^T [k][16] into shared memory
#pragma unroll
      for (int mt = 0; mt < K / 16; ++mt)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int off = (mt * 16 + g + 8 * half) * kLDS + jj * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(stz + off) = pack(zt[mt][jj][2 * half], zt[mt][jj][2 * half + 1]);
            *reinterpret_cast<uint32_t*>(stg + off) = pack(gzt[mt][jj][2 * half], gzt[mt][jj][2 * half + 1]);
          }
      __syncwarp();
      float gx[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int dt = 0; dt < 2; ++dt)
#pragma unroll
          for (int i = 0; i < 4; ++i) gx[mt][dt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < K / 16; ++ks) {
        uint32_t bz[4], bg[4];
        rm::load_b_kn(bz, stz, kLDS, ks * 16, 0, lane);  // Z^T [k][d]
        rm::load_b_kn(bg, stg, kLDS, ks * 16, 0, lane);  // g_Z^T [k][d]
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t ya[4];
          rm::load_a(ya, ys, S::LDY, mt * 16, ks * 16, lane);  // Y [n][k]
          rm::mma_bf16(gx[mt][0], gfa[mt][ks], bz[0], bz[1]);
          rm::mma_bf16(gx[mt][1], gfa[mt][ks], bz[2], bz[3]);
          rm::mma_bf16(gx[mt][0], ya, bg[0], bg[1]);
          rm::mma_bf16(gx[mt][1], ya, bg[2], bg[3]);
        }
      }
#pragma unroll
      for (int lt = 0; lt < LT; ++lt) {
        uint32_t bl[4];
        rm::load_b_kn(bl, gls, ldx, lt * 16, kd, lane);  // g_L [l][d]
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t wa[4];
          rm::load_a(wa, wts, S::LDW, mt * 16, lt * 16, lane);  // W^T [n][l]
          rm::mma_bf16(gx[mt][0], wa, bl[0], bl[1]);
          rm::mma_bf16(gx[mt][1], wa, bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int dt = 0; dt < 2; ++dt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = mt * 16 + g + 8 * half;
            if (row >= n) continue;
            const long long off = (long long)row * d + kd + dt * 8 + 2 * t;
            const float2 r = rm::unpack_bf16x2(res[mt][dt][half]);
            *reinterpret_cast<uint32_t*>(gxe + off) =
                pack(gx[mt][dt][2 * half] + r.x, gx[mt][dt][2 * half + 1] + r.y);
          }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int dt = 0; dt < 2; ++dt)
#pragma unroll
          for (int half = 0; half < 2; ++half) res[mt][dt][half] = res_next[mt][dt][half];
      __syncwarp();  // the staged chunks are read before the next overwrites them
    }
  }

  // the block's partials: g_Y and g_W summed over the warps in warp order
  // (over the X buffers), then g_scale and g_shift likewise
  __syncthreads();
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = mt * 16 + g + 8 * (i >> 1), col = 2 * t + (i & 1);
#pragma unroll
          for (int nt = 0; nt < K / 8; ++nt) {
            float* p = red + row * K + nt * 8 + col;
            *p = wi == 0 ? gy[mt][nt][i] : *p + gy[mt][nt][i];
          }
#pragma unroll
          for (int nt = 0; nt < S::LP / 8; ++nt) {
            float* p = red + kNP * K + row * S::LP + nt * 8 + col;
            *p = wi == 0 ? gw[mt][nt][i] : *p + gw[mt][nt][i];
          }
        }
    }
    __syncthreads();
  }
  float* out = partials + (long long)blockIdx.x * S::kCols;
  for (int i = threadIdx.x; i < S::kRed; i += blockDim.x) out[i] = red[i];
  for (int i = threadIdx.x; i < kNP * K; i += blockDim.x) {
    float sc = 0.f, sh = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      sc += acc0[wi * 2 * kNP * K + i];
      sh += acc0[wi * 2 * kNP * K + kNP * K + i];
    }
    out[S::kRed + i] = sc;
    out[S::kRed + kNP * K + i] = sh;
  }
}

// block 32 x kSumRows: thread (x, y) sums rows y, y + kSumRows, ... of column
// 32 blockIdx.x + x of the partials, then thread (x, 0) the kSumRows sums in
// order, and writes the column to its grad
template <int K, int LT>
__global__ void __launch_bounds__(32 * kSumRows)
    wukong_fm_grad_sum_kernel(const float* __restrict__ partials, float* __restrict__ g_y,
                              float* __restrict__ g_w, float* __restrict__ g_scale, float* __restrict__ g_shift,
                              int p, int n, int n_l) {
  using S = Shape<K, LT>;
  __shared__ float sums[kSumRows][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (c < S::kCols)
    for (int i = ty; i < p; i += kSumRows) s += partials[(long long)i * S::kCols + c];
  sums[ty][tx] = s;
  __syncthreads();
  if (ty != 0 || c >= S::kCols) return;
  float v = sums[0][tx];
#pragma unroll
  for (int k = 1; k < kSumRows; ++k) v += sums[k][tx];
  if (c < kNP * K) {
    if (c / K < n) g_y[c] = v;
  } else if (c < S::kRed) {
    const int r = (c - kNP * K) / S::LP, col = (c - kNP * K) % S::LP;
    if (r < n && col < n_l) g_w[r * n_l + col] = v;
  } else if (c < S::kRed + kNP * K) {
    if (c - S::kRed < n * K) g_scale[c - S::kRed] = v;
  } else if (c - S::kRed - kNP * K < n * K) {
    g_shift[c - S::kRed - kNP * K] = v;
  }
}

size_t fwd_smem(int k, int lp, int d) {
  return (size_t)(kNP * (k + 8) + kNP * (lp + 8) + kWarps * 2 * kNP * (d + 8)) * sizeof(bf16);
}

size_t bwd_smem(int k, int lp, int d) {
  const size_t warp_elems = (size_t)(kNP * (d + 8) + lp * (d + 8) + kNP * (k + 8) + 2 * k * kLDS);
  return (kNP * (k + 8) + kNP * (lp + 8) + kWarps * warp_elems) * sizeof(bf16) +
         (size_t)kWarps * 2 * kNP * k * sizeof(float);
}

int partial_rows(int b) { return (b + kBwdPerBlock - 1) / kBwdPerBlock; }

template <int K, int LT>
int launch_fwd(const void* x, const void* y, const void* w, const void* scale, const void* shift, void* a, void* l,
               void* mean, void* rstd, int b, int n, int d, int n_l, float eps, cudaStream_t s) {
  const size_t smem = fwd_smem(K, 16 * LT, d);
  cudaError_t e = cudaFuncSetAttribute(wukong_fm_fwd_kernel<K, LT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  // persistent warps: as many blocks as the card holds at once, each warp
  // walking the examples a grid's warps apart
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wukong_fm_fwd_kernel<K, LT>, kWarps * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = std::min<long long>((b + kWarps - 1) / kWarps, (long long)sms * std::max(per_sm, 1));
  wukong_fm_fwd_kernel<K, LT><<<(unsigned)blocks, kWarps * 32, smem, s>>>(
      (const bf16*)x, (const bf16*)y, (const bf16*)w, (const float*)scale, (const float*)shift, (bf16*)a, (bf16*)l,
      (float*)mean, (float*)rstd, b, n, d, n_l, eps);
  return (int)cudaGetLastError();
}

template <int K, int LT>
int launch_bwd(const void* x, const void* y, const void* w, const void* scale, const void* mean, const void* rstd,
               const void* g_a, const void* g_s, const void* g_res, void* g_x, void* partials, void* g_y, void* g_w,
               void* g_scale, void* g_shift, int b, int n, int d, int n_l, int m, int n_f, cudaStream_t s) {
  const int p = partial_rows(b);
  if (p > 0) {
    const size_t smem = bwd_smem(K, 16 * LT, d);
    cudaError_t e = cudaFuncSetAttribute(wukong_fm_bwd_kernel<K, LT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    wukong_fm_bwd_kernel<K, LT><<<p, kWarps * 32, smem, s>>>(
        (const bf16*)x, (const bf16*)y, (const bf16*)w, (const float*)scale, (const float*)mean,
        (const float*)rstd, (const bf16*)g_a, (const bf16*)g_s, (const bf16*)g_res, (bf16*)g_x, (float*)partials, b,
        n, d, n_l, m, n_f);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  using S = Shape<K, LT>;
  wukong_fm_grad_sum_kernel<K, LT><<<(S::kCols + 31) / 32, dim3(32, kSumRows), 0, s>>>(
      (const float*)partials, (float*)g_y, (float*)g_w, (float*)g_scale, (float*)g_shift, p, n, n_l);
  return (int)cudaGetLastError();
}

bool shape_ok(int b, int n, int d, int k, int n_l) {
  return b >= 0 && n >= 1 && n <= kNP && (k == 16 || k == 32) && n_l >= 1 && n_l <= 32 && d >= 16 && d <= 256 &&
         d % 16 == 0;
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

}  // namespace

// Floats of rm_wukong_fm_backward's partials for b examples, or -1.
extern "C" long long rm_wukong_fm_partial_floats(int b, int k, int n_l) {
  if (b < 0 || (k != 16 && k != 32) || n_l < 1 || n_l > 32) return -1;
  const int lp = n_l <= 16 ? 16 : 32;
  // at least one row: the grad sum kernel reads none for b = 0, but the
  // buffer is never empty
  const long long cols = (long long)kNP * k + kNP * lp + 2 * kNP * k;
  return (long long)(partial_rows(b) > 0 ? partial_rows(b) : 1) * cols;
}

// x [b, n, d] bf16, y [n, k] bf16, w [n, n_l] bf16 (W_L^T), scale, shift
// [n k] f32 -> a [b, n k] bf16, l [b, n_l, d] bf16, mean, rstd [b] f32.
// x 16-byte aligned; n <= 32, k 16 or 32, n_l <= 32, d a multiple of 16 up to 256.
extern "C" int rm_wukong_fm_forward(int device, const void* x, const void* y, const void* w, const void* scale,
                                    const void* shift, void* a, void* l, void* mean, void* rstd, int b, int n, int d,
                                    int k, int n_l, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!shape_ok(b, n, d, k, n_l) || !aligned16(x)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 32)
    return n_l <= 16 ? launch_fwd<32, 1>(x, y, w, scale, shift, a, l, mean, rstd, b, n, d, n_l, eps, s)
                     : launch_fwd<32, 2>(x, y, w, scale, shift, a, l, mean, rstd, b, n, d, n_l, eps, s);
  return n_l <= 16 ? launch_fwd<16, 1>(x, y, w, scale, shift, a, l, mean, rstd, b, n, d, n_l, eps, s)
                   : launch_fwd<16, 2>(x, y, w, scale, shift, a, l, mean, rstd, b, n, d, n_l, eps, s);
}

// fm_forward's inputs, its mean and rstd, g_a [b, n k] bf16, g_s [b, m, d]
// bf16 (l's cotangent its rows n_f .. n_f + n_l), g_res [b, n, d] bf16 ->
// g_x [b, n, d] bf16, partials (scratch, rm_wukong_fm_partial_floats), g_y
// [n, k], g_w [n, n_l], g_scale, g_shift [n k] f32. x, g_s, g_res 16-byte
// aligned.
extern "C" int rm_wukong_fm_backward(int device, const void* x, const void* y, const void* w, const void* scale,
                                     const void* mean, const void* rstd, const void* g_a, const void* g_s,
                                     const void* g_res, void* g_x, void* partials, void* g_y, void* g_w,
                                     void* g_scale, void* g_shift, int b, int n, int d, int k, int n_l, int m,
                                     int n_f, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!shape_ok(b, n, d, k, n_l) || n_f < 0 || n_f + n_l > m || !aligned16(x) || !aligned16(g_s) ||
      !aligned16(g_res))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 32)
    return n_l <= 16 ? launch_bwd<32, 1>(x, y, w, scale, mean, rstd, g_a, g_s, g_res, g_x, partials, g_y, g_w,
                                         g_scale, g_shift, b, n, d, n_l, m, n_f, s)
                     : launch_bwd<32, 2>(x, y, w, scale, mean, rstd, g_a, g_s, g_res, g_x, partials, g_y, g_w,
                                         g_scale, g_shift, b, n, d, n_l, m, n_f, s);
  return n_l <= 16 ? launch_bwd<16, 1>(x, y, w, scale, mean, rstd, g_a, g_s, g_res, g_x, partials, g_y, g_w,
                                       g_scale, g_shift, b, n, d, n_l, m, n_f, s)
                   : launch_bwd<16, 2>(x, y, w, scale, mean, rstd, g_a, g_s, g_res, g_x, partials, g_y, g_w,
                                       g_scale, g_shift, b, n, d, n_l, m, n_f, s);
}
