// A synthetic Criteo batch generated on the card from the step counter.
//
// Replaces no TPU kernel: the JAX package draws this batch inside its
// compiled step with jax.random (recmodels_tpu/data/device_synth.py,
// make_device_batch_fn's batch_fn), which XLA fuses. The port's plain
// PyTorch version (data/device_synth.py) is some 160 elementwise launches of
// int64 words a batch; this kernel is one pass over the draws and a short
// second one for the labels, so the training loop's batches cost the card a
// few microseconds and the host nothing.
//
// What it computes, bit for bit the plain version's draws: the batch's four
// keys from the stream's seed words and the step, read from device memory
// when the kernel runs (so a replayed CUDA graph draws the next batch):
// fold_in(key(seed), step), then split into 4; JAX's partitionable
// threefry2x32 draws of each key by flat element index (dense 1 and 2
// [B, n_dense], ids [B, n_slots], labels [B]); dense = log1p(20 (e1 + e2))
// with e = -log1p(-u); ids = min(int(u * vocab), vocab - 1); the planted
// logit (the dense linear term, the bucket weights of _mix32 and their
// low-rank pairwise term); its mean over the batch; the labels u < sigmoid.
// Built without --use_fast_math (build.py), with log1pf and expf as
// PyTorch's CUDA ops use them.
//
// Bound on this card: integer operations. A draw is one threefry2x32 (20
// rounds of add, rotate, xor and 5 key injections, about 80 operations); a
// batch of 16,384 needs 53 draws an example, about 74 M operations, against
// 2.6 MB of output.
//
// Design: the rows kernel gives a block kRows examples and its kThreads
// threads the block's draws in flat order (a thread a draw, so a warp's
// stores are coalesced); dense values and bucket weights go to shared
// memory, then a thread an example sums its logit, and the first warp sums
// the block's logits into a partial. The labels kernel sums the partials
// (each block the same sum in the same order, so the same mean), centres
// each logit and draws its label. No atomics: every sum has a fixed order
// (a thread's strided share, then a shuffle tree), so captured and eager
// batches agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;       // examples a block (device_synth.KERNEL_ROWS)
constexpr int kThreads = 256;
constexpr int kLabelThreads = 256;
constexpr int kMaxSmem = 46 * 1024;  // device_synth.KERNEL_SMEM_BYTES

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// Threefry-2x32, 20 rounds (Salmon et al., SC 2011), as jax._src.prng's
// _threefry2x32_lowering: (x0, x1) is the counter, (k0, k1) the key.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define RM_TF_ROUND(r) \
  x0 += x1;            \
  x1 = rotl(x1, r) ^ x0;
#define RM_TF_ROUNDS_A RM_TF_ROUND(13) RM_TF_ROUND(15) RM_TF_ROUND(26) RM_TF_ROUND(6)
#define RM_TF_ROUNDS_B RM_TF_ROUND(17) RM_TF_ROUND(29) RM_TF_ROUND(16) RM_TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  RM_TF_ROUNDS_A
  x0 += k1;
  x1 += k2 + 1u;
  RM_TF_ROUNDS_B
  x0 += k2;
  x1 += k0 + 2u;
  RM_TF_ROUNDS_A
  x0 += k0;
  x1 += k1 + 3u;
  RM_TF_ROUNDS_B
  x0 += k1;
  x1 += k2 + 4u;
  RM_TF_ROUNDS_A
  x0 += k2;
  x1 += k0 + 5u;
#undef RM_TF_ROUNDS_B
#undef RM_TF_ROUNDS_A
#undef RM_TF_ROUND
}

// 32 random bits: draw j of key (k0, k1), the two words XORed
__device__ __forceinline__ uint32_t draw(uint32_t k0, uint32_t k1, unsigned long long j) {
  uint32_t x0 = (uint32_t)(j >> 32), x1 = (uint32_t)j;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// JAX's f32 uniform: the top 23 bits as the mantissa of [1, 2), minus 1
__device__ __forceinline__ float unit(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// the planted weight of slot s's bucket id, in [-1, 1): the high 24 bits of
// the JAX package's _mix32 finalizer as an exact f32 uniform, times 2, minus 1
__device__ __forceinline__ float bucket_weight(int id, int s) {
  uint32_t x = (uint32_t)id * 2654435761u + (uint32_t)s * 97531u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  const float u = __fmul_rn((float)(x >> 8), 1.0f / 16777216.0f);
  return __fmul_rn(__fsub_rn(u, 0.5f), 2.0f);
}

// this thread's share of x[0, n) in a fixed order: x[t], x[t + stride], ...
__device__ __forceinline__ float strided_sum(const float* x, int n, int stride) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < n; i += stride) v = __fadd_rn(v, x[i]);
  return v;
}

// the sum of a warp's 32 values in a fixed tree order, in lane 0
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    synth_rows(const int* __restrict__ step, uint32_t seed_hi, uint32_t seed_lo,
               const float* __restrict__ dense_w, const float* __restrict__ slot_proj,
               const int* __restrict__ vocab, float* __restrict__ dense, int* __restrict__ ids,
               float* __restrict__ logit, float* __restrict__ u_label, float* __restrict__ partial,
               uint32_t* __restrict__ bits, int b, int nd, int ns, int sd) {
  extern __shared__ float smem[];
  __shared__ uint32_t keys[8];  // dense 1, dense 2, ids, labels
  float* s_dense = smem;                // [kRows, nd]
  float* s_bw = s_dense + kRows * nd;   // [kRows, ns]
  float* s_logit = s_bw + kRows * ns;   // [kRows]
  if (threadIdx.x < 4) {
    uint32_t k0 = 0, k1 = (uint32_t)*step;  // fold_in(key(seed), step)
    threefry2x32(seed_hi, seed_lo, k0, k1);
    uint32_t y0 = 0, y1 = threadIdx.x;  // split(., 4)[threadIdx.x]
    threefry2x32(k0, k1, y0, y1);
    keys[2 * threadIdx.x] = y0;
    keys[2 * threadIdx.x + 1] = y1;
  }
  __syncthreads();
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, b - row0);
  const int width = 2 * nd + ns + 1;  // a row of the raw draws

  for (int e = threadIdx.x; e < rows * nd; e += kThreads) {
    const unsigned long long j = (unsigned long long)row0 * nd + e;
    const uint32_t a1 = draw(keys[0], keys[1], j), a2 = draw(keys[2], keys[3], j);
    const float e1 = -log1pf(-unit(a1)), e2 = -log1pf(-unit(a2));
    const float v = log1pf(__fmul_rn(20.0f, __fadd_rn(e1, e2)));
    dense[j] = v;
    s_dense[e] = v;
    if (bits) {
      const int r = e / nd, c = e - r * nd;
      bits[(long long)(row0 + r) * width + c] = a1;
      bits[(long long)(row0 + r) * width + nd + c] = a2;
    }
  }
  for (int e = threadIdx.x; e < rows * ns; e += kThreads) {
    const unsigned long long j = (unsigned long long)row0 * ns + e;
    const int r = e / ns, s = e - r * ns;
    const uint32_t a = draw(keys[4], keys[5], j);
    const int v = vocab[s];
    const int id = min((int)__fmul_rn(unit(a), (float)v), v - 1);
    ids[j] = id;
    s_bw[e] = bucket_weight(id, s);
    if (bits) bits[(long long)(row0 + r) * width + 2 * nd + s] = a;
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const uint32_t a = draw(keys[6], keys[7], (unsigned long long)(row0 + r));
    u_label[row0 + r] = unit(a);
    if (bits) bits[(long long)(row0 + r) * width + width - 1] = a;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const float* x = s_dense + r * nd;
    const float* bw = s_bw + r * ns;
    float z = 0.0f;
    for (int c = 0; c < nd; ++c) z = __fadd_rn(z, __fmul_rn(x[c], dense_w[c]));
    float sum_bw = 0.0f;
    for (int s = 0; s < ns; ++s) sum_bw = __fadd_rn(sum_bw, bw[s]);
    z = __fadd_rn(z, __fmul_rn(sum_bw, 0.5f));
    // 0.5 (|sum_s e_s|^2 - sum_s |e_s|^2) of the projections e_s = bw_s p_s
    float sq_of_sum = 0.0f, sum_of_sq = 0.0f;
    for (int d = 0; d < sd; ++d) {
      float acc = 0.0f;
      for (int s = 0; s < ns; ++s) {
        const float em = __fmul_rn(bw[s], slot_proj[s * sd + d]);
        acc = __fadd_rn(acc, em);
        sum_of_sq = __fadd_rn(sum_of_sq, __fmul_rn(em, em));
      }
      sq_of_sum = __fadd_rn(sq_of_sum, __fmul_rn(acc, acc));
    }
    z = __fadd_rn(z, __fmul_rn(__fmul_rn(0.5f, __fsub_rn(sq_of_sum, sum_of_sq)), 0.15f));
    logit[row0 + r] = z;
    s_logit[r] = z;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const float v = warp_sum(strided_sum(s_logit, rows, 32));
    if (threadIdx.x == 0) partial[blockIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kLabelThreads)
    synth_labels(const float* __restrict__ logit, const float* __restrict__ u_label,
                 const float* __restrict__ partial, int n_partial, float* __restrict__ labels, int b) {
  __shared__ float warp_sums[kLabelThreads / 32];
  __shared__ float mean;
  const float v = warp_sum(strided_sum(partial, n_partial, kLabelThreads));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int i = 0; i < kLabelThreads / 32; ++i) t = __fadd_rn(t, warp_sums[i]);
    mean = __fdiv_rn(t, (float)b);
  }
  __syncthreads();
  const int r = blockIdx.x * kLabelThreads + threadIdx.x;
  if (r < b) {
    const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__fsub_rn(logit[r], mean))));
    labels[r] = u_label[r] < p ? 1.0f : 0.0f;
  }
}

}  // namespace

// Batch *step of the stream (seed_hi, seed_lo): dense [b, nd] f32, ids
// [b, ns] int32 and labels [b] f32, from dense_w [nd], slot_proj [ns, sd]
// and vocab [ns]; scratch holds 2 b + ceil(b / kRows) floats; bits, when
// not null, [b, 2 nd + ns + 1] raw draws (dense 1, dense 2, ids, label).
extern "C" int rm_device_synth_batch(int device, const void* step, unsigned int seed_hi,
                                     unsigned int seed_lo, const void* dense_w, const void* slot_proj,
                                     const void* vocab, void* dense, void* ids, void* labels,
                                     void* scratch, void* bits, int b, int nd, int ns, int sd,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long smem = (long long)kRows * (nd + ns + 1) * sizeof(float);
  if (b < 1 || nd < 0 || ns < 0 || sd < 0 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (b + kRows - 1) / kRows;
  float* s = (float*)scratch;
  float *logit = s, *u_label = s + b, *partial = s + 2 * (long long)b;
  synth_rows<<<blocks, kThreads, (size_t)smem, st>>>(
      (const int*)step, seed_hi, seed_lo, (const float*)dense_w, (const float*)slot_proj,
      (const int*)vocab, (float*)dense, (int*)ids, logit, u_label, partial, (uint32_t*)bits, b, nd, ns,
      sd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  synth_labels<<<(b + kLabelThreads - 1) / kLabelThreads, kLabelThreads, 0, st>>>(
      logit, u_label, partial, blocks, (float*)labels, b);
  return (int)cudaGetLastError();
}
