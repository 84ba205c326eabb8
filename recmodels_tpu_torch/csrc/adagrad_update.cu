// Sparse Adagrad from a sorted id stream with duplicates, in place.
//
// Replaces: recmodels_tpu/embedding/pallas_update.py::
// sorted_adagrad_update_packed (the TPU's packed [n_tiles, d, tr] layout) and
// ::sorted_adagrad_update (its 2-D [d, R] layout and dim-1 tables): the port
// keeps one layout, a plain row-major [R, d] f32 table and accumulator
// ([R] for dim-1), so one kernel serves both.
//
// Contract (pallas_update.py's, and the plain version's in
// recmodels_tpu_torch/embedding/update.py): for each distinct id k < R of the
// sorted stream, in every column,
//   g      = sum of the id's grads, in f32, in stream order (from 0)
//   acc[k] = acc[k] + g*g
//   w[k]   = w[k] - lr*g / (sqrt(acc[k]) + eps)
// with lr read from device memory (as the TPU kernel reads it from SMEM).
// A position's grad is its row of the stream's grads [n, d], or, for a
// multi-hot group, its bag's row of the pooled grads [P, d] (grad_index [n]:
// the bag of each position), read where it lies: the same values summed in
// the same order, so the pooled call gives the bits of the stream call on
// the expanded grads.
// Rows not in the stream are not touched (bit-identical); ids < 0 or >= R
// (sentinels) are skipped; bf16 grads widen exactly to f32. Every operation
// is an explicitly rounded IEEE intrinsic, so nvcc contracts nothing into an
// FMA and the result equals the CPU plain version bit for bit given the same
// sum order.
//
// Bound on this card: bytes. At the training shape (425,984 grads of 17
// bf16 into a 2,600,960 x 17 table) it reads the ids and the 14.5 MB of
// grads and reads and writes each touched row of the table and of acc. The
// 68-byte rows straddle 32-byte sectors, so the sectors the stream touches
// come to more than its bytes (chip_smoke.py prints both bounds); and the
// card moves such scattered rows well below its peak rate: a bare
// read-modify-write of the same rows, nothing else, takes over twice the
// byte bound (recmodels_tpu_torch/probes/sparse_update_rows.py). On a
// multi-hot stream (DLRM-DCNv2: 3,506,176 ids in 16,384 x 26 bags, d = 128)
// each id's grad row is read from the 109 MB of pooled grads; the sorted
// stream visits one slot's bags (4 MB) at a time, so a bag's repeated reads
// can hit L2, and no 0.9 GB expanded copy is written and read back.
//
// Design (sorted_update_common.cuh, shared with the lazy-Adam kernel): the
// TPU kernel sweeps the whole table and sums duplicates with a one-hot MXU
// contraction, because a TPU scatter is serial. Hopper reads and writes rows
// where they are. A first port gave each (stream position, column) a thread
// that loaded its id and its neighbour's, returned unless it started a run,
// and walked the run: a 64-bit division and three dependent trips to memory
// a thread, and 17 idle threads for each duplicate position. Here 256
// threads own a tile of 32 positions: one coalesced read of its ids, a
// ballot for the run starts, then each thread issues the acc and table loads
// of two (run, column) elements before it sums their runs and updates them.
// No atomics, no cap on a run.

#include "sorted_update_common.cuh"

namespace {

struct AdagradStep {
  static constexpr int kArrays = 2;   // table, acc
  static constexpr int kScalars = 1;  // lr, from device memory
  float lr, eps;
  __device__ __forceinline__ void bind(const float* s) { lr = s[0]; }
  // s: one column of the table and of acc
  __device__ __forceinline__ void apply(float g, float (&s)[kArrays]) const {
    const float a = __fadd_rn(s[1], __fmul_rn(g, g));
    s[1] = a;
    s[0] = __fsub_rn(s[0], __fdiv_rn(__fmul_rn(lr, g), __fadd_rn(__fsqrt_rn(a), eps)));
  }
};

}  // namespace

// table, acc [rows, d] f32 (d = 1 for a dim-1 table), ids [n] i32 ascending,
// grads (bf16 when grads_bf16, else f32): [n, d] in the ids' order when
// grad_index is null, else pooled [P, d] with grad_index [n] i32 the row of
// each position; lr one f32 in device memory (pallas_update.py reads it
// from SMEM).
extern "C" int rm_adagrad_update(int device, void* table, void* acc,
                                 const void* ids, const void* grads,
                                 const void* grad_index, long long n,
                                 long long rows, int d,
                                 int grads_bf16, const void* lr, float eps,
                                 void* stream) {
  sorted_update::Args<AdagradStep> a{};
  a.state[0] = (float*)table;
  a.state[1] = (float*)acc;
  a.ids = (const int*)ids;
  a.grads = grads;
  a.n = n;
  a.rows = rows;
  a.d = d;
  a.op = AdagradStep{0.f, eps};
  a.scalars = (const float*)lr;
  return sorted_update::launch(a, (const int*)grad_index, grads_bf16, device, stream);
}
