// Lazy Adam from a sorted id stream with duplicates, in place.
//
// Replaces: recmodels_tpu/embedding/pallas_update.py::sorted_adam_update_packed
// (the TPU's packed [n_tiles, d, tr] layout, with a count feature that marks
// the touched rows). The port keeps a plain row-major [R, d] f32 table with
// its moments m and v ([R] for dim-1 tables), as csrc/adagrad_update.cu does.
//
// Contract (pallas_update.py's and optim.sparse_adam's, and the plain version's
// in recmodels_tpu_torch/embedding/update.py): for each distinct id k < R of
// the sorted stream, in every column,
//   g    = sum of the id's grads, in f32, in stream order (from 0)
//   m[k] = b1*m[k] + (1-b1)*g
//   v[k] = b2*v[k] + (1-b2)*g*g
//   w[k] = w[k] + (-lr*(m[k]/bc1)) / (sqrt(v[k]/bc2) + eps)
// where lr, bc1 = 1 - b1^t and bc2 = 1 - b2^t are read from device memory,
// computed on the card from the global step tensor, as the TPU kernel reads
// its [lr, 1-b1^t, 1-b2^t, 0] block. A position's grad is its row of the
// stream's grads, or, for a multi-hot group, its bag's row of the pooled
// grads read through grad_index (as in csrc/adagrad_update.cu). A row is touched when its id is in the
// stream, whatever its grads sum to: an id whose grads sum to 0 still decays
// its moments (lazy Adam's membership rule). Rows not in the stream keep
// their bits; ids < 0 or >= R (sentinels) are skipped; bf16 grads widen
// exactly to f32. Every operation is an explicitly rounded IEEE intrinsic, so
// nvcc contracts nothing into an FMA and the result equals the CPU plain
// version bit for bit given the same sum order and the same f32 constants.
//
// Bound on this card: bytes. It reads the ids and the grads and reads and
// writes each touched row of the table, m and v; at d = 16 the 64-byte rows
// are whole sectors, so the sector floor is the byte bound. The card moves
// such scattered rows well below its peak rate: a bare read-modify-write of
// the same rows of three arrays takes about 1.6 times the byte bound
// (recmodels_tpu_torch/probes/sparse_update_rows.py).
//
// Design (sorted_update_common.cuh, shared with the Adagrad kernel): the TPU
// kernel sweeps the whole table with a one-hot MXU contraction. A first port
// gave each (stream position, column) a thread that walked its run when it
// started one, three dependent trips to memory a thread. Here 128 threads
// own a tile of 32 positions: one coalesced read of its ids, a ballot for
// the run starts, then each thread loads four columns of m, v and the table
// (float4, at d = 16 with aligned bases) before it sums the run and updates
// them. No atomics, no cap on a run.

#include "sorted_update_common.cuh"

namespace {

struct AdamStep {
  static constexpr int kArrays = 3;   // table, m, v
  static constexpr int kScalars = 3;  // lr, bc1, bc2, from device memory
  float lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps;
  __device__ __forceinline__ void bind(const float* s) { lr = s[0], bc1 = s[1], bc2 = s[2]; }
  // s: one column of the table, m and v
  __device__ __forceinline__ void apply(float g, float (&s)[kArrays]) const {
    const float mn = __fadd_rn(__fmul_rn(b1, s[1]), __fmul_rn(one_minus_b1, g));
    const float vn = __fadd_rn(__fmul_rn(b2, s[2]), __fmul_rn(__fmul_rn(one_minus_b2, g), g));
    s[1] = mn;
    s[2] = vn;
    const float num = __fmul_rn(-lr, __fdiv_rn(mn, bc1));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, bc2)), eps);
    s[0] = __fadd_rn(s[0], __fdiv_rn(num, den));
  }
};

}  // namespace

// table, m, v [rows, d] f32 (d = 1 for a dim-1 table), ids [n] i32 ascending,
// grads (bf16 when grads_bf16, else f32): [n, d] in the ids' order when
// grad_index is null, else pooled [P, d] with grad_index [n] i32 the row of
// each position;
// scalars the f32 block [lr, bc1, bc2] in device memory, computed on the
// card from the step tensor (pallas_update.py's [lr, 1-b1^t, 1-b2^t, 0]).
// The optimizer's constants arrive by value as f32: one_minus_b1 = f32(1 -
// b1) rounded from the double, as JAX rounds its Python constants.
extern "C" int rm_adam_update(int device, void* table, void* m, void* v,
                              const void* ids, const void* grads,
                              const void* grad_index, long long n,
                              long long rows, int d, int grads_bf16,
                              const void* scalars, float b1, float one_minus_b1,
                              float b2, float one_minus_b2, float eps,
                              void* stream) {
  sorted_update::Args<AdamStep> a{};
  a.state[0] = (float*)table;
  a.state[1] = (float*)m;
  a.state[2] = (float*)v;
  a.ids = (const int*)ids;
  a.grads = grads;
  a.n = n;
  a.rows = rows;
  a.d = d;
  a.op = AdamStep{0.f, 0.f, 0.f, b1, one_minus_b1, b2, one_minus_b2, eps};
  a.scalars = (const float*)scalars;
  return sorted_update::launch(a, (const int*)grad_index, grads_bf16, device, stream);
}
