"""Synthetic Criteo batches generated on the device from the step counter.

Port of ``recmodels_tpu/data/device_synth.py``: ``make_device_batch_fn``
returns ``batch_fn(step)``, a pure function of a 0-d int32 step tensor that
draws batch ``step`` of the planted-signal task where the step lies, with no
host producer and no host->device batch bytes. A CPU step runs the plain
PyTorch version below; a CUDA step launches ``csrc/device_synth.cu`` (two
launches, one call) or raises. The kernel reads the step from device memory
when it runs, so a CUDA graph of "generate, then train" draws the next batch
on each replay (``Engine.jit_train_scan_gen``).

The stream is JAX's own, not a look-alike. JAX 0.9's default PRNG is
``threefry2x32`` with ``jax_threefry_partitionable`` on, and in that mode
every draw is a pure function of (key, flat element index):

* ``key(seed)`` is the word pair (0, seed);
* ``fold_in(key, s)`` and key ``i`` of ``split(key, n)`` are
  ``threefry2x32(key, (0, s))`` and ``threefry2x32(key, (0, i))``;
* element j of ``uniform(key, shape)`` is the XOR of the two words of
  ``threefry2x32(key, (j >> 32, j & 0xFFFFFFFF))``, whose top 23 bits become
  the mantissa of a float in [1, 2), minus 1.

The functions here are written from the Threefry-2x32-20 definition (Salmon
et al., SC 2011) in that scheme, in int64 words masked to 32 bits (PyTorch
on the CPU has no uint32 right shift), and give ``jax.random``'s bits.
The task's weights (``dense_w``, ``slot_proj``) are the same numpy draws as
JAX's. So ids equal JAX's, dense values agree to the last ulp or two of
``log1p``, and a label differs only where its uniform lies within rounding
of its probability (``tests/test_torch_device_synth.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.ops.cuda.launch import cuda_device, device_and_stream, require

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_GOLDEN = 2654435761  # bucket_weight's multiplier (Knuth's)
_SLOT_STRIDE = 97531
# the rows kernel's examples a block (csrc/device_synth.cu kRows) and the
# dynamic shared memory it may fill, kRows * (n_dense + n_slots + 1) floats
# (kMaxSmem: within the 48 KB a block gets without opting in)
KERNEL_ROWS = 64
KERNEL_SMEM_BYTES = 46 * 1024


# ------------------------------------------------------------- threefry
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 words x < 2^32, with no int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds of the counter words (x0, x1) under the
    key (k0, k1): int64 tensors (or ints) holding 32-bit words; returns the
    two output words, broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def seed_words(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)``'s two words, (0, seed mod 2^32), for a seed
    in the int32 range (JAX's without x64)."""
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return 0, seed & M32


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)``: its words as [2] int64 on ``device``."""
    return torch.tensor(seed_words(seed), dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``: ``data`` an int or a 0-d integer
    tensor (read on its device, no host sync), taken mod 2^32."""
    data = torch.as_tensor(data, device=k.device).to(torch.int64) & M32
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(data), data)
    return torch.stack([y0, y1])


def split(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(k, n)``: [n, 2] int64 keys."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=1)


def random_bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """The 32-bit draws 0..n-1 of key ``k`` (int64 words): JAX's
    ``_threefry_random_bits_partitionable`` at bit width 32."""
    j = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[0], k[1], j >> 32, j & M32)
    return y0 ^ y1


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """JAX's f32 uniform of 32 random bits: the top 23 as the mantissa of
    [1, 2), minus 1 (exact: (bits >> 9) * 2^-23)."""
    return (bits >> 9).to(torch.float32) * 2.0**-23


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` in f32 on [0, 1)."""
    return bits_to_unit(random_bits(k, math.prod(shape))).reshape(shape)


# -------------------------------------------------------------- the task
def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's 32-bit finalizer (xorshift-multiply) on int64
    words < 2^32, bit for bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def bucket_weight(ids: torch.Tensor) -> torch.Tensor:
    """The planted per-(slot, bucket) weight of ids [B, S] in [-1, 1): the
    high 24 bits of ``_mix32(id * 2654435761 + slot * 97531)`` as an exact
    f32 uniform, times 2, minus 1."""
    slot_c = (torch.arange(ids.shape[1], dtype=torch.int64, device=ids.device) * _SLOT_STRIDE) & M32
    h = _mix32((_mul32(ids.to(torch.int64) & M32, _GOLDEN) + slot_c[None, :]) & M32)
    u = (h >> 8).to(torch.float32) * 2.0**-24
    return (u - 0.5) * 2.0


def planted_logit(dense: torch.Tensor, bw: torch.Tensor, dense_w: torch.Tensor,
                  slot_proj: torch.Tensor) -> torch.Tensor:
    """The task's logit before centring, in JAX's order of operations: the
    dense linear term, half the bucket weights' sum, and 0.15 times the
    low-rank pairwise term of the slots' projections."""
    logit = dense @ dense_w
    logit = logit + bw.sum(dim=1) * 0.5
    emb = bw[:, :, None] * slot_proj[None, :, :]
    s = emb.sum(dim=1)
    return logit + 0.5 * ((s * s).sum(dim=1) - (emb * emb).sum(dim=(1, 2))) * 0.15


def synth_batch_reference(step: torch.Tensor, seed: int, dense_w: torch.Tensor, slot_proj: torch.Tensor,
                          vocab: torch.Tensor, batch_size: int, with_bits: bool = False):
    """Plain version of the batch: (dense [B, n_dense] f32, ids [B, n_slots]
    int32, labels [B] f32) of batch ``step`` (a 0-d int32 tensor on the
    inputs' device, read there: no host sync) of the stream ``seed``; with
    ``with_bits`` also the raw draws [B, 2 n_dense + n_slots + 1] (int64
    words: dense 1, dense 2, ids, label)."""
    b, nd, ns = batch_size, dense_w.shape[0], vocab.shape[0]
    # the batch's keys: dense draws 1 and 2, ids, labels
    kd1, kd2, ki, kl = split(fold_in(key(seed, step.device), step), 4)
    bits = [random_bits(k, b * n).reshape(b, n) for k, n in ((kd1, nd), (kd2, nd), (ki, ns), (kl, 1))]
    u1, u2, ui, ul = (bits_to_unit(x) for x in bits)
    # Gamma(2, 20) as 20 (E1 + E2), then log1p, as the host stream
    e1 = -torch.log1p(-u1)
    e2 = -torch.log1p(-u2)
    dense = torch.log1p(20.0 * (e1 + e2))
    ids = torch.minimum((ui * vocab).to(torch.int32), vocab - 1)
    logit = planted_logit(dense, bucket_weight(ids), dense_w, slot_proj)
    logit = logit - logit.mean()
    labels = (ul[:, 0] < torch.sigmoid(logit)).to(torch.float32)
    if with_bits:
        return dense, ids, labels, torch.cat(bits, dim=1)
    return dense, ids, labels


def synth_batch(step: torch.Tensor, seed: int, dense_w: torch.Tensor, slot_proj: torch.Tensor,
                vocab: torch.Tensor, batch_size: int, with_bits: bool = False):
    """Batch ``step`` as ``synth_batch_reference`` gives it: a CPU step
    takes the plain version; a CUDA step launches the kernel, which reads
    the step from device memory when it runs (or raises on what it does not
    take). The kernel's draws, ids and bucket weights are the plain
    version's bits, and its dense values those of the card's ``log1pf``;
    its logit sums run in another order, so a label may differ where its
    uniform lies within rounding of its probability. With ``with_bits`` the
    draws come back as int32 (the words' bits)."""
    if step.device.type == "cpu":
        return synth_batch_reference(step, seed, dense_w, slot_proj, vocab, batch_size, with_bits)
    dev_t = cuda_device(step, "synth_batch")
    require("synth_batch step", step, (torch.int32,), 0, dev_t, align=4)
    require("synth_batch dense_w", dense_w, (torch.float32,), 1, dev_t, align=4)
    require("synth_batch slot_proj", slot_proj, (torch.float32,), 2, dev_t, align=4)
    require("synth_batch vocab", vocab, (torch.int32,), 1, dev_t, align=4)
    b, nd, ns, sd = batch_size, dense_w.shape[0], vocab.shape[0], slot_proj.shape[1]
    if slot_proj.shape[0] != ns:
        raise ValueError(f"synth_batch: slot_proj {tuple(slot_proj.shape)} for {ns} slots")
    if b < 1:
        raise ValueError(f"synth_batch: batch_size {b}")
    if KERNEL_ROWS * (nd + ns + 1) * 4 > KERNEL_SMEM_BYTES:
        raise ValueError(f"synth_batch: {nd} dense and {ns} slots exceed the kernel's shared memory")
    n_blocks = -(-b // KERNEL_ROWS)
    dense = torch.empty((b, nd), dtype=torch.float32, device=dev_t)
    ids = torch.empty((b, ns), dtype=torch.int32, device=dev_t)
    labels = torch.empty((b,), dtype=torch.float32, device=dev_t)
    scratch = torch.empty((2 * b + n_blocks,), dtype=torch.float32, device=dev_t)
    bits = torch.empty((b, 2 * nd + ns + 1), dtype=torch.int32, device=dev_t) if with_bits else None
    k_hi, k_lo = seed_words(seed)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_device_synth_batch(
        dev, step.data_ptr(), k_hi, k_lo, dense_w.data_ptr(), slot_proj.data_ptr(), vocab.data_ptr(),
        dense.data_ptr(), ids.data_ptr(), labels.data_ptr(), scratch.data_ptr(),
        None if bits is None else bits.data_ptr(), b, nd, ns, sd, stream,
    )
    build.check(err, "synth_batch")
    synth_batch.launches += 1
    if with_bits:
        return dense, ids, labels, bits
    return dense, ids, labels


synth_batch.launches = 0  # kernel launches since the count was last set to 0


# ------------------------------------------------------------ the stream
class DeviceBatchFn:
    """``batch_fn(step) -> (dense [B, n_dense] f32, ids [B, n_slots] int32,
    labels [B] f32)`` on the step's device: batch ``step`` of the stream
    ``seed`` of the planted task ``task_seed``. The task's tensors are put
    on a device at its first batch there (make that first call outside a
    CUDA graph's capture, as the captured steps' eager warm-up does)."""

    def __init__(self, schema: Schema, batch_size: int, seed: int, task_seed: int, signal_dim: int):
        rng = np.random.default_rng(task_seed + 1_000_003)
        self.dense_w = torch.from_numpy(rng.normal(0, 0.6, (schema.n_dense,)).astype(np.float32))
        self.slot_proj = torch.from_numpy(rng.normal(0, 0.7, (schema.n_slots, signal_dim)).astype(np.float32))
        self.vocab = torch.tensor(schema.vocab_sizes, dtype=torch.int32)
        self.batch_size = batch_size
        self.seed = seed
        seed_words(seed)  # a seed outside the int32 range raises here
        self._on: dict = {}  # device -> (dense_w, slot_proj, vocab) there

    def task(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """(dense_w, slot_proj, vocab) on ``device``."""
        if device not in self._on:
            self._on[device] = tuple(t.to(device) for t in (self.dense_w, self.slot_proj, self.vocab))
        return self._on[device]

    def __call__(self, step: torch.Tensor, with_bits: bool = False):
        step = torch.as_tensor(step, dtype=torch.int32)
        return synth_batch(step, self.seed, *self.task(step.device), self.batch_size, with_bits)


def make_device_batch_fn(schema: Schema, batch_size: int, seed: int = 0, task_seed: int = 0,
                         signal_dim: int = 4) -> DeviceBatchFn:
    """``batch_fn(step)`` of JAX's ``make_device_batch_fn`` with the same
    arguments: ``step`` the global batch index, a 0-d int32 tensor on the
    device to generate on (an int means the CPU). The stream is
    deterministic and resumable by the step alone."""
    return DeviceBatchFn(schema, batch_size, seed, task_seed, signal_dim)


class DeviceSynthSource:
    """The device stream's cursor, ``state()``/``set_state()`` as the host
    sources have them; batches come from ``batch_fn`` on the device, never
    from here."""

    def __init__(self, schema: Schema, batch_size: int, seed: int = 0, task_seed: int = 0):
        self.schema = schema
        self.batch_size = batch_size
        self.seed = seed
        self.task_seed = task_seed
        self._step = 0

    def state(self) -> dict:
        return {"step": self._step}

    def set_state(self, state: dict) -> None:
        self._step = int(state["step"])
