"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` has a plain C interface and includes no PyTorch header,
so ``nvcc`` compiles each in seconds. ``library()`` compiles the sources to
object files in parallel, one ``nvcc`` each, links them into one shared
library under ``recmodels_tpu_torch/_build/<hash>/`` and loads it. The hash
covers the sources and the flags, so an edited source rebuilds and an
unchanged tree loads the library it built before. Building needs the CUDA
toolkit (``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH); nothing here
runs when the package is imported.

The C functions take the device index, raw pointers, sizes and the CUDA
stream, launch on that stream, allocate nothing, and return
``cudaGetLastError()``; ``check`` turns a nonzero code into an exception.

The first ``library()`` adds its host time to the counter ``kernels.load_s``
and 1 to ``kernels.built`` when it ran nvcc (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from recmodels_tpu_torch.utils import profiling

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LOG_NAME = "build.log"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # device, table, ids, out, n, d1, out_bf16, stream
    "rm_gather_rows": [_I, _P, _P, _P, _L, _I, _I, _P],
    # device, table, ids, out, b, n_ids, d, bag offsets (host ints), n_bags, out_bf16, stream
    "rm_bag_gather": [_I, _P, _P, _P, _L, _I, _I, _IP, _I, _I, _P],
    # device, full, x_dm, wide_sum, b, m, d, is_bf16, stream
    "rm_split_fused_rows": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    # device, x0, w1, w2, x1, p1, p2, q, scratch, b, d, m, h1, h2, stream
    "rm_cin2_forward": [_I] + [_P] * 8 + [_I] * 5 + [_P],
    # device, g_dm, g_ws, out, b, m, d, is_bf16, stream
    "rm_split_fused_rows_backward": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    # device, x0, x1, w1, w2, q, g1p, g2p, gx0, gw1, gw2, scratch, b, d, m, h1, h2, stream
    "rm_cin2_backward": [_I] + [_P] * 11 + [_I] * 5 + [_P],
    # device, table, acc, ids, grads, grad_index (null: a stream of grads), n, rows, d,
    # grads_bf16, lr (device f32), eps, stream
    "rm_adagrad_update": [_I, _P, _P, _P, _P, _P, _L, _L, _I, _I, _P, _F, _P],
    # device, table, m, v, ids, grads, grad_index (null: a stream of grads), n, rows, d,
    # grads_bf16, [lr, bc1, bc2] (device f32), b1, 1 - b1, b2, 1 - b2, eps, stream
    "rm_adam_update": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _P] + [_F] * 5 + [_P],
    # device, xk, x0, w2, out, scratch, rows, hk, m, hn, is_bf16, stream
    "rm_cin_layer_forward": [_I] + [_P] * 5 + [_L, _I, _I, _I, _I, _P],
    # device, g, xk, x0, w2, gxk, gx0, gw, scratch, rows, hk, m, hn, stream
    "rm_cin_layer_backward": [_I] + [_P] * 8 + [_L, _I, _I, _I, _P],
    # device, x, out, batch, a, b, elem_bytes, stream
    "rm_transpose_minor2": [_I, _P, _P, _L, _I, _I, _I, _P],
    # device, emb, out, b, f, d, stride_b, stride_f, is_bf16, stream
    "rm_fm_pairwise": [_I, _P, _P, _I, _I, _I, _L, _L, _I, _P],
    # device, x0, w, bias, out, b, d, n_layers, is_bf16, stream
    "rm_dcn_cross_stack": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # device, step (device int32), seed_hi, seed_lo, dense_w, slot_proj, vocab,
    # dense, ids, labels, scratch, bits (or null), b, n_dense, n_slots, signal_dim, stream
    "rm_device_synth_batch": [_I, _P, _U, _U] + [_P] * 8 + [_I] * 4 + [_P],
    # device, z, b, h, rows, n, relu, vec, stream
    "rm_mlp_bias_act": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    # device, g, h (null: no mask), gz, partials, gb, rows, n, g_bf16, vec, stream
    "rm_mlp_act_backward": [_I] + [_P] * 5 + [_I] * 4 + [_P],
    # device, x, y, w, scale, shift, a, l, mean, rstd, b, n, d, k, n_l, eps, stream
    "rm_wukong_fm_forward": [_I] + [_P] * 9 + [_I] * 5 + [_F, _P],
    # device, x, y, w, scale, mean, rstd, g_a, g_s, g_res, g_x, partials, g_y, g_w, g_scale, g_shift,
    # b, n, d, k, n_l, m, n_f, stream
    "rm_wukong_fm_backward": [_I] + [_P] * 15 + [_I] * 7 + [_P],
    # device, h, l, r, scale, shift, s, y, mean, rstd, b, m, n_f, d, eps, stream
    "rm_wukong_ln_forward": [_I] + [_P] * 9 + [_L, _I, _I, _I, _F, _P],
    # device, g, s, mean, rstd, scale, g_s, g_h, partials, g_scale, g_shift, b, m, n_f, d, stream
    "rm_wukong_ln_backward": [_I] + [_P] * 10 + [_L, _I, _I, _I, _P],
}
# functions that return something other than a CUDA error code
_RESTYPES = {
    # d, m, h1, h2 -> 1 if the fused CIN kernels take the shape
    "rm_cin2_takes": ([_I] * 4, _I),
    # b, d, m, h1, h2, want_q -> scratch bytes of rm_cin2_forward, or -1
    "rm_cin2_forward_scratch": ([_I] * 6, _L),
    # device, b, d, m, h1, h2 -> scratch bytes of rm_cin2_backward, or -1
    "rm_cin2_backward_scratch": ([_I] * 6, _L),
    # xk, w2, rows, hk, m, hn, is_bf16 -> scratch bytes of rm_cin_layer_forward, or -1
    "rm_cin_layer_forward_scratch": ([_P, _P, _L, _I, _I, _I, _I], _L),
    # device, g, xk, w2, rows, hk, m, hn -> scratch bytes of rm_cin_layer_backward, or -1
    "rm_cin_layer_backward_scratch": ([_I, _P, _P, _P, _L, _I, _I, _I], _L),
    # rows, n, vec -> rows of rm_mlp_act_backward's partials, or -1
    "rm_mlp_partial_rows": ([_I] * 3, _I),
    # b, k, n_l -> floats of rm_wukong_fm_backward's partials, or -1
    "rm_wukong_fm_partial_floats": ([_I] * 3, _L),
    # b, m, d -> floats of rm_wukong_ln_backward's partials, or -1
    "rm_wukong_ln_partial_floats": ([_L, _I, _I], _L),
    "rm_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD / h.hexdigest()[:16] / "libkernels.so"


def build() -> Path:
    """Compile and link the kernels unless this tree's library exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in _sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, obj, proc))
        log, failed = [], []
        for src, _, proc in jobs:  # wait for every compiler, failed or not
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(lib), *(str(o) for _, o, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out.parent / LOG_NAME).write_text("\n".join(log))
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    with profiling.timed("kernels.load_s"):
        profiling.count("kernels.built", int(not library_path().exists()))
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, (argtypes, restype) in _RESTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().rm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
