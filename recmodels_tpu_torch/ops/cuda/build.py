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
_SIGNATURES = {
    # device, table, ids, out, n, d1, out_bf16, stream
    "rm_gather_rows": [_I, _P, _P, _P, _L, _I, _I, _P],
    # device, full, x_dm, wide_sum, b, m, d, is_bf16, stream
    "rm_split_fused_rows": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    # device, x0, w1, w2, x1, p1, p2, q, b, d, m, h1, h2, stream
    "rm_cin2_forward": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # device, g_dm, g_ws, out, b, m, d, is_bf16, stream
    "rm_split_fused_rows_backward": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    # device, x0, x1, w1, w2, q, g1p, g2p, gx0, gw1, gw2, scratch, b, d, m, h1, h2, stream
    "rm_cin2_backward": [_I] + [_P] * 11 + [_I] * 5 + [_P],
    # device, table, acc, ids, grads, n, rows, d, grads_bf16, lr, eps, stream
    "rm_adagrad_update": [_I, _P, _P, _P, _P, _L, _L, _I, _I, _F, _F, _P],
}
# functions that return something other than a CUDA error code
_RESTYPES = {
    # b, d, m, h1, h2 -> scratch bytes of rm_cin2_backward, or -1
    "rm_cin2_backward_scratch": ([_I] * 5, _L),
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
