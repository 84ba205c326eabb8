"""ctypes binding of the native Criteo parser (``_fastparse.cpp``), built with
g++ at first use into ``recmodels_tpu_torch/_build/fastparse-<hash>/`` (the
hash covers the source and the flags, so an edited source rebuilds).

A build that fails raises: nothing falls back to the Python parser, which a
caller chooses with ``parse_criteo_batch(..., use_native=False)``. The native
parser's labels and ids equal the Python parser's bit for bit; its dense
values are log1p taken in double and rounded once, the Python parser's log1p
in f32, so they may differ by an ulp.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from recmodels_tpu_torch.data.schema import N_CATEGORICAL, N_DENSE, Schema

SRC = Path(__file__).resolve().parent / "_fastparse.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O3", "-shared", "-fPIC"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    return BUILD / f"fastparse-{h}" / "libfastparse.so"


def build() -> Path:
    """Compile the parser unless this source's library exists; raises
    ``RuntimeError`` when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = Path(tmp) / out.name
        try:
            proc = subprocess.run(["g++", *FLAGS, "-o", str(lib), str(SRC)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the native Criteo parser builds with g++") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stdout}")
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded parser, built on the first call."""
    lib = ctypes.CDLL(str(build()))
    lib.rm_parse_criteo.restype = ctypes.c_long
    lib.rm_parse_criteo.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_long),
    ]
    return lib


def parse_buffer(buf: bytes, schema: Schema, max_rows: int):
    """Parse up to ``max_rows`` complete lines of ``buf``. Returns (labels,
    dense, ids, consumed bytes): dense log1p-transformed, ids hashed."""
    if schema.n_dense != N_DENSE or schema.n_slots != N_CATEGORICAL:
        raise ValueError(f"the native parser reads {N_DENSE} dense and {N_CATEGORICAL} categorical "
                         f"fields; the schema has {schema.n_dense} and {schema.n_slots}")
    lib = library()
    labels = np.zeros((max_rows,), np.float32)
    dense = np.zeros((max_rows, N_DENSE), np.float32)
    ids = np.zeros((max_rows, N_CATEGORICAL), np.int32)
    vocab = np.asarray(schema.vocab_sizes, np.int64)
    consumed = ctypes.c_long(0)
    n = lib.rm_parse_criteo(
        buf, len(buf), max_rows,
        vocab.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(consumed),
    )
    return labels[:n], dense[:n], ids[:n], consumed.value
