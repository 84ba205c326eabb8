"""Criteo TSV lines to model inputs, written from the data spec alone (plain
Python and NumPy), for the fed cell's check.

A line is ``label \\t 13 integers \\t 26 tokens``; an empty field is
missing. Dense: ``log1p(max(x, 0))``, a missing value 0. Categorical, the
frozen hashing spec: a token of at most 16 hex digits fingerprints as its
value, any other as its FNV-1a 64-bit hash; slot i's salt is
``splitmix64(i + 1)``; a token's bucket is ``1 + splitmix64(fingerprint ^
salt) % (V - 1)``, a missing token bucket 0.
"""

from __future__ import annotations

import numpy as np

M64 = (1 << 64) - 1
FNV_OFFSET, FNV_PRIME = 0xCBF29CE484222325, 0x100000001B3
_HEX = set(b"0123456789abcdefABCDEF")


def splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def fnv1a64(token: bytes) -> int:
    h = FNV_OFFSET
    for c in token:
        h = ((h ^ c) * FNV_PRIME) & M64
    return h


def fingerprint(token: bytes) -> int:
    if len(token) <= 16 and all(c in _HEX for c in token):
        return int(token, 16)
    return fnv1a64(token)


def bucket(token: bytes, slot: int, vocab: int) -> int:
    if not token:
        return 0
    return 1 + splitmix64(fingerprint(token) ^ splitmix64(slot + 1)) % (vocab - 1)


def parse(lines, n_dense: int, n_slots: int, vocab: int):
    """(dense [n, n_dense] f32, ids [n, n_slots] int32, labels [n] f32)."""
    n = len(lines)
    dense = np.zeros((n, n_dense), np.float64)
    ids = np.zeros((n, n_slots), np.int64)
    labels = np.zeros((n,), np.float32)
    memo: dict = {}
    for r, line in enumerate(lines):
        f = line.rstrip(b"\n").split(b"\t")
        labels[r] = float(f[0])
        for j in range(n_dense):
            if f[1 + j]:
                dense[r, j] = np.log1p(max(float(f[1 + j]), 0.0))
        for s in range(n_slots):
            tok = f[1 + n_dense + s]
            if tok:
                key = (s, tok)
                if key not in memo:
                    memo[key] = bucket(tok, s, vocab)
                ids[r, s] = memo[key]
    return dense.astype(np.float32), ids.astype(np.int32), labels


def read_lines(path: str, n: int) -> list:
    """The first ``n`` lines of ``path``, as bytes."""
    out = []
    with open(path, "rb") as f:
        for line in f:
            out.append(line)
            if len(out) == n:
                break
    return out
