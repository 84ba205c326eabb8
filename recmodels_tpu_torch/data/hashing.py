"""Deterministic vocabulary hashing (frozen spec v1).

The reference pipeline hashes raw categorical tokens into fixed bucket
vocabularies (SURVEY.md §2a #7, BASELINE.json:7 "hashed 1e5 vocab"). We use a
splitmix64 finalizer over a 64-bit token fingerprint, salted per slot, fully
vectorized in numpy on the host. The same function is reproducible in jnp for
on-device hashing if needed.

The spec (do not change — goldens depend on it):
  fingerprint(token): Criteo categorical tokens are 8-hex-char 32-bit values;
    fingerprint = uint64(value). Non-hex tokens fall back to FNV-1a 64 over
    the UTF-8 bytes.
  slot_salt(i) = splitmix64(i + 1)
  bucket(token, i, V) = 0 if missing else 1 + (splitmix64(fingerprint ^ slot_salt(i)) % (V - 1))
"""

from __future__ import annotations

import numpy as np

_SM64_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM64_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM64_M2 = np.uint64(0x94D049BB133111EB)

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def splitmix64(x: np.ndarray | int) -> np.ndarray:
    """splitmix64 finalizer; vectorized over uint64 arrays."""
    with np.errstate(over="ignore"):
        z = (np.asarray(x, dtype=np.uint64) + _SM64_GAMMA)
        z = (z ^ (z >> np.uint64(30))) * _SM64_M1
        z = (z ^ (z >> np.uint64(27))) * _SM64_M2
        z = z ^ (z >> np.uint64(31))
    return z


def slot_salts(n_slots: int) -> np.ndarray:
    return splitmix64(np.arange(1, n_slots + 1, dtype=np.uint64))


def fnv1a64_bytes(token: bytes) -> int:
    h = int(_FNV_OFFSET)
    for b in token:
        h ^= b
        h = (h * int(_FNV_PRIME)) & 0xFFFFFFFFFFFFFFFF
    return h


_HEX = frozenset(b"0123456789abcdefABCDEF")


def token_fingerprint(s: bytes) -> np.uint64:
    """Fingerprint one non-empty token: <=16 pure-hex chars parse as uint64
    (Criteo tokens are 8 hex chars); anything else gets FNV-1a 64. Exactly
    mirrors the native parser (_fastparse.cpp parse_hex/fnv1a64)."""
    if 0 < len(s) <= 16 and all(c in _HEX for c in s):
        return np.uint64(int(s, 16))
    return np.uint64(fnv1a64_bytes(s))


def fingerprint_tokens(tokens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Byte-string tokens -> (uint64 fingerprints, bool missing mask).
    Empty string (or b'') is "missing"."""
    tokens = np.asarray(tokens)
    flat = tokens.ravel()
    fp = np.zeros(flat.shape, dtype=np.uint64)
    missing = np.zeros(flat.shape, dtype=bool)
    for i, t in enumerate(flat):
        s = t if isinstance(t, bytes) else str(t).encode()
        if not s:
            missing[i] = True
            continue
        fp[i] = token_fingerprint(s)
    return fp.reshape(tokens.shape), missing.reshape(tokens.shape)


def hash_fingerprints(
    fp: np.ndarray, missing: np.ndarray, slot_ids: np.ndarray, vocab_sizes: np.ndarray
) -> np.ndarray:
    """Vectorized bucket assignment from precomputed fingerprints.

    fp, missing, slot_ids broadcast together; vocab_sizes is indexed by
    slot_ids. Returns int32 bucket ids in [0, V).
    """
    salts = slot_salts(int(np.max(slot_ids)) + 1)
    h = splitmix64(fp ^ salts[slot_ids])
    v = vocab_sizes[slot_ids].astype(np.uint64)
    ids = np.uint64(1) + h % (v - np.uint64(1))
    ids = np.where(missing, np.uint64(0), ids)
    return ids.astype(np.int32)


def hash_tokens(tokens: np.ndarray, vocab_sizes) -> np.ndarray:
    """[..., n_slots] byte-string tokens -> int32 bucket ids (frozen spec v1)."""
    vocab_sizes = np.asarray(vocab_sizes, dtype=np.int64)
    n_slots = tokens.shape[-1]
    if len(vocab_sizes) != n_slots:
        raise ValueError("vocab_sizes length must match trailing token dim")
    fp, missing = fingerprint_tokens(tokens)
    slot_ids = np.broadcast_to(np.arange(n_slots), tokens.shape)
    return hash_fingerprints(fp, missing, slot_ids, vocab_sizes)


def hash_uint64_values(values: np.ndarray, vocab_sizes, missing_mask=None) -> np.ndarray:
    """Hash already-numeric token fingerprints, shape [..., n_slots].

    Used by the fast TSV path (hex tokens parsed straight to uint64) and the
    synthetic generator.
    """
    values = np.asarray(values, dtype=np.uint64)
    vocab_sizes = np.asarray(vocab_sizes, dtype=np.int64)
    n_slots = values.shape[-1]
    slot_ids = np.broadcast_to(np.arange(n_slots), values.shape)
    if missing_mask is None:
        missing_mask = np.zeros(values.shape, dtype=bool)
    return hash_fingerprints(values, missing_mask, slot_ids, vocab_sizes)
