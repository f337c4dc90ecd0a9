"""The port's copy of qwen3_tts_tpu/io/cache.py (the port cannot import the
JAX package, whose __init__ imports jax), which also refuses a file cut
short.  Keep the two formats in step.

Reference-audio feature cache (binary `.cache` sidecar).

Format parity with the reference implementation's utils/cache.rs: magic
`TTSC`, u32 version 1, u64 count + i64 codes, u64 count + f32 embedding,
all little-endian, so caches written by the reference implementation load
here and vice versa.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

MAGIC = b"TTSC"
VERSION = 1


def save_cache(path, codes, emb) -> None:
    codes = np.asarray(codes, np.int64).reshape(-1)
    emb = np.asarray(emb, np.float32).reshape(-1)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", VERSION))
        f.write(struct.pack("<Q", codes.size))
        f.write(codes.astype("<i8").tobytes())
        f.write(struct.pack("<Q", emb.size))
        f.write(emb.astype("<f4").tobytes())


def load_cache(path) -> Tuple[np.ndarray, np.ndarray]:
    """(codes int64 [n], embedding f32 [m]).  Raises ValueError on a bad
    magic or version, a count larger than the bytes left, or a file cut
    short."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError("Invalid magic bytes")
        (version,) = struct.unpack("<I", _read(f, 4))
        if version != VERSION:
            raise ValueError(f"Unsupported cache version {version}")
        (n_codes,) = struct.unpack("<Q", _read(f, 8))
        codes = np.frombuffer(_read(f, 8 * n_codes), "<i8").astype(np.int64)
        (n_emb,) = struct.unpack("<Q", _read(f, 8))
        emb = np.frombuffer(_read(f, 4 * n_emb), "<f4").astype(np.float32)
    return codes, emb


def _read(f, n: int) -> bytes:
    left = os.fstat(f.fileno()).st_size - f.tell()
    if n > left:
        raise ValueError(f"cache file cut short: {left} of {n} bytes")
    data = f.read(n)
    if len(data) != n:
        raise ValueError(f"cache file cut short: {len(data)} of {n} bytes")
    return data
