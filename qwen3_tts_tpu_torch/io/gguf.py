"""Copy of qwen3_tts_tpu/io/gguf.py (numpy only): the port cannot import
the JAX package, whose __init__ imports jax.  Keep the two in step.  The
one difference: the JAX package's optional C++ fast path
(qwen3_tts_tpu.utils.native) is not ported, so `read_tensors` reads tensor
by tensor and `dequantize` always runs the numpy path, which the original
calls authoritative.

Pure-numpy GGUF reader/writer with vectorized dequantization.

The reference delegates GGUF parsing to a hand-rolled F32-only reader for
assets (the reference's src/assets_manager.rs:28-266) and to llama.cpp for the
quantized LM weights.  Here one reader handles both: it parses the full GGUF
v2/v3 container (metadata + tensor infos) and dequantizes F32/F16/BF16/Q8_0/
Q4_0/Q5_0/Q4_K/Q5_K/Q6_K tensor data to float32 numpy arrays, vectorized over
blocks.  Dequantization follows the public GGML block format specification.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np

GGUF_MAGIC = b"GGUF"
ALIGNMENT_KEY = "general.alignment"
DEFAULT_ALIGNMENT = 32

# GGUF metadata value types
T_UINT8, T_INT8, T_UINT16, T_INT16, T_UINT32, T_INT32, T_FLOAT32, T_BOOL, \
    T_STRING, T_ARRAY, T_UINT64, T_INT64, T_FLOAT64 = range(13)

_SCALAR_FMT = {
    T_UINT8: "<B", T_INT8: "<b", T_UINT16: "<H", T_INT16: "<h",
    T_UINT32: "<I", T_INT32: "<i", T_FLOAT32: "<f", T_BOOL: "<B",
    T_UINT64: "<Q", T_INT64: "<q", T_FLOAT64: "<d",
}

# GGML tensor dtypes (subset)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0, GGML_Q8_1 = 8, 9
GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 12, 13, 14
GGML_BF16 = 30

QK = 32      # simple-quant block size
QK_K = 256   # K-quant super-block size

# (block_bytes, elems_per_block)
_BLOCK_INFO = {
    GGML_F32: (4, 1),
    GGML_F16: (2, 1),
    GGML_BF16: (2, 1),
    GGML_Q4_0: (2 + 16, QK),
    GGML_Q5_0: (2 + 4 + 16, QK),
    GGML_Q8_0: (2 + 32, QK),
    GGML_Q4_K: (2 + 2 + 12 + 128, QK_K),
    GGML_Q5_K: (2 + 2 + 12 + 32 + 128, QK_K),
    GGML_Q6_K: (128 + 64 + 16 + 2, QK_K),
}

TYPE_NAMES = {
    GGML_F32: "F32", GGML_F16: "F16", GGML_BF16: "BF16",
    GGML_Q4_0: "Q4_0", GGML_Q5_0: "Q5_0", GGML_Q8_0: "Q8_0",
    GGML_Q4_K: "Q4_K", GGML_Q5_K: "Q5_K", GGML_Q6_K: "Q6_K",
}


@dataclass
class TensorInfo:
    name: str
    shape: Tuple[int, ...]   # numpy order (row-major, slowest first)
    ggml_type: int
    offset: int              # relative to data section start
    n_bytes: int


@dataclass
class GGUFFile:
    path: Path
    metadata: Dict[str, Any]
    tensors: Dict[str, TensorInfo]
    data_start: int

    def names(self) -> List[str]:
        return list(self.tensors)

    def read_tensors(self, names, dtype=np.float32):
        """Read+dequantize many tensors, one at a time."""
        return {n: self.read_tensor(n, dtype) for n in names}

    def read_tensor(self, name: str, dtype=np.float32) -> np.ndarray:
        """Read and dequantize one tensor to `dtype` (default float32)."""
        info = self.tensors[name]
        with open(self.path, "rb") as f:
            f.seek(self.data_start + info.offset)
            raw = f.read(info.n_bytes)
        n_elems = int(np.prod(info.shape)) if info.shape else 1
        arr = dequantize(np.frombuffer(raw, dtype=np.uint8), info.ggml_type, n_elems)
        return np.ascontiguousarray(arr.reshape(info.shape).astype(dtype, copy=False))


def _read_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _read_value(f: BinaryIO, vtype: int):
    if vtype == T_STRING:
        return _read_string(f)
    if vtype == T_ARRAY:
        (etype,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(count)]
    fmt = _SCALAR_FMT[vtype]
    (val,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
    if vtype == T_BOOL:
        val = bool(val)
    return val


def read_gguf(path) -> GGUFFile:
    """Parse the GGUF container: metadata KVs and tensor directory."""
    path = Path(path)
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        (version,) = struct.unpack("<I", f.read(4))
        if version < 2:
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        (n_tensors,) = struct.unpack("<Q", f.read(8))
        (n_kv,) = struct.unpack("<Q", f.read(8))

        metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_string(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            metadata[key] = _read_value(f, vtype)

        tensors: Dict[str, TensorInfo] = {}
        for _ in range(n_tensors):
            name = _read_string(f)
            (ndims,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{ndims}Q", f.read(8 * ndims))
            (ggml_type,) = struct.unpack("<I", f.read(4))
            (offset,) = struct.unpack("<Q", f.read(8))
            # GGML dims are fastest-varying first; numpy shape reverses them.
            shape = tuple(int(d) for d in reversed(dims))
            n_elems = int(np.prod(shape)) if shape else 1
            if ggml_type not in _BLOCK_INFO:
                tname = TYPE_NAMES.get(ggml_type, str(ggml_type))
                raise ValueError(f"{path}: tensor {name}: unsupported ggml type {tname}")
            bb, eb = _BLOCK_INFO[ggml_type]
            if n_elems % eb:
                raise ValueError(f"{path}: tensor {name}: {n_elems} elems not a "
                                 f"multiple of block size {eb}")
            tensors[name] = TensorInfo(name, shape, ggml_type, offset,
                                       (n_elems // eb) * bb)

        align = int(metadata.get(ALIGNMENT_KEY, DEFAULT_ALIGNMENT))
        pos = f.tell()
        data_start = (pos + align - 1) // align * align

    return GGUFFile(path=path, metadata=metadata, tensors=tensors,
                    data_start=data_start)


# ---------------------------------------------------------------------------
# Dequantization (vectorized numpy)
# ---------------------------------------------------------------------------

def dequantize(raw: np.ndarray, ggml_type: int, n_elems: int) -> np.ndarray:
    """Dequantize `raw` uint8 buffer of `n_elems` logical elements to f32."""
    if ggml_type == GGML_F32:
        return raw.view(np.float32)[:n_elems].astype(np.float32)
    if ggml_type == GGML_F16:
        return raw.view(np.float16)[:n_elems].astype(np.float32)
    if ggml_type == GGML_BF16:
        u = raw.view(np.uint16)[:n_elems].astype(np.uint32) << 16
        return u.view(np.float32)
    bb, eb = _BLOCK_INFO[ggml_type]
    nb = n_elems // eb
    blocks = raw[: nb * bb].reshape(nb, bb)
    if ggml_type == GGML_Q8_0:
        return _dq_q8_0(blocks)
    if ggml_type == GGML_Q4_0:
        return _dq_q4_0(blocks)
    if ggml_type == GGML_Q5_0:
        return _dq_q5_0(blocks)
    if ggml_type == GGML_Q4_K:
        return _dq_q4_k(blocks)
    if ggml_type == GGML_Q5_K:
        return _dq_q5_k(blocks)
    if ggml_type == GGML_Q6_K:
        return _dq_q6_k(blocks)
    raise ValueError(f"unsupported ggml type {ggml_type}")


def _f16(blocks: np.ndarray, byte_off: int) -> np.ndarray:
    return blocks[:, byte_off:byte_off + 2].copy().view(np.float16)[:, 0].astype(np.float32)


def _dq_q8_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b, 0)                                    # [nb]
    q = b[:, 2:34].view(np.int8).astype(np.float32)   # [nb, 32]
    return (d[:, None] * q).reshape(-1)


def _dq_q4_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b, 0)
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.float32) - 8.0         # elems 0..15
    hi = (qs >> 4).astype(np.float32) - 8.0           # elems 16..31
    q = np.concatenate([lo, hi], axis=1)              # [nb, 32]
    return (d[:, None] * q).reshape(-1)


def _dq_q5_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b, 0)
    qh = b[:, 2:6].copy().view(np.uint32)[:, 0]       # [nb]
    qs = b[:, 6:22]
    shifts_lo = np.arange(16, dtype=np.uint32)
    shifts_hi = np.arange(16, 32, dtype=np.uint32)
    hbit_lo = ((qh[:, None] >> shifts_lo[None, :]) & 1).astype(np.uint8)
    hbit_hi = ((qh[:, None] >> shifts_hi[None, :]) & 1).astype(np.uint8)
    lo = ((qs & 0x0F) | (hbit_lo << 4)).astype(np.float32) - 16.0
    hi = ((qs >> 4) | (hbit_hi << 4)).astype(np.float32) - 16.0
    q = np.concatenate([lo, hi], axis=1)
    return (d[:, None] * q).reshape(-1)


def _unpack_k_scales(scales: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scale/min encoding of Q4_K/Q5_K.

    Returns (sc, m): each [nb, 8] float32 for the 8 sub-blocks of 32.
    """
    s = scales.astype(np.uint8)
    sc = np.empty(s.shape[:1] + (8,), np.float32)
    m = np.empty_like(sc)
    for j in range(4):
        sc[:, j] = (s[:, j] & 63).astype(np.float32)
        m[:, j] = (s[:, j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        sc[:, j] = ((s[:, j + 4] & 0x0F) | ((s[:, j - 4] >> 6) << 4)).astype(np.float32)
        m[:, j] = ((s[:, j + 4] >> 4) | ((s[:, j] >> 6) << 4)).astype(np.float32)
    return sc, m


def _dq_q4_k(b: np.ndarray) -> np.ndarray:
    d = _f16(b, 0)
    dmin = _f16(b, 2)
    sc, m = _unpack_k_scales(b[:, 4:16])
    qs = b[:, 16:144]                                  # [nb, 128]
    nb = b.shape[0]
    y = np.empty((nb, 256), np.float32)
    # qs bytes 32*g .. 32*(g+1) hold nibbles for elems 64*g .. 64*(g+1)
    for half in range(2):                              # j = 0,128
        for quarter in range(2):                       # low/high nibble pairs
            qq = qs[:, 64 * half + 32 * quarter: 64 * half + 32 * (quarter + 1)]
            lo = (qq & 0x0F).astype(np.float32)
            hi = (qq >> 4).astype(np.float32)
            jlo = 4 * half + 2 * quarter
            jhi = jlo + 1
            base = 128 * half + 64 * quarter
            y[:, base:base + 32] = (d * sc[:, jlo])[:, None] * lo - (dmin * m[:, jlo])[:, None]
            y[:, base + 32:base + 64] = (d * sc[:, jhi])[:, None] * hi - (dmin * m[:, jhi])[:, None]
    return y.reshape(-1)


def _dq_q5_k(b: np.ndarray) -> np.ndarray:
    d = _f16(b, 0)
    dmin = _f16(b, 2)
    sc, m = _unpack_k_scales(b[:, 4:16])
    qh = b[:, 16:48]                                   # [nb, 32]
    qs = b[:, 48:176]                                  # [nb, 128]
    nb = b.shape[0]
    y = np.empty((nb, 256), np.float32)
    for g in range(4):                                 # j = 64*g
        qq = qs[:, 32 * g:32 * (g + 1)]
        u1 = np.uint8(1 << (2 * g))
        u2 = np.uint8(2 << (2 * g))
        lo = ((qq & 0x0F) + np.where(qh & u1, 16, 0)).astype(np.float32)
        hi = ((qq >> 4) + np.where(qh & u2, 16, 0)).astype(np.float32)
        jlo, jhi = 2 * g, 2 * g + 1
        y[:, 64 * g:64 * g + 32] = (d * sc[:, jlo])[:, None] * lo - (dmin * m[:, jlo])[:, None]
        y[:, 64 * g + 32:64 * g + 64] = (d * sc[:, jhi])[:, None] * hi - (dmin * m[:, jhi])[:, None]
    return y.reshape(-1)


def _dq_q6_k(b: np.ndarray) -> np.ndarray:
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    sc = b[:, 192:208].view(np.int8).astype(np.float32)   # [nb, 16]
    d = _f16(b, 208)
    nb = b.shape[0]
    y = np.empty((nb, 256), np.float32)
    for half in range(2):                              # n = 0, 128
        qlh = ql[:, 64 * half:64 * (half + 1)]
        qhh = qh[:, 32 * half:32 * (half + 1)]
        sch = sc[:, 8 * half:8 * (half + 1)]
        l = np.arange(32)
        is_ = l // 16                                  # [32] in {0,1}
        q1 = ((qlh[:, :32] & 0x0F) | (((qhh >> 0) & 3) << 4)).astype(np.int8).astype(np.float32) - 32
        q2 = ((qlh[:, 32:] & 0x0F) | (((qhh >> 2) & 3) << 4)).astype(np.int8).astype(np.float32) - 32
        q3 = ((qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4)).astype(np.int8).astype(np.float32) - 32
        q4 = ((qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4)).astype(np.int8).astype(np.float32) - 32
        base = 128 * half
        y[:, base + 0:base + 32] = d[:, None] * sch[:, is_ + 0] * q1
        y[:, base + 32:base + 64] = d[:, None] * sch[:, is_ + 2] * q2
        y[:, base + 64:base + 96] = d[:, None] * sch[:, is_ + 4] * q3
        y[:, base + 96:base + 128] = d[:, None] * sch[:, is_ + 6] * q4
    return y.reshape(-1)


# ---------------------------------------------------------------------------
# Minimal writer (F32/F16 tensors; scalar + string metadata) — used by tests
# and by offline asset conversion.
# ---------------------------------------------------------------------------

def write_gguf(path, tensors: Dict[str, np.ndarray],
               metadata: Optional[Dict[str, Any]] = None) -> None:
    metadata = metadata or {}
    path = Path(path)
    with open(path, "wb") as f:
        f.write(GGUF_MAGIC)
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<Q", len(tensors)))
        f.write(struct.pack("<Q", len(metadata)))

        def wstr(s: str):
            bs = s.encode("utf-8")
            f.write(struct.pack("<Q", len(bs)))
            f.write(bs)

        for k, v in metadata.items():
            wstr(k)
            if isinstance(v, bool):
                f.write(struct.pack("<I", T_BOOL))
                f.write(struct.pack("<B", int(v)))
            elif isinstance(v, int):
                f.write(struct.pack("<I", T_INT64 if v < 0 else T_UINT64))
                f.write(struct.pack("<q" if v < 0 else "<Q", v))
            elif isinstance(v, float):
                f.write(struct.pack("<I", T_FLOAT32))
                f.write(struct.pack("<f", v))
            elif isinstance(v, str):
                f.write(struct.pack("<I", T_STRING))
                wstr(v)
            elif isinstance(v, (list, tuple)):
                f.write(struct.pack("<I", T_ARRAY))
                if all(isinstance(e, (int, np.integer)) for e in v):
                    f.write(struct.pack("<I", T_INT64))
                    f.write(struct.pack("<Q", len(v)))
                    for e in v:
                        f.write(struct.pack("<q", int(e)))
                elif all(isinstance(e, str) for e in v):
                    f.write(struct.pack("<I", T_STRING))
                    f.write(struct.pack("<Q", len(v)))
                    for e in v:
                        wstr(e)
                else:
                    f.write(struct.pack("<I", T_FLOAT32))
                    f.write(struct.pack("<Q", len(v)))
                    for e in v:
                        f.write(struct.pack("<f", float(e)))
            else:
                raise TypeError(f"unsupported metadata type for {k}: {type(v)}")

        offset = 0
        infos = []
        for name, arr in tensors.items():
            arr = np.asarray(arr)
            if arr.dtype == np.float16:
                gt, ebytes = GGML_F16, 2
            else:
                arr = arr.astype(np.float32)
                gt, ebytes = GGML_F32, 4
            wstr(name)
            dims = tuple(reversed(arr.shape))  # GGML order
            f.write(struct.pack("<I", len(dims)))
            for dddd in dims:
                f.write(struct.pack("<Q", dddd))
            f.write(struct.pack("<I", gt))
            f.write(struct.pack("<Q", offset))
            nbytes = arr.size * ebytes
            infos.append((arr, offset))
            offset += (nbytes + DEFAULT_ALIGNMENT - 1) // DEFAULT_ALIGNMENT * DEFAULT_ALIGNMENT

        pos = f.tell()
        pad = (-pos) % DEFAULT_ALIGNMENT
        f.write(b"\x00" * pad)
        data_start = f.tell()
        for arr, off in infos:
            f.seek(data_start + off)
            f.write(arr.tobytes())
