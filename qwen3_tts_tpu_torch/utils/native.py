"""ctypes bindings for the native host library (native/qtts_native.cpp).
Counterpart of qwen3_tts_tpu/utils/native.py: GGUF block dequantization
(Q8_0 / Q4_0 / Q5_0 / Q4_K / Q5_K / Q6_K, F16 / BF16) and a multi-threaded
loader that dequantizes many tensors of one GGUF file into one float32
arena.  io/gguf.py takes this path where the library is available; the
numpy path stays the reference the tests hold it against.

Unlike the JAX package, which loads the prebuilt native/libqtts_native.so,
the port builds its own library at first use, from the source in the
repository, with the host's C++ compiler (g++, else c++), into
`qwen3_tts_tpu_torch/build/native-<hash>/` (git-ignored; the hash covers
the source and the flags).  The prebuilt file is never loaded: its
Makefile builds with -march=native, so it carries the instruction set of
the CPU that built it, and another host could die on it with SIGILL
instead of raising.  The port's flags name no CPU, so its build directory
runs on any x86-64 host.  The compiler writes into a temporary file that
is then renamed into place, so concurrent processes never load half a
library.

As in the JAX package, `get_lib()` returns None where no host compiler
exists (or the source is not beside the package), and the callers take
the numpy path.  A compiler that exists and fails raises
NativeBuildError with its output: nothing falls back in silence.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG.parent / "native" / "qtts_native.cpp"
BUILD_ROOT = PKG / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def compiler() -> Optional[str]:
    """The host's C++ compiler, or None."""
    return shutil.which("g++") or shutil.which("c++")


def build(source: Path = SOURCE, build_root: Optional[Path] = None,
          cxx: Optional[str] = None) -> Path:
    """Compile `source` into `<build_root>/native-<hash>/libqtts_native.so`
    unless that library exists; return its path.  Raises NativeBuildError
    when the compiler fails."""
    cxx = cxx or compiler()
    if cxx is None:
        raise NativeBuildError("no host C++ compiler (g++ or c++) on PATH")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(Path(source).read_bytes())
    out_dir = Path(build_root or BUILD_ROOT) / f"native-{h.hexdigest()[:16]}"
    lib_path = out_dir / "libqtts_native.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"{cxx} failed ({proc.returncode}) on {source}:\n"
                f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, lib_path)   # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built at the first call of the process; None without a
    host compiler or without the source."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        if compiler() is None or not SOURCE.exists():
            _TRIED = True
            return None
        lib = ctypes.CDLL(str(build()))
        if lib.qtts_version() < 1:
            raise NativeBuildError(f"{SOURCE}: qtts_version() < 1")
        _configure(lib)
        _LIB, _TRIED = lib, True
        return _LIB


def _configure(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    for name, _, _ in _DEQUANT_FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [u8p, i64, f32p]
        fn.restype = None
    for name in ("qtts_f16_to_f32", "qtts_bf16_to_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint16), i64, f32p]
        fn.restype = None
    lib.qtts_load_tensors.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(_TensorSpec), ctypes.c_int64,
        f32p, ctypes.c_int32]
    lib.qtts_load_tensors.restype = ctypes.c_int
    lib.qtts_version.restype = ctypes.c_int


_DEQUANT_FNS = {
    8: ("qtts_dequant_q8_0", 34, 32),    # GGML_Q8_0
    2: ("qtts_dequant_q4_0", 18, 32),    # GGML_Q4_0
    6: ("qtts_dequant_q5_0", 22, 32),    # GGML_Q5_0
    12: ("qtts_dequant_q4_k", 144, 256),  # GGML_Q4_K
    13: ("qtts_dequant_q5_k", 176, 256),  # GGML_Q5_K
    14: ("qtts_dequant_q6_k", 210, 256),  # GGML_Q6_K
}


def native_dequantize(raw: np.ndarray, ggml_type: int,
                      n_elems: int) -> Optional[np.ndarray]:
    """Dequantize via the native library; None if unavailable/unsupported."""
    lib = get_lib()
    if lib is None or ggml_type not in _DEQUANT_FNS:
        return None
    name, block_bytes, block_elems = _DEQUANT_FNS[ggml_type]
    nb = n_elems // block_elems
    raw = np.ascontiguousarray(raw[: nb * block_bytes], np.uint8)
    if raw.size != nb * block_bytes:
        raise ValueError(f"{raw.size} bytes for {nb} blocks of "
                         f"{block_bytes}")
    out = np.empty(n_elems, np.float32)
    getattr(lib, name)(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(nb),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


class _TensorSpec(ctypes.Structure):
    _fields_ = [("file_offset", ctypes.c_int64),
                ("ggml_type", ctypes.c_int32),
                ("n_elems", ctypes.c_int64),
                ("out_offset", ctypes.c_int64)]


def native_load_tensors(path: str, specs, total_elems: int,
                        n_threads: int = 0) -> Optional[np.ndarray]:
    """Parallel multi-tensor GGUF load+dequant into one float32 arena.

    specs: iterable of (file_offset, ggml_type, n_elems, out_offset).
    Returns the arena, or None if the native library is unavailable or
    reports a failed read (the caller then reads tensor by tensor, which
    raises on a file that does not read)."""
    lib = get_lib()
    if lib is None:
        return None
    specs = list(specs)
    arr = (_TensorSpec * len(specs))(*[_TensorSpec(*s) for s in specs])
    out = np.empty(total_elems, np.float32)
    rc = lib.qtts_load_tensors(
        str(path).encode(), arr, len(specs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int32(n_threads))
    if rc != 0:
        return None
    return out
