"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` file exposes a plain C function; they are compiled with
`nvcc` for `sm_90a` (Hopper) into ONE shared library, which is loaded with
`ctypes`.  The library is built at first use, from the sources in the
package, into `qwen3_tts_tpu_torch/build/<hash>/` (git-ignored); the hash
covers the sources and the compiler flags, so editing a kernel rebuilds
it.  Nothing here runs at import time, and nothing here is reached for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "build"
SOURCES = ("flash_decode.cu", "flash_prefill.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures (every pointer and the stream as c_void_p, so ctypes does
# not cut them to 32 bits)
SIGNATURES = {
    "qtts_flash_decode": [_P, _P, _P, _P, _P, _P,          # q k v out len wi
                          _I, _I, _I, _I, _I, _I, _I,      # layer B H Hkv C dh pc
                          _F, _P],                         # scale stream
    "qtts_flash_prefill": [_P, _P, _P, _P, _P, _P,         # q k v out len start
                           _I, _I, _I, _I, _I, _I, _I,     # layer B S H Hkv C dh
                           _I, _I, _F, _P],                # pc window scale st
}


class KernelBuildError(RuntimeError):
    pass


class _Library:
    """The loaded library; built once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None
        self.path: Optional[Path] = None

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                t0 = time.perf_counter()
                self.path = build()
                lib = ctypes.CDLL(str(self.path))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
                self.build_seconds = time.perf_counter() - t0
            return self._lib


LIBRARY = _Library()


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelBuildError("nvcc not found (PATH or CUDA_HOME)")


def build() -> Path:
    """Compile the kernels unless a library for the current sources
    exists; return its path."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libqtts_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *[str(CSRC / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, lib_path)   # atomic: a reader never sees half a file
    return lib_path


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        import torch
        raise RuntimeError(f"{name} failed: cudaError {rc} "
                           f"({torch.cuda.get_device_name()})")
