"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` file exposes plain C functions; each is compiled with
`nvcc` for `sm_90a` (Hopper) into an object, all at once in parallel, and
the objects are linked into ONE shared library, which is loaded with
`ctypes`.  The library is built at first use, from the sources in the
package, into `qwen3_tts_tpu_torch/build/<hash>/` (git-ignored); the hash
covers the sources, the shared header and the compiler flags, so editing a
kernel rebuilds it.  `LIBRARY.ptxas` keeps ptxas's report (registers,
shared memory, spills per kernel).  Nothing here runs at import time, and
nothing here is reached for CPU tensors.
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
SOURCES = ("flash_decode.cu", "flash_prefill.cu", "talker_step.cu",
           "predictor_frame.cu", "chunk_step.cu", "kv_lanes.cu",
           "int4_matmul.cu")
HEADERS = ("common.cuh", "w4a8.cuh", "cp_async.cuh", "gemv_stream.cuh",
           "split_attn.cuh", "weight_ring.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures (every pointer and the stream as c_void_p, so ctypes does
# not cut them to 32 bits)
SIGNATURES = {
    "qtts_flash_decode": [_P, _P, _P, _P, _P, _P, _P,      # q k v out ws len wi
                          _I, _I, _I, _I, _I, _I,          # B H Hkv C dh pc
                          _F, _P],                         # scale stream
    "qtts_flash_prefill": [_P, _P, _P, _P, _P, _P,         # q k v out len start
                           _I, _I, _I, _I, _I, _I, _I,     # layer B S H Hkv C dh
                           _I, _I, _F, _P, _P],            # pc window scale
                                                           # info stream
    "qtts_talker_step": [_P, _I, _P, _I, _P, _I, _P, _P],  # talker_step.cu
    "qtts_w4a8_gemv": [_P, _P, _P, _P, _I, _I, _I, _P, _P],  # xq sx q s B N K
                                                             # y stream
    "qtts_predictor_frame": [_P, _I, _P, _I, _P, _I,       # predictor_frame.cu
                             _P, _P],
    "qtts_chunk_step": [_P, _I, _P, _I, _P, _I, _P, _P],   # chunk_step.cu
    "qtts_sample_threshold": [_P, _P, _P, _I, _I,          # lg u out B V
                              _F, _F, _F, _P],             # t k p stream
    "qtts_decode_append": [_P, _P, _P, _P, _P, _P, _P, _P,  # q k v kn vn o len wi
                           _P, _L, _P, _I,                  # part n arrive n
                           _I, _I, _I, _I, _I, _I, _I,      # layer B H Hkv C dh pc
                           _F, _P],                         # scale stream
    "qtts_inject_lanes": [_P, _P, _P, _P, _P,              # kb vb ks vs lanes
                          _I, _I, _I, _I, _I, _I, _I, _P],  # L R B Hkv C S dh st
    "qtts_append_lanes": [_P, _P, _P, _P, _P,              # kb vb kt vt starts
                          _I, _I, _I, _I, _I, _P],         # L B Hkv C dh stream
    "qtts_int4_matmul": [_P, _P, _P, _P,                   # x q4 s y
                         _I, _I, _I, _I, _P],              # M N K G stream
    "qtts_int4_matmul_tile": [_P, _P, _P, _P, _P,          # x q4 s y ws
                              _I, _I, _I, _I, _I, _I,      # M N K G mi sp
                              _P],                         # stream
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
        self.ptxas: str = ""

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                t0 = time.perf_counter()
                self.path = build()
                log = self.path.parent / "ptxas.txt"
                self.ptxas = log.read_text() if log.exists() else ""
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
    for name in SOURCES + HEADERS:
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
    exists; return its path.  One nvcc per source, all started together,
    then one link."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libqtts_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        nvcc = nvcc_path()
        objs = [tmp / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, p.returncode, log) for s, p, log
                  in zip(SOURCES, procs, logs) if p.returncode != 0]
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(
                f"{s} ({rc}):\n{log}" for s, rc, log in failed))
        so = tmp / lib_path.name
        proc = subprocess.run([nvcc, "-shared", "-o", str(so),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"link failed ({proc.returncode}):\n{proc.stderr}"
                f"{proc.stdout}")
        (out_dir / "ptxas.txt").write_text("".join(logs))
        os.replace(so, lib_path)   # atomic: a reader never sees half a file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error.  With
    QTTS_CHECKS (utils/tracing), also synchronize the device and raise,
    naming the kernel, on an error its launch caused asynchronously."""
    import torch
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaError {rc} "
                           f"({torch.cuda.get_device_name()})")
    from ..utils import tracing
    if tracing.CHECKS:
        try:
            torch.cuda.synchronize()
        except RuntimeError as e:
            raise RuntimeError(f"QTTS_CHECKS: {name} faulted on the device: "
                               f"{e}") from e
