"""The port's native host library (qwen3_tts_tpu_torch/utils/native.py),
built here from native/qtts_native.cpp with the host's g++ into a
temporary build directory: its dequantizers against the port's and the
JAX package's numpy paths for the six quant types (rtol 1e-5, atol 1e-6,
tests/test_native.py's tolerance), qtts_f16_to_f32 exact on every finite
f16, the multi-threaded GGUF loader (read_tensors) against per-tensor
reads, a compiler that fails raising, no compiler giving the numpy path,
and the prebuilt native/libqtts_native.so never loaded."""

import ctypes
import unittest.mock as mock

import numpy as np
import pytest

from qwen3_tts_tpu.io import gguf as jg
from qwen3_tts_tpu.utils import native as jnative
from qwen3_tts_tpu_torch.io import gguf as tg
from qwen3_tts_tpu_torch.utils import native

CASES = [(tg.GGML_Q8_0, 34, 32), (tg.GGML_Q4_0, 18, 32),
         (tg.GGML_Q5_0, 22, 32), (tg.GGML_Q4_K, 144, 256),
         (tg.GGML_Q5_K, 176, 256), (tg.GGML_Q6_K, 210, 256)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if native.compiler() is None:
        pytest.skip("no host C++ compiler")
    path = native.build(build_root=tmp_path_factory.mktemp("native"))
    loaded = ctypes.CDLL(str(path))
    native._configure(loaded)
    return loaded


@pytest.fixture
def with_lib(lib):
    with mock.patch.object(native, "_LIB", lib), \
            mock.patch.object(native, "_TRIED", True):
        yield lib


def _numpy_only():
    """Both packages' native paths off: their numpy dequantizers run."""
    return (mock.patch.object(native, "_LIB", None),
            mock.patch.object(native, "_TRIED", True),
            mock.patch.object(jnative, "_LIB", None),
            mock.patch.object(jnative, "_TRIED", True))


@pytest.mark.parametrize("gt,bb,eb", CASES)
def test_native_matches_numpy(with_lib, gt, bb, eb):
    rng = np.random.default_rng(gt)
    nb = 13
    raw = rng.integers(0, 256, bb * nb, dtype=np.uint8).reshape(nb, bb)
    raw[:, :2] = np.frombuffer(np.float16(0.5).tobytes(), np.uint8)
    if gt in (tg.GGML_Q4_K, tg.GGML_Q5_K):
        raw[:, 2:4] = np.frombuffer(np.float16(0.25).tobytes(), np.uint8)
    if gt == tg.GGML_Q6_K:
        raw[:, 208:210] = np.frombuffer(np.float16(0.5).tobytes(), np.uint8)
    raw = raw.reshape(-1)

    fast = native.native_dequantize(raw, gt, eb * nb)
    assert fast is not None and fast.dtype == np.float32
    np.testing.assert_array_equal(tg.dequantize(raw, gt, eb * nb), fast)
    p = _numpy_only()
    with p[0], p[1], p[2], p[3]:
        ref = tg.dequantize(raw, gt, eb * nb)
        jref = jg.dequantize(raw, gt, eb * nb)
    np.testing.assert_allclose(fast, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fast, jref, rtol=1e-5, atol=1e-6)


def test_f16_conversion_exhaustive_finite(with_lib):
    bits = np.arange(65536, dtype=np.uint16)
    out = np.empty(65536, np.float32)
    with_lib.qtts_f16_to_f32(
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 65536,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    ref = bits.view(np.float16).astype(np.float32)
    finite = np.isfinite(ref)
    assert np.array_equal(out[finite], ref[finite])


def test_parallel_loader_matches_per_tensor(with_lib, tmp_path):
    """read_tensors through the native arena == per-tensor reads == the
    arrays written (F32 / F16 tensors), and the arena path did run."""
    rng = np.random.default_rng(0)
    tensors = {f"t{i}": rng.standard_normal((32, 64)).astype(
        np.float32 if i % 2 else np.float16) for i in range(6)}
    path = tmp_path / "p.gguf"
    tg.write_gguf(path, tensors)
    g = tg.read_gguf(path)
    arena = mock.Mock(wraps=native.native_load_tensors)
    with mock.patch.object(native, "native_load_tensors", arena):
        batch = g.read_tensors(list(tensors))
    assert arena.call_count == 1
    for name, arr in tensors.items():
        np.testing.assert_array_equal(batch[name], g.read_tensor(name))
        np.testing.assert_array_equal(batch[name], arr.astype(np.float32))


def test_failing_compiler_raises(tmp_path):
    with pytest.raises(native.NativeBuildError, match="false"):
        native.build(build_root=tmp_path, cxx="false")
    assert not list(tmp_path.rglob("*.so"))


def test_no_compiler_takes_the_numpy_path(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "compiler", lambda: None)
    assert native.get_lib() is None
    raw = np.zeros(34, np.uint8)
    assert native.native_dequantize(raw, tg.GGML_Q8_0, 32) is None
    np.testing.assert_array_equal(tg.dequantize(raw, tg.GGML_Q8_0, 32),
                                  np.zeros(32, np.float32))


def test_prebuilt_library_never_loaded(lib):
    """The port builds into its own build dir: the library it loads is not
    native/libqtts_native.so."""
    assert native.SOURCE.name == "qtts_native.cpp"
    with mock.patch.object(native, "_LIB", None), \
            mock.patch.object(native, "_TRIED", False), \
            mock.patch.object(ctypes, "CDLL", wraps=ctypes.CDLL) as cdll:
        assert native.get_lib() is not None
    (loaded,), _ = cdll.call_args
    assert "libqtts_native.so" in loaded
    assert "native-" in loaded and not loaded.endswith(
        "native/libqtts_native.so")
    assert "-march=native" not in native.CXX_FLAGS
