"""The port's GGUF reader (qwen3_tts_tpu_torch/io/gguf.py, a numpy copy)
against the JAX package's (qwen3_tts_tpu/io/gguf.py): every block type the
repository's GGUF tests build by hand (F32, F16, BF16, Q8_0, Q4_0, Q4_K,
Q5_K, Q6_K; tests/test_gguf.py) dequantizes to bit-equal arrays, over
several blocks each, and write_gguf -> read_gguf round-trips a file's
metadata and tensors the same way in both."""

import numpy as np
import pytest

from qwen3_tts_tpu.io import gguf as jg
from qwen3_tts_tpu_torch.io import gguf as tg


def _f16(rng, n, lo=0.01, hi=0.5):
    return rng.uniform(lo, hi, n).astype(np.float16)


def _blocks(kind, n_blocks, seed):
    """Raw bytes of n_blocks blocks of ggml type `kind`, with sane f16
    scale fields and random quant bytes (tests/test_gguf.py's layouts)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_blocks):
        if kind == jg.GGML_Q8_0:
            parts = [_f16(rng, 1).tobytes(),
                     rng.integers(-128, 128, 32, dtype=np.int8).tobytes()]
        elif kind == jg.GGML_Q4_0:
            parts = [_f16(rng, 1).tobytes(),
                     rng.integers(0, 256, 16, dtype=np.uint8).tobytes()]
        elif kind == jg.GGML_Q4_K:
            parts = [_f16(rng, 2).tobytes(),
                     rng.integers(0, 256, 12 + 128, dtype=np.uint8).tobytes()]
        elif kind == jg.GGML_Q5_K:
            parts = [_f16(rng, 2).tobytes(),
                     rng.integers(0, 256, 12 + 32 + 128,
                                  dtype=np.uint8).tobytes()]
        else:   # Q6_K: ql, qh, int8 scales, then d
            parts = [rng.integers(0, 256, 128 + 64, dtype=np.uint8).tobytes(),
                     rng.integers(-32, 32, 16, dtype=np.int8).tobytes(),
                     _f16(rng, 1).tobytes()]
        out.append(b"".join(parts))
    return np.frombuffer(b"".join(out), dtype=np.uint8)


@pytest.mark.parametrize("kind,elems", [
    (jg.GGML_Q8_0, 32), (jg.GGML_Q4_0, 32), (jg.GGML_Q4_K, 256),
    (jg.GGML_Q5_K, 256), (jg.GGML_Q6_K, 256)])
def test_quantized_blocks_bit_equal(kind, elems):
    assert tg.GGML_Q8_0 == jg.GGML_Q8_0 and tg._BLOCK_INFO == jg._BLOCK_INFO
    raw = _blocks(kind, 5, seed=kind)
    got = tg.dequantize(raw, kind, 5 * elems)
    want = jg.dequantize(raw, kind, 5 * elems)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()


def test_float_blocks_bit_equal():
    rng = np.random.default_rng(9)
    vals = rng.standard_normal(64).astype(np.float32)
    for kind, raw in (
            (tg.GGML_F32, vals.view(np.uint8)),
            (tg.GGML_F16, vals.astype(np.float16).view(np.uint8)),
            (tg.GGML_BF16,
             (vals.view(np.uint32) >> 16).astype(np.uint16).view(np.uint8))):
        got = tg.dequantize(raw, kind, 64)
        np.testing.assert_array_equal(got, jg.dequantize(raw, kind, 64))
        np.testing.assert_allclose(got, vals, rtol=1e-2)


def test_write_read_roundtrip_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "a.weight": rng.standard_normal((4, 8)).astype(np.float32),
        "b.bias": rng.standard_normal((16,)).astype(np.float32),
        "c.half": rng.standard_normal((2, 32)).astype(np.float16),
    }
    meta = {"general.architecture": "qwen3", "qwen3.block_count": 2,
            "pi": 3.5, "flag": True, "names": ["x", "y"],
            "sections": [24, 20, 20]}
    path = tmp_path / "t.gguf"
    tg.write_gguf(path, tensors, meta)
    got, want = tg.read_gguf(path), jg.read_gguf(path)
    assert got.metadata == want.metadata
    assert got.metadata["qwen3.block_count"] == 2
    assert got.metadata["flag"] is True
    assert got.data_start == want.data_start
    assert list(got.tensors) == list(want.tensors)
    both = got.read_tensors(list(tensors))
    for name, arr in tensors.items():
        t = got.tensors[name]
        assert (t.shape, t.ggml_type, t.offset) == (
            want.tensors[name].shape, want.tensors[name].ggml_type,
            want.tensors[name].offset)
        np.testing.assert_array_equal(both[name], want.read_tensor(name))
        np.testing.assert_array_equal(both[name], arr.astype(np.float32))
    # the JAX writer's file reads the same in the port
    jpath = tmp_path / "j.gguf"
    jg.write_gguf(jpath, tensors, meta)
    assert jpath.read_bytes() == path.read_bytes()
