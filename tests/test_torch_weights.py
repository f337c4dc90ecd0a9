"""The port's GGUF weight import and weight cache (qwen3_tts_tpu_torch/io/
weights.py, io/checkpoint.py) against the JAX package's io/weights.py, on
the llama.cpp-style checkpoints tests/test_weights.py writes: the derived
configs are equal, every loaded tensor is bit-equal (f32 and bf16 model
dtypes), the cache round-trips, is invalidated by a changed source, leaves
nothing behind when a save fails, and `TtsEngine(weight_cache=False)`
writes nothing."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from qwen3_tts_tpu.core.config import PredictorConfig as JPC
from qwen3_tts_tpu.core.config import TalkerConfig as JTC
from qwen3_tts_tpu.io import weights as JW
from qwen3_tts_tpu_torch.core.config import PredictorConfig as TPC
from qwen3_tts_tpu_torch.core.config import TalkerConfig as TTC
from qwen3_tts_tpu_torch.io import checkpoint as ckpt
from qwen3_tts_tpu_torch.io import weights as TW
from qwen3_tts_tpu_torch.io.gguf import read_gguf
from test_weights import _fake_ckpt

torch.set_num_threads(1)


def _np(t):
    return t.float().numpy()


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    w = np.asarray(want.astype("float32") if str(want.dtype) == "bfloat16"
                   else want)
    assert tuple(got.shape) == w.shape, path
    np.testing.assert_array_equal(_np(got), w.astype(np.float32),
                                  err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_talker_import_equals_jax(tmp_path, dtype):
    path = tmp_path / "talker.gguf"
    _fake_ckpt(path, JTC.tiny(), vocab=4096)
    jcfg, jparams = JW.load_talker_gguf(
        path, dataclasses.replace(JTC.tiny(), dtype=dtype))
    tcfg, tparams = TW.load_talker_gguf(
        path, dataclasses.replace(TTC.tiny(), dtype=dtype))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.rope_theta == pytest.approx(77000.0)
    assert tparams["codec_head"].shape[0] == tcfg.n_codec_logits
    assert tparams["layers"]["wqkv"].dtype == getattr(torch, dtype)
    _assert_tree_equal(tparams, jparams)


def test_predictor_import_and_config_equal_jax(tmp_path):
    path = tmp_path / "pred.gguf"
    _fake_ckpt(path, JPC.tiny(), vocab=JPC.tiny().vocab_size)
    jcfg, jparams = JW.load_predictor_gguf(path, JPC.tiny())
    tcfg, tparams = TW.load_predictor_gguf(path, TPC.tiny())
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(TW.config_from_gguf(read_gguf(path),
                                                  TPC.tiny())) == \
        dataclasses.asdict(JW.config_from_gguf(JW.read_gguf(path),
                                               JPC.tiny()))
    _assert_tree_equal(tparams, jparams)


def test_weight_cache_roundtrip_and_invalidation(tmp_path):
    path = tmp_path / "talker.gguf"
    _fake_ckpt(path, JTC.tiny(), vocab=4096)
    cfg, params = TW.load_talker_gguf(path, TTC.tiny())
    from qwen3_tts_tpu_torch.ops.quant import quantize_decoder_layers
    params["layers"] = quantize_decoder_layers(params["layers"])
    fp = ckpt.fingerprint(path, True)
    assert ckpt.save_lm(tmp_path, "talker_q8_0", params, cfg, fp)
    assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == [
        "talker_q8_0"]
    hit = ckpt.load_lm(tmp_path, "talker_q8_0", fp, TTC)
    assert hit is not None
    got, got_cfg = hit
    assert got_cfg == cfg
    assert got["layers"]["wqkv"]["q"].dtype == torch.int8
    for name in ("wqkv", "w_down"):
        for k in ("q", "s"):
            assert torch.equal(got["layers"][name][k],
                               params["layers"][name][k])
    assert torch.equal(got["codec_head"], params["codec_head"])
    # another int8 flag, or a touched source, misses
    assert ckpt.load_lm(tmp_path, "talker_q8_0",
                        ckpt.fingerprint(path, False), TTC) is None
    st = path.stat()
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert ckpt.load_lm(tmp_path, "talker_q8_0",
                        ckpt.fingerprint(path, True), TTC) is None


def test_failed_save_leaves_nothing(tmp_path):
    path = tmp_path / "pred.gguf"
    _fake_ckpt(path, JPC.tiny(), vocab=JPC.tiny().vocab_size)
    cfg, params = TW.load_predictor_gguf(path, TPC.tiny())
    fp = ckpt.fingerprint(path, False)
    params["not_a_tensor"] = lambda: None          # torch.save refuses it
    assert not ckpt.save_lm(tmp_path, "predictor_none", params, cfg, fp)
    assert list((tmp_path / "cache").iterdir()) == []
    assert ckpt.load_lm(tmp_path, "predictor_none", fp, TPC) is None


def test_engine_weight_cache_off_writes_nothing(tmp_path):
    from qwen3_tts_tpu_torch import EngineConfig, TtsEngine
    gdir = tmp_path / "gguf_q8_0"
    gdir.mkdir()
    _fake_ckpt(gdir / "qwen3_tts_talker.gguf", JTC.tiny(), vocab=4096)
    before = sorted(p.name for p in tmp_path.rglob("*"))
    eng = TtsEngine(model_dir=tmp_path, config=EngineConfig.tiny(),
                    device="cpu", quant="q8_0", weight_cache=False)
    assert sorted(p.name for p in tmp_path.rglob("*")) == before
    assert eng.weight_sources == {"talker": "gguf"}
    assert "talker" not in eng.dev_mode_components
    assert eng.talker_params["layers"]["wqkv"]["q"].dtype == torch.int8
    # and with the cache on, the second engine reads it
    eng1 = TtsEngine(model_dir=tmp_path, config=EngineConfig.tiny(),
                     device="cpu", quant="q8_0")
    assert (tmp_path / "cache" / "talker_q8_0" / "meta.json").exists()
    assert not (tmp_path / "cache" / "predictor_q8_0").exists()
    eng2 = TtsEngine(model_dir=tmp_path, config=EngineConfig.tiny(),
                     device="cpu", quant="q8_0")
    assert eng2.weight_sources == {"talker": "cache"}
    assert eng2.config.talker == eng1.config.talker
    for k in ("q", "s"):
        assert torch.equal(eng2.talker_params["layers"]["wo"][k],
                           eng1.talker_params["layers"]["wo"][k])
