"""The port's tracing and debug hooks (qwen3_tts_tpu_torch/utils/
tracing.py) on the CPU at EngineConfig.tiny(): QTTS_PROFILE_DIR writes a
torch.profiler Chrome trace of a request (and of a stream) whose codes
equal an untraced run's; QTTS_DEBUG_NANS raises FloatingPointError on a
NaN planted in a talker weight, naming what was not finite, and costs
nothing when off; TtsEngine reads the flags (apply_debug_flags) when it
is built, as the JAX engine does."""

import json

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
from qwen3_tts_tpu_torch.core.config import EngineConfig
from qwen3_tts_tpu_torch.utils import tracing

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def eng(tmp_path_factory):
    return TtsEngine(tmp_path_factory.mktemp("none"),
                     config=EngineConfig.tiny(), device="cpu",
                     speakers_dir="speakers")


def _engine(eng, **talker):
    """Another engine on `eng`'s weights (talker entries replaced)."""
    return TtsEngine(eng.model_dir, config=eng.config, device="cpu",
                     speakers_dir="speakers", weights=dict(
                         assets=eng.assets,
                         talker=dict(eng.talker_params, **talker),
                         predictor=eng.predictor_params,
                         codec_decoder=eng.codec_decoder_params))


def _request(eng):
    eng.set_max_steps(8)
    eng.set_sampler_config(SamplerConfig(temperature=0.0, seed=3))
    audio = eng.generate_with_voice("traced words", eng.get_speaker("vivian"))
    return eng.last_codes.copy(), audio.samples


def test_profile_dir_traces_a_request(eng, tmp_path, monkeypatch):
    want_codes, want_wav = _request(eng)
    monkeypatch.setenv("QTTS_PROFILE_DIR", str(tmp_path / "prof"))
    codes, wav = _request(eng)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(wav, want_wav)
    (trace,) = (tmp_path / "prof").glob("qtts_request-*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "qtts_request" in names            # the record_function span
    assert len(events) > 100                  # the request's ops
    chunks = list(eng.generate_stream("streamed", eng.get_speaker("vivian")))
    assert chunks
    assert list((tmp_path / "prof").glob("qtts_stream-*.pt.trace.json"))


def test_debug_nans_raises_on_a_planted_nan(eng, monkeypatch):
    monkeypatch.setenv("QTTS_DEBUG_NANS", "1")
    _request(_engine(eng))                    # finite weights: no raise
    assert tracing.DEBUG_NANS
    norm = eng.talker_params["final_norm"].clone()
    norm[0] = float("nan")
    with pytest.raises(FloatingPointError, match="not finite after the "
                                                 "prefill"):
        _request(_engine(eng, final_norm=norm))
    monkeypatch.delenv("QTTS_DEBUG_NANS")
    tracing.apply_debug_flags()
    assert not tracing.DEBUG_NANS
    tracing.check_finite("x", logits=torch.tensor([float("nan")]))   # off


def test_check_finite_names_the_tensor(monkeypatch):
    monkeypatch.setattr(tracing, "DEBUG_NANS", True)
    tracing.check_finite("a chunk", logits=torch.zeros(3), hidden=None,
                         audio=torch.ones(2))
    with pytest.raises(FloatingPointError, match="audio is not finite "
                                                 "after a chunk"):
        tracing.check_finite("a chunk", logits=torch.zeros(3),
                             audio=torch.tensor([0.0, float("inf")]))


def test_engine_applies_debug_flags(eng, monkeypatch):
    calls = []
    real = tracing.apply_debug_flags
    monkeypatch.setattr("qwen3_tts_tpu_torch.engine.apply_debug_flags",
                        lambda: calls.append(1) or real())
    monkeypatch.setenv("QTTS_CHECKS", "1")
    _engine(eng)
    assert calls == [1] and tracing.CHECKS
    monkeypatch.delenv("QTTS_CHECKS")
    _engine(eng)
    assert calls == [1, 1] and not tracing.CHECKS
