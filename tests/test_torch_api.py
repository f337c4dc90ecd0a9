"""The port's HTTP API (qwen3_tts_tpu_torch/serve/api.py) on the CPU: a
stdlib client against an in-process server on 127.0.0.1, an engine at
EngineConfig.tiny(), one torch thread.

The port counterparts of tests/test_api.py (health, /tts, /tts?stream=1,
a bad request, an unknown path, /tts through the online batcher); the WAV
bytes equal to the JAX package's `_wav_bytes` on the same samples; and a
direct /tts response whose audio equals engine.generate_with_voice's for
the same seed (its PCM16 bytes, exactly), its stream the PCM16 of
generate_stream's pieces.
"""

import io
import json
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from qwen3_tts_tpu.serve.api import _wav_bytes as jax_wav_bytes
from qwen3_tts_tpu_torch.core.config import EngineConfig as TC
from qwen3_tts_tpu_torch.core.config import SamplerConfig as TS
from qwen3_tts_tpu_torch.engine import TtsEngine
from qwen3_tts_tpu_torch.io.voice_file import VoiceFile
from qwen3_tts_tpu_torch.serve.api import TtsServer, _pcm16, _wav_bytes, main
from qwen3_tts_tpu_torch.serve.online import OnlineBatcher

torch.set_num_threads(1)

TIMEOUT = 120


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    root = tmp_path_factory.mktemp("api")
    spk = root / "preset_speakers"
    spk.mkdir()
    VoiceFile.new("", [], np.random.default_rng(0).standard_normal(2048)
                  .astype(np.float32) * 0.02).save(spk / "vivian.json")
    eng = TtsEngine(model_dir=root, config=TC.tiny(), device="cpu")
    eng.set_max_steps(4)
    return eng


@pytest.fixture(scope="module")
def server(engine):
    srv = TtsServer(engine, host="127.0.0.1", port=0).start()
    yield srv
    srv.stop()


def _url(server, path):
    return f"http://127.0.0.1:{server.port}{path}"


def _post(server, path, body: bytes):
    return urllib.request.Request(
        _url(server, path), data=body,
        headers={"Content-Type": "application/json"})


def _wav_samples(data: bytes):
    with wave.open(io.BytesIO(data)) as w:
        assert w.getframerate() == 24000
        assert w.getnchannels() == 1
        assert w.getsampwidth() == 2
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def test_health(server):
    with urllib.request.urlopen(_url(server, "/health"),
                                timeout=TIMEOUT) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok"
    assert "vivian" in body["speakers"]


def test_tts_endpoint_equals_generate_with_voice(server, engine):
    body = {"text": "server test", "speaker": "vivian", "seed": 5,
            "max_steps": 4}
    with urllib.request.urlopen(_post(server, "/tts",
                                      json.dumps(body).encode()),
                                timeout=TIMEOUT) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        assert r.headers.get("X-QTTS-RTF") is not None
        frames = int(r.headers["X-QTTS-Frames"])
        pcm = _wav_samples(r.read())
    spf = engine.config.codec_decoder.samples_per_frame
    assert 0 < frames <= 4 and len(pcm) == frames * spf
    engine.set_sampler_config(TS(seed=5))
    want = engine.generate_with_voice("server test",
                                      engine.get_speaker("vivian"))
    np.testing.assert_array_equal(pcm, np.frombuffer(_pcm16(want.samples),
                                                     np.int16))


def test_tts_stream_endpoint(server, engine):
    body = {"text": "stream", "seed": 2, "max_steps": 4}
    with urllib.request.urlopen(_post(server, "/tts?stream=1",
                                      json.dumps(body).encode()),
                                timeout=TIMEOUT) as r:
        assert r.headers["Content-Type"].startswith("audio/L16")
        pcm = r.read()                  # urllib undoes the chunking
    engine.set_sampler_config(TS(seed=2))
    pieces = list(engine.generate_stream("stream",
                                         engine.get_speaker("vivian")))
    assert pcm == b"".join(_pcm16(p) for p in pieces)
    assert len(pcm) // 2 % engine.config.codec_decoder.samples_per_frame == 0


def test_bad_request(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_post(server, "/tts", b"not json"),
                               timeout=TIMEOUT)
    assert e.value.code == 400


def test_not_found(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(server, "/nope"), timeout=TIMEOUT)
    assert e.value.code == 404


def test_tts_via_online_batcher(engine):
    """Batched mode: /tts goes through the OnlineBatcher with max_steps as
    the request's budget, and the engine's budget is left alone."""
    ob = OnlineBatcher(engine, batch_size=2, bucket=32,
                       max_frames_per_stream=3, idle_poll_s=0.01).start()
    srv = TtsServer(engine, host="127.0.0.1", port=0, batcher=ob).start()
    try:
        before = engine.max_steps
        with urllib.request.urlopen(_post(srv, "/tts", json.dumps(
                {"text": "batched", "max_steps": 3}).encode()),
                timeout=TIMEOUT) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            frames = int(r.headers["X-QTTS-Frames"])
            pcm = _wav_samples(r.read())
        assert 0 < frames <= 3
        assert len(pcm) == frames * engine.config.codec_decoder \
            .samples_per_frame
        assert engine.max_steps == before
    finally:
        srv.stop()
        ob.stop()


@pytest.mark.parametrize("body", [
    {"text": "x", "max_steps": "twelve"}, {"text": "x", "max_steps": 0},
    {"text": "x", "max_steps": [3]}, {"text": "x", "top_k": "many"},
    {"text": "x", "temperature": {}}, ["text"]])
def test_bad_fields_answer_400(server, body):
    """A field that does not parse, or a max_steps below 1, answers 400 in
    direct mode, before anything of the engine is set."""
    before = (server.engine.max_steps, server.engine.sampler_config)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_post(server, "/tts",
                                     json.dumps(body).encode()),
                               timeout=TIMEOUT)
    assert e.value.code == 400
    assert (server.engine.max_steps, server.engine.sampler_config) == before


def test_batched_budgets_keep_the_batcher_serving(engine):
    """Batched mode: a max_steps that does not parse answers 400, one
    given as a string of digits is that budget, one past the cache's room
    is cut to it (bucket 480 of the tiny config: a 512-slot cache, room
    for 28 frames); the batcher serves each and every request after
    them."""
    ob = OnlineBatcher(engine, batch_size=2, bucket=480, idle_poll_s=0.01)
    srv = TtsServer(engine, host="127.0.0.1", port=0, batcher=ob).start()
    spf = engine.config.codec_decoder.samples_per_frame

    def tts(body):
        with urllib.request.urlopen(_post(srv, "/tts", json.dumps(
                body).encode()), timeout=TIMEOUT) as r:
            frames = int(r.headers["X-QTTS-Frames"])
            assert len(_wav_samples(r.read())) == frames * spf
            return frames

    try:
        for bad in ("12 frames", -1, "3.5"):
            with pytest.raises(urllib.error.HTTPError) as e:
                tts({"text": "bad", "max_steps": bad})
            assert e.value.code == 400
        assert 0 < tts({"text": "digits", "max_steps": "3"}) <= 3
        assert 0 < tts({"text": "huge", "max_steps": 10 ** 9}) <= 28
        assert 0 < tts({"text": "after", "max_steps": 2}) <= 2
        assert ob._thread.is_alive()
    finally:
        srv.stop()
        ob.stop()


def test_wav_bytes_equal_jax():
    x = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    x[:3] = (1.5, -1.5, 0.5 / 32767)            # clipped, rounded
    assert _wav_bytes(x) == jax_wav_bytes(x)
    assert _wav_bytes(x[:0]) == jax_wav_bytes(x[:0])


def test_main_flags(capsys):
    """`main` takes the JAX server's flags and --device (default cuda)."""
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--model-dir", "--quant", "--host", "--port", "--batch",
                 "--bucket", "--buckets", "--warmup", "--device"):
        assert flag in out, flag
    assert "default cuda" in out
