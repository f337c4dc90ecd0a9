"""The port's downloader (qwen3_tts_tpu_torch/io/download.py, a copy of
the JAX package's) on tests/test_download.py's cases, with HTTP faked by
monkeypatched urllib: nothing here reaches the network.  Also
TtsEngine.download_models and the CLI with and without --skip-download,
offline: without it the CLI warns and goes on in development mode; and
the CLI's --audition-voice."""

import io
import json
import urllib.error
import urllib.request

import pytest
import torch

from qwen3_tts_tpu.io import download as jdl
from qwen3_tts_tpu_torch.io import download as dl

torch.set_num_threads(1)


def test_manifest_per_quant():
    assert "gguf/qwen3_tts_talker.gguf" in dl.manifest("none")
    assert "gguf_q8_0/qwen3_assets.gguf" in dl.manifest("q8_0")
    assert "gguf_q5_k_m/qwen3_tts_predictor.gguf" in dl.manifest("q5_k_m")
    assert "tokenizer/tokenizer.json" in dl.manifest("none")
    assert "onnx/qwen3_tts_decoder.onnx" in dl.manifest("none")
    assert "onnx/qwen3_tts_codec_encoder.onnx" in dl.OPTIONAL_FILES
    assert "onnx/qwen3_tts_speaker_encoder.onnx" in dl.OPTIONAL_FILES
    for quant in dl.QUANT_SUBDIR:
        assert dl.manifest(quant) == jdl.manifest(quant)
    assert (dl.OPTIONAL_FILES, dl.QUANT_SUBDIR, dl.DEFAULT_REPO) == (
        jdl.OPTIONAL_FILES, jdl.QUANT_SUBDIR, jdl.DEFAULT_REPO)


def test_missing_files(tmp_path):
    missing = dl.missing_files(tmp_path, "none")
    assert len(missing) == 5
    (tmp_path / "tokenizer").mkdir()
    (tmp_path / "tokenizer" / "tokenizer.json").write_text("{}")
    assert len(dl.missing_files(tmp_path, "none")) == 4
    assert dl.missing_files(tmp_path, "q8_0") == jdl.missing_files(
        tmp_path, "q8_0")


def test_mirror_fallback(monkeypatch):
    monkeypatch.setattr(dl, "_probe", lambda url, timeout=3.0: False)
    assert dl.resolve_base().startswith(dl.HF_MIRROR)
    monkeypatch.setattr(dl, "_probe", lambda url, timeout=3.0: True)
    assert dl.resolve_base().startswith(dl.HF_BASE)


def test_base_override(monkeypatch):
    monkeypatch.setenv("QTTS_HF_BASE", "http://air.gapped/mirror/")
    assert dl.resolve_base("r/epo") == \
        "http://air.gapped/mirror/r/epo/resolve/main"


class _FakeResp(io.BytesIO):
    def __init__(self, data: bytes):
        super().__init__(data)
        self.headers = {"Content-Length": str(len(data))}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _fake_hub(monkeypatch, fetched):
    def fake_urlopen(req, timeout=None):
        url = req if isinstance(req, str) else req.full_url
        if getattr(req, "get_method", lambda: "GET")() == "HEAD":
            return _FakeResp(b"")
        fetched.append(url)
        return _FakeResp(b"fake-bytes")

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)


def test_check_and_download_fetches_missing(tmp_path, monkeypatch):
    fetched = []
    _fake_hub(monkeypatch, fetched)
    dl.check_and_download(tmp_path, "none", quiet=True)
    for rel in dl.manifest("none") + dl.OPTIONAL_FILES:
        p = tmp_path / rel
        assert p.exists() and p.read_bytes() == b"fake-bytes"
    assert not list(tmp_path.rglob("*.part"))
    assert len(fetched) == 7
    fetched.clear()
    dl.check_and_download(tmp_path, "none", quiet=True)
    assert fetched == []


def _offline(monkeypatch, calls=None):
    def fail_urlopen(req, timeout=None):
        if calls is not None:
            calls.append(req)
        raise urllib.error.URLError("no network")

    monkeypatch.setattr(urllib.request, "urlopen", fail_urlopen)


def test_check_and_download_raises_offline(tmp_path, monkeypatch):
    _offline(monkeypatch)
    with pytest.raises(RuntimeError, match="Place them under"):
        dl.check_and_download(tmp_path, "none", quiet=True)


def test_optional_failure_is_not_fatal(tmp_path, monkeypatch):
    def fake_urlopen(req, timeout=None):
        url = req if isinstance(req, str) else req.full_url
        if "codec_encoder" in url or "speaker_encoder" in url:
            raise urllib.error.URLError("403")
        return _FakeResp(b"ok")

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    dl.check_and_download(tmp_path, "none", quiet=True)  # must not raise
    assert (tmp_path / "onnx/qwen3_tts_decoder.onnx").exists()
    assert not (tmp_path / "onnx/qwen3_tts_codec_encoder.onnx").exists()


def test_engine_download_models(tmp_path, monkeypatch):
    from qwen3_tts_tpu_torch import TtsEngine
    fetched = []
    _fake_hub(monkeypatch, fetched)
    TtsEngine.download_models(tmp_path, "q8_0")
    assert all((tmp_path / rel).exists() for rel in dl.manifest("q8_0"))
    assert len(fetched) == 7
    _offline(monkeypatch)
    with pytest.raises(RuntimeError, match="Place them under"):
        TtsEngine.download_models(tmp_path / "empty", "none")


@pytest.mark.parametrize("skip", [False, True])
def test_cli_download_offline(tmp_path, monkeypatch, capsys, skip):
    """Offline, the CLI without --skip-download tries the hub (faked: every
    urlopen fails), warns and synthesizes in development mode; with it,
    urlopen is never called and nothing is said."""
    from qwen3_tts_tpu_torch.cli import main
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    calls = []
    _offline(monkeypatch, calls)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(EngineConfig.tiny().to_dict()))
    out = tmp_path / "out.wav"
    rc = main(["--text", "hi", "--device", "cpu", "--config", str(cfg),
               "--model-dir", str(tmp_path / "models"), "--max-steps", "4",
               "--seed", "1", "--output", str(out)]
              + (["--skip-download"] if skip else []))
    captured = capsys.readouterr()
    assert rc == 0 and out.exists()
    if skip:
        assert calls == [] and "[warn]" not in captured.err
    else:
        assert len(calls) > 0
        assert "Could not download required model files" in captured.err
        assert "development mode" in captured.err


def test_cli_audition_voice(tmp_path, capsys):
    """--audition-voice decodes a VoiceFile's reference codes to --output
    (frames x samples_per_frame) and exits before any synthesis."""
    import wave

    import numpy as np
    from qwen3_tts_tpu_torch.cli import main
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    from qwen3_tts_tpu_torch.io.voice_file import VoiceFile
    cfg = EngineConfig.tiny()
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg.to_dict()))
    codes = np.random.default_rng(0).integers(0, 2048, 5 * 16)
    voice = tmp_path / "voice.json"
    VoiceFile.new("ref words", codes, np.zeros(2048, np.float32)).save(voice)
    out = tmp_path / "audition.wav"
    rc = main(["--text", "unused", "--device", "cpu", "--config", str(path),
               "--skip-download", "--model-dir", str(tmp_path / "models"),
               "--audition-voice", str(voice), "--output", str(out)])
    assert rc == 0
    assert "Auditioned 5 reference frames" in capsys.readouterr().out
    with wave.open(str(out)) as w:
        assert w.getnframes() == 5 * cfg.codec_decoder.samples_per_frame
