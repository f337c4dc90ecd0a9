"""The port's real-checkpoint runbook (qwen3_tts_tpu_torch/verify.py) on
tests/test_verify.py's cases, with --device cpu.  The hub probe is faked
(air-gapped or published) by monkeypatching io.download._probe: nothing
here reaches the network.  Also: the tokenizer drill SKIPs, naming the
package, where a tokenizer.json is present but `tokenizers` cannot be
imported; the assets / talker / predictor GGUF drills PASS on a tiny
model directory written here; the golden-wav body records, then verifies."""

import json
import sys

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import verify as v
from qwen3_tts_tpu_torch.io import download as dl

torch.set_num_threads(1)
DRILLS = ("files", "hub-probe", "tokenizer", "assets-gguf", "talker-gguf",
          "predictor-gguf", "llama-parity", "onnx-decoder-import",
          "native-decoder-validate", "encoder-import", "speaker-import",
          "golden-wav")


@pytest.fixture
def air_gapped(monkeypatch):
    monkeypatch.setattr(dl, "_probe", lambda url, timeout=3.0: False)


def _summary(capsys):
    out = capsys.readouterr().out
    return out, json.loads(out.strip().splitlines()[-1])


def test_empty_dir_all_skip(tmp_path, capsys, air_gapped):
    rc = v.main(["--model-dir", str(tmp_path / "nothing"), "--device", "cpu"])
    _, summary = _summary(capsys)
    assert rc == 0
    assert summary["fail"] == 0 and summary["pass"] == 0
    assert summary["skip"] == len(summary["drills"]) == len(DRILLS)
    assert summary["ready"] is False
    assert list(summary["drills"]) == list(DRILLS)     # the JAX order
    assert set(summary["drills"].values()) == {"SKIP"}
    assert set(summary) == {"metric", "model_dir", "quant", "pass", "fail",
                            "skip", "drills", "ready"}


def test_hub_probe_notices_published_files(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(dl, "_probe", lambda url, timeout=3.0: True)
    rc = v.main(["--model-dir", str(tmp_path / "nothing"), "--device", "cpu"])
    out, summary = _summary(capsys)
    assert rc == 0
    assert summary["drills"]["hub-probe"] == "PASS"
    assert "published" in out
    assert "python -m qwen3_tts_tpu_torch.verify --download" in out


def test_hub_probe_partial_publication(monkeypatch):
    def probe(url, timeout=3.0):
        return url.endswith("tokenizer.json") or "/resolve/" not in url

    monkeypatch.setattr(dl, "_probe", probe)
    res = dl.probe_manifest()
    assert res["published"] == ["tokenizer/tokenizer.json"]
    assert len(res["absent"]) == len(dl.manifest()) + len(
        dl.OPTIONAL_FILES) - 1


def test_broken_file_fails(tmp_path, capsys, air_gapped):
    tok = tmp_path / "tokenizer"
    tok.mkdir(parents=True)
    (tok / "tokenizer.json").write_text("this is not json")
    rc = v.main(["--model-dir", str(tmp_path), "--device", "cpu"])
    _, summary = _summary(capsys)
    assert rc == 1
    assert summary["drills"]["tokenizer"] == "FAIL"
    assert summary["drills"]["assets-gguf"] == "SKIP"


def test_tokenizer_package_missing_skips(tmp_path, capsys, air_gapped,
                                         monkeypatch):
    """A tokenizer.json where `tokenizers` is not installed (the card's
    machine): SKIP naming the package, not FAIL."""
    tok = tmp_path / "tokenizer"
    tok.mkdir(parents=True)
    (tok / "tokenizer.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    rc = v.main(["--model-dir", str(tmp_path), "--device", "cpu"])
    out, summary = _summary(capsys)
    assert rc == 0
    assert summary["drills"]["tokenizer"] == "SKIP"
    assert "`tokenizers` package is not installed" in out


def test_assets_drill_validates_shapes(tmp_path, capsys, air_gapped):
    from qwen3_tts_tpu_torch.io import gguf
    d = tmp_path / "gguf"
    d.mkdir(parents=True)
    tensors = {
        "proj.weight": np.zeros((8, 16), np.float32),
        "proj.bias": np.zeros((8,), np.float32),
        "text_embd": np.zeros((32, 16), np.float32),
        **{f"codec_embd.{i}": np.zeros((4, 16), np.float32)
           for i in range(16)},
    }
    gguf.write_gguf(d / "qwen3_assets.gguf", tensors,
                    {"general.architecture": "qwen3"})
    rc = v.main(["--model-dir", str(tmp_path), "--device", "cpu"])
    out, summary = _summary(capsys)
    assert rc == 1
    assert summary["drills"]["assets-gguf"] == "FAIL"
    assert "assets-gguf" in out
    assert summary["drills"]["predictor-gguf"] == "SKIP"


def _lm_gguf(path, c, vocab, rng):
    from qwen3_tts_tpu_torch.io.gguf import write_gguf
    d, f, dq, dkv = (c.d_model, c.d_ff, c.n_heads * c.head_dim,
                     c.n_kv_heads * c.head_dim)

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-1] ** -0.5).astype(
            np.float16)
    t = {"output_norm.weight": np.ones(d, np.float32),
         "output.weight": w(vocab, d)}
    for i in range(c.n_layers):
        p = f"blk.{i}."
        t.update({p + "attn_norm.weight": np.ones(d, np.float32),
                  p + "ffn_norm.weight": np.ones(d, np.float32),
                  p + "attn_q.weight": w(dq, d), p + "attn_k.weight": w(dkv, d),
                  p + "attn_v.weight": w(dkv, d),
                  p + "attn_output.weight": w(d, dq),
                  p + "attn_q_norm.weight": np.ones(c.head_dim, np.float32),
                  p + "attn_k_norm.weight": np.ones(c.head_dim, np.float32),
                  p + "ffn_gate.weight": w(f, d), p + "ffn_up.weight": w(f, d),
                  p + "ffn_down.weight": w(d, f)})
    meta = {"general.architecture": "qwen3",
            "qwen3.block_count": c.n_layers,
            "qwen3.attention.head_count": c.n_heads,
            "qwen3.attention.head_count_kv": c.n_kv_heads,
            "qwen3.embedding_length": d, "qwen3.feed_forward_length": f,
            "qwen3.attention.key_length": c.head_dim}
    if hasattr(c, "mrope_sections"):
        meta["qwen3.rope.mrope_section"] = list(c.mrope_sections[:3])
    write_gguf(path, t, meta)


def test_gguf_drills_pass_on_a_tiny_dir(tmp_path, capsys, air_gapped):
    """assets-gguf, talker-gguf and predictor-gguf PASS on a directory at
    EngineConfig.tiny()'s LM dims; llama-parity writes its inputs and
    SKIPs asking for the dump; the golden-wav body records its file on a
    tiny development engine, then verifies it on a second run, and fails
    on a changed record."""
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    from qwen3_tts_tpu_torch.io.gguf import write_gguf
    cfg = EngineConfig.tiny()
    rng = np.random.default_rng(0)
    d = tmp_path / "gguf_q8_0"
    d.mkdir()
    write_gguf(d / "qwen3_assets.gguf", {
        "proj.weight": rng.standard_normal((1024, 2048)).astype(np.float32),
        "proj.bias": np.zeros(1024, np.float32),
        "text_embd": rng.standard_normal((64, 2048)).astype(np.float16),
        **{f"codec_embd.{i}": rng.standard_normal((40, 2048)).astype(
            np.float16) for i in range(16)}}, {})
    _lm_gguf(d / "qwen3_tts_talker.gguf", cfg.talker, 2176, rng)
    _lm_gguf(d / "qwen3_tts_predictor.gguf", cfg.predictor,
             cfg.predictor.vocab_size, rng)
    drills = v.run_drills(tmp_path, quant="q8_0", device="cpu")
    status = {dr.name: dr.status for dr in drills}
    assert [dr.name for dr in drills] == list(DRILLS)
    for name in ("assets-gguf", "talker-gguf", "predictor-gguf"):
        assert status[name] == "PASS", drills
    assert status["llama-parity"] == "SKIP"
    assert (tmp_path / "parity" / "inputs.npz").exists()
    assert "layers=2 d_model=2048 heads=4/2 head_dim=16" in next(
        dr.detail for dr in drills if dr.name == "talker-gguf")
    assert not any(dr.status == "FAIL" for dr in drills)

    from qwen3_tts_tpu_torch import TtsEngine
    # a development engine: the 40 codec rows above are too few to decode
    eng = TtsEngine(tmp_path / "dev", config=cfg, device="cpu",
                    speakers_dir="speakers")
    gpath = tmp_path / "golden" / "g.json"
    assert "RECORDED" in v.golden_run(eng, gpath)
    assert "matches recorded golden" in v.golden_run(eng, gpath)
    stats = json.loads(gpath.read_text())
    stats["rms"] *= 1.5
    gpath.write_text(json.dumps(stats))
    with pytest.raises(RuntimeError, match="golden mismatch on rms"):
        v.golden_run(eng, gpath)
