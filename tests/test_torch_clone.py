"""Voice cloning from reference audio in the port, on the CPU, against the
JAX package: the log-mel front-end, the codec encoder and its residual VQ,
the speaker encoder, the `.cache` sidecar, and TtsEngine.create_voice_file
/ generate / decode_codes / warmup and the CLI's --ref-audio at
EngineConfig.tiny(), on the same weights (the JAX parameter trees
converted through io/from_jax), one torch thread.

Tolerances.  Codes (encoder, RVQ, greedy clone frames) must be exactly
equal: the argmins are far from ties at these sizes, and the f32 sums in
another order move a score by ~1e-6.  Log-mel within MEL_ATOL = 1e-4:
pocketfft in both, f32, other summation orders in the FFT and the
filterbank product.  Speaker embeddings within EMB_ATOL = 1e-5 (f32, a
unit-norm vector).  Waveforms within WAV_ATOL = 1e-5, as the stream tests
hold them.  The sidecar's bytes are identical.
"""

import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.core.config import CodecEncoderConfig as JEncCfg
from qwen3_tts_tpu.core.config import SamplerConfig as JS
from qwen3_tts_tpu.core.config import SpeakerEncoderConfig as JSpkCfg
from qwen3_tts_tpu.io import cache as jcache
from qwen3_tts_tpu.io.voice_file import VoiceFile as JVoice
from qwen3_tts_tpu.models.codec import decoder as jcd
from qwen3_tts_tpu.models.codec import encoder as jenc
from qwen3_tts_tpu.models.codec import speaker as jspk
from qwen3_tts_tpu.ops import mel as jmel
from qwen3_tts_tpu.prompt import PromptBuilder as JPB
from qwen3_tts_tpu.runtime.generate import SamplerParams as JSP
from qwen3_tts_tpu_torch.core.config import CodecEncoderConfig as TEncCfg
from qwen3_tts_tpu_torch.core.config import EngineConfig as TC
from qwen3_tts_tpu_torch.core.config import SamplerConfig as TS
from qwen3_tts_tpu_torch.core.config import SpeakerEncoderConfig as TSpkCfg
from qwen3_tts_tpu_torch.engine import PromptTooLongError, TtsEngine
from qwen3_tts_tpu_torch.io import cache as tcache
from qwen3_tts_tpu_torch.io.audio import AudioSample
from qwen3_tts_tpu_torch.io.from_jax import (encoder_from_jax, engine_weights,
                                             speaker_from_jax)
from qwen3_tts_tpu_torch.io.voice_file import VoiceFile as TVoice
from qwen3_tts_tpu_torch.models.codec import encoder as tenc
from qwen3_tts_tpu_torch.models.codec.onnx_decoder import OnnxLoadError
from qwen3_tts_tpu_torch.models.codec import speaker as tspk
from qwen3_tts_tpu_torch.ops import mel as tmel
from test_torch_engine_gguf import _flatten

torch.set_num_threads(1)

MEL_ATOL = 1e-4
EMB_ATOL = 1e-5
WAV_ATOL = 1e-5
GREEDY = dict(temperature=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _audio(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 0.2
            ).astype(np.float32)


# ------------------------------------------------------------------ mel
@pytest.mark.parametrize("args", [
    (24000, 1024, 128, 0.0, 12000.0),
    (16000, 512, 80, 20.0, 7600.0),
])
def test_filterbank_and_window_equal_jax(args):
    np.testing.assert_array_equal(tmel.mel_filterbank(*args),
                                  jmel.mel_filterbank(*args))
    np.testing.assert_array_equal(tmel.hann_window(args[1]),
                                  jmel.hann_window(args[1]))


@pytest.mark.parametrize("shape", [(20,), (300,), (1000,), (2000,),
                                   (24000,), (2, 1500)])
def test_log_mel_matches_jax(shape):
    x = _audio(int(np.prod(shape)), 1).reshape(shape)
    want = np.asarray(jmel.log_mel(jnp.asarray(x)))
    got = tmel.log_mel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=MEL_ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 20, 300, 1000])
def test_reflect_pad_is_numpys(n):
    x = _audio(n, 2)
    for pad in (1, 3, 384):
        np.testing.assert_array_equal(
            tmel.reflect_pad(torch.from_numpy(x), pad).numpy(),
            np.pad(x, (pad, pad), mode="reflect"))


# -------------------------------------------------------------- encoder
ENC_CFGS = {
    "tiny": (JEncCfg.tiny(), TEncCfg.tiny()),
    "kernel_mult3": (JEncCfg(d_model=24, downsample_factors=(3, 2, 2),
                             channels=(8, 16, 24), conv_kernel=5,
                             stage_kernel_mult=3),
                     TEncCfg(d_model=24, downsample_factors=(3, 2, 2),
                             channels=(8, 16, 24), conv_kernel=5,
                             stage_kernel_mult=3)),
}


@pytest.mark.parametrize("name", sorted(ENC_CFGS))
@pytest.mark.parametrize("frames,extra", [(0, 3), (7, 1), (25, 3)])
def test_encode_matches_jax(name, frames, extra):
    jcfg, tcfg = ENC_CFGS[name]
    spf = tenc.samples_per_frame(tcfg)
    params = jenc.init_encoder_params(jcfg, jax.random.PRNGKey(7))
    wav = _audio(2 * (frames * spf + extra), frames).reshape(2, -1)
    want = np.asarray(jenc.encode(jcfg, params, jnp.asarray(wav)))
    got = tenc.encode(tcfg, encoder_from_jax(_np(params)),
                      torch.from_numpy(wav))
    assert got.dtype == torch.int32
    assert got.shape == want.shape == (2, wav.shape[1] // spf, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rvq_encode_matches_jax():
    rng = np.random.default_rng(3)
    cb = rng.standard_normal((16, 2048, 32)).astype(np.float32)
    z = (rng.standard_normal((2, 9, 32)) * 3).astype(np.float32)
    want = np.asarray(jenc.rvq_encode(jnp.asarray(cb), jnp.asarray(z)))
    got = tenc.rvq_encode(torch.from_numpy(cb), torch.from_numpy(z))
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_encoder_params_shapes_match_jax():
    for jcfg, tcfg in ENC_CFGS.values():
        want = _np(jenc.init_encoder_params(jcfg, jax.random.PRNGKey(0)))
        got = tenc.init_encoder_params(tcfg, torch.Generator().manual_seed(0))
        conv = encoder_from_jax(want)
        got, conv = _flatten(got), _flatten(conv)
        assert sorted(got) == sorted(conv)
        for k in got:
            assert got[k].shape == conv[k].shape, k
            assert got[k].dtype == conv[k].dtype, k


# -------------------------------------------------------------- speaker
@pytest.mark.parametrize("pooling", ["attentive", "xvector"])
@pytest.mark.parametrize("n", [20, 300, 5000])
def test_speaker_embed_matches_jax(pooling, n):
    jcfg = JSpkCfg(d_model=16, n_layers=2, pooling=pooling)
    tcfg = TSpkCfg(d_model=16, n_layers=2, pooling=pooling)
    params = jspk.init_speaker_params(jcfg, jax.random.PRNGKey(4))
    wav = _audio(n, n)
    got = tspk.speaker_embed(tcfg, speaker_from_jax(_np(params)),
                             torch.from_numpy(wav)).numpy()
    if n == 20 and pooling == "xvector":
        # no mel frame: the JAX x-vector weights divide by zero frames
        # (ZeroDivisionError); the port gives the embedding of zero
        # statistics, as both give with attentive pooling
        with pytest.raises(ZeroDivisionError):
            jspk.speaker_embed(jcfg, params, jnp.asarray(wav))
        stats = np.concatenate([np.zeros(16), np.full(16, 1e-3)])
        emb = stats.astype(np.float32) @ np.asarray(params["head"])
        want = (emb / (np.linalg.norm(emb) + 1e-9))[None]
    else:
        want = np.asarray(jspk.speaker_embed(jcfg, params, jnp.asarray(wav)))
    assert got.shape == want.shape == (1, 2048)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=EMB_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, atol=1e-5)


def test_speaker_refuses_unknown_pooling():
    with pytest.raises(ValueError, match="pooling"):
        tspk.init_speaker_params(TSpkCfg(pooling="mean"),
                                 torch.Generator().manual_seed(0))


# ---------------------------------------------------------------- cache
def test_cache_bytes_equal_and_cross_load(tmp_path):
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 2048, size=7 * 16)
    emb = rng.standard_normal(2048).astype(np.float32)
    tcache.save_cache(tmp_path / "t.cache", codes, emb)
    jcache.save_cache(tmp_path / "j.cache", codes, emb)
    assert ((tmp_path / "t.cache").read_bytes()
            == (tmp_path / "j.cache").read_bytes())
    for load, path in ((tcache.load_cache, "j.cache"),
                       (jcache.load_cache, "t.cache")):
        c, e = load(tmp_path / path)
        np.testing.assert_array_equal(c, codes)
        np.testing.assert_array_equal(e, emb)
        assert c.dtype == np.int64 and e.dtype == np.float32


@pytest.mark.parametrize("corrupt", ["magic", "version", "short", "count"])
def test_cache_refuses_bad_files(tmp_path, corrupt):
    path = tmp_path / "x.cache"
    tcache.save_cache(path, np.arange(32), np.ones(8, np.float32))
    data = bytearray(path.read_bytes())
    if corrupt == "magic":
        data[:4] = b"XXXX"
    elif corrupt == "version":
        data[4] = 2
    elif corrupt == "count":  # a damaged code count: 2**62 codes
        data[8:16] = (1 << 62).to_bytes(8, "little")
    else:
        data = data[:-5]
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        tcache.load_cache(path)
    if corrupt in ("magic", "version"):
        with pytest.raises(ValueError):
            jcache.load_cache(path)


# --------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def pair(tiny_engine):
    je = tiny_engine
    a = je.assets
    weights = engine_weights(
        dict(text_table=np.asarray(a.text_table),
             codec_tables=np.asarray(a.codec_tables),
             codec_tables_1024=np.asarray(a.codec_tables_1024),
             proj_w=np.asarray(a.proj_w), proj_b=np.asarray(a.proj_b),
             tts_pad=np.asarray(a.tts_pad)),
        _np(je.talker_params), _np(je.predictor_params),
        _np(je.codec_decoder_params),
        codec_encoder=_np(je.codec_encoder_params),
        speaker_encoder=_np(je.speaker_params))
    te = TtsEngine(model_dir=je.model_dir, config=TC.tiny(), device="cpu",
                   weights=weights)
    # the JAX engine is shared with other test files of this worker:
    # give it back as it came
    saved = (je.max_steps, je.sampler_config, je.config, je.generator,
             je._prefix_kv_max, dict(je._prefix_kv))
    yield je, te
    (je.max_steps, je.sampler_config, je.config, je.generator,
     je._prefix_kv_max, kv) = saved
    je._prefix_kv.clear()
    je._prefix_kv.update(kv)


def _set(pair, max_steps, seed=3):
    for eng, sc in zip(pair, (JS, TS)):
        eng.set_max_steps(max_steps)
        eng.set_sampler_config(sc(seed=seed, **GREEDY))


def _ref_wav(path, frames, extra=0, seed=0):
    """A reference WAV of `frames` codec-encoder frames (tiny: 4 samples
    each) plus `extra` samples; returns its path."""
    spf = tenc.samples_per_frame(TC.tiny().codec_encoder)
    AudioSample(samples=_audio(frames * spf + extra, seed),
                sample_rate=24000).save_wav(path)
    return path


def _jax_clone_codes(je, text, codes, emb, ref_text, seed, max_frames):
    """The JAX engine's generate up to its codes (its _run_inference on
    the clone plan, through _start_state)."""
    plan = JPB.plan_clone(text, je.tokenizer, ref_codes=codes,
                          ref_text_ids=je.tokenizer.encode(ref_text),
                          spk_emb=emb, lang_id=je.config.lang_id)
    state, bucket = je._start_state(plan, jax.random.PRNGKey(seed))
    dec = jcd.init_decoder_state(je.config.codec_decoder,
                                 je.codec_decoder_params, batch=1)
    out = je.generator.run_bulk(state, dec, JSP.make(je.sampler_config),
                                prompt_cap=bucket, max_frames=max_frames)
    n = int(np.asarray(out[3][0]).sum())
    return np.asarray(out[2][0, :n])


@pytest.mark.parametrize("frames,extra", [(5, 0), (40, 3), (75, 1)])
def test_create_voice_file_matches_jax(pair, tmp_path, frames, extra):
    je, te = pair
    wav = _ref_wav(tmp_path / "ref.wav", frames, extra, seed=frames)
    want = je.create_voice_file(wav, "reference text")
    got = te.create_voice_file(wav, "reference text")
    assert got.ref_text == "reference text"
    assert len(got.audio_codes) == frames * 16
    assert got.audio_codes == want.audio_codes
    np.testing.assert_allclose(got.embedding_array, want.embedding_array,
                               atol=EMB_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got.embedding_array), 1.0,
                               atol=1e-5)
    got.save(tmp_path / "voice.json")
    back = JVoice.load(tmp_path / "voice.json")
    assert back.audio_codes == got.audio_codes
    assert back.ref_text == "reference text"
    np.testing.assert_array_equal(back.embedding_array, got.embedding_array)


@pytest.mark.parametrize("prefix", [True, False])
def test_clone_generate_matches_jax(pair, tmp_path, monkeypatch, prefix):
    """Greedy clone synthesis: codes equal to the JAX engine's clone
    request, audio within WAV_ATOL; with the prefix-KV path (prefixes of 8
    rows and more: the tiny prompts are 64 rows at most) and without."""
    je, te = pair
    if prefix:
        for eng in pair:
            monkeypatch.setattr(type(eng), "PREFIX_CACHE_MIN_ROWS", 8)
    else:
        monkeypatch.setenv("QTTS_PREFIX_CACHE", "0")
    for eng in pair:
        eng._prefix_kv.clear()
    _set(pair, 12)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    # each engine its own copy, so that neither reads the other's sidecar
    jwav = _ref_wav(tmp_path / "j" / "ref.wav", 6, 2, seed=11)
    twav = _ref_wav(tmp_path / "t" / "ref.wav", 6, 2, seed=11)
    want_audio = je.generate("cloned words", jwav, "the reference")
    got_audio = te.generate("cloned words", twav, "the reference")
    codes, emb = jcache.load_cache(jwav.with_suffix(".cache"))
    want = _jax_clone_codes(je, "cloned words", codes, emb,
                            "the reference", 3, 12)
    np.testing.assert_array_equal(te.last_codes, want)
    np.testing.assert_allclose(got_audio.samples, want_audio.samples,
                               atol=WAV_ATOL)
    assert len(te._prefix_kv) == int(prefix)
    for eng in pair:
        eng._prefix_kv.clear()


def test_sidecar_written_read_and_recomputed(pair, tmp_path, monkeypatch):
    _, te = pair
    _set(pair, 6)
    wav = _ref_wav(tmp_path / "r.wav", 4, 1, seed=21)
    side = wav.with_suffix(".cache")
    first = te.generate("sidecar", wav, "ref")
    codes1 = te.last_codes
    assert side.exists()
    want = te.create_voice_file(wav, "")
    c, e = tcache.load_cache(side)
    np.testing.assert_array_equal(c, np.asarray(want.audio_codes))
    np.testing.assert_array_equal(e, want.embedding_array)

    def refuse(*a, **k):
        raise AssertionError("the encoder ran: the sidecar was not read")

    with monkeypatch.context() as m:
        m.setattr(tenc, "encode", refuse)
        second = te.generate("sidecar", wav, "ref")
    np.testing.assert_array_equal(te.last_codes, codes1)
    np.testing.assert_array_equal(second.samples, first.samples)

    side.write_bytes(b"not a cache")                # corrupt: recomputed
    third = te.generate("sidecar", wav, "ref")
    np.testing.assert_array_equal(third.samples, first.samples)
    np.testing.assert_array_equal(tcache.load_cache(side)[0], c)

    side.unlink()                                   # cannot be written
    side.mkdir()
    fourth = te.generate("sidecar", wav, "ref")
    np.testing.assert_array_equal(fourth.samples, first.samples)
    assert side.is_dir()


def test_long_clone_reference_raises(pair, tmp_path):
    """A 360-frame reference (~30 s) is past the tiny 64-row bucket: it
    raises PromptTooLongError (tests/test_engine_e2e.py's counterpart),
    from a VoiceFile and from reference audio."""
    _, te = pair
    _set(pair, 2)
    rng = np.random.default_rng(1)
    vf = TVoice.new("reference transcript", rng.integers(0, 8, 360 * 16),
                    rng.standard_normal(2048).astype(np.float32) * 0.02)
    with pytest.raises(PromptTooLongError, match="capacity"):
        te.generate_with_voice("clone me", vf)
    wav = _ref_wav(tmp_path / "long.wav", 360, seed=2)
    with pytest.raises(PromptTooLongError, match="capacity"):
        te.generate("clone me", wav, "reference transcript")
    assert TC().runtime.max_prompt_len == 4096


def test_onnx_only_encoder_raises(tmp_path):
    """An unreadable onnx/qwen3_tts_codec_encoder.onnx, the model dir's
    only codec encoder, raises at construction, naming the file: the
    engine never runs random weights in its place (the ONNX encoders
    themselves: tests/test_torch_onnx_engine.py)."""
    (tmp_path / "onnx").mkdir()
    onnx = tmp_path / "onnx" / "qwen3_tts_codec_encoder.onnx"
    onnx.write_bytes(b"")
    with pytest.raises(OnnxLoadError) as e:
        TtsEngine(model_dir=tmp_path, config=TC.tiny(), device="cpu")
    assert str(onnx) in str(e.value)


def test_encoder_and_speaker_npz_load(tiny_engine, tmp_path):
    """codec/encoder.npz and codec/speaker.npz in the JAX engine's
    flattened layout: loaded, not in dev_mode_components, and the voice
    equal to the JAX functions' on those weights."""
    je = tiny_engine
    (tmp_path / "codec").mkdir()
    enc = _np(jenc.init_encoder_params(je.config.codec_encoder,
                                       jax.random.PRNGKey(31)))
    spk = _np(jspk.init_speaker_params(je.config.speaker_encoder,
                                       jax.random.PRNGKey(32)))
    np.savez(tmp_path / "codec" / "encoder.npz", **_flatten(enc))
    np.savez(tmp_path / "codec" / "speaker.npz", **_flatten(spk))
    # an ONNX file beside an npz is not read
    (tmp_path / "onnx").mkdir()
    (tmp_path / "onnx" / "qwen3_tts_speaker_encoder.onnx").write_bytes(b"")
    te = TtsEngine(model_dir=tmp_path, config=TC.tiny(), device="cpu")
    assert not {"codec_encoder", "speaker_encoder"} & set(
        te.dev_mode_components)
    assert te.onnx_encoder is None and te.onnx_speaker is None
    wav = _ref_wav(tmp_path / "ref.wav", 9, 3, seed=4)
    got = te.create_voice_file(wav, "r")
    x = AudioSample.load_wav(wav).mono()
    want_codes = np.asarray(jenc.encode(je.config.codec_encoder, enc,
                                        jnp.asarray(x)[None]))[0]
    want_emb = np.asarray(jspk.speaker_embed(je.config.speaker_encoder, spk,
                                             jnp.asarray(x)))[0]
    np.testing.assert_array_equal(np.asarray(got.audio_codes),
                                  want_codes.reshape(-1))
    np.testing.assert_allclose(got.embedding_array, want_emb, atol=EMB_ATOL)


def test_decode_codes_matches_jax(pair):
    je, te = pair
    codes = np.random.default_rng(6).integers(0, 2048, size=(6, 16))
    want = je.decode_codes(codes)
    got = te.decode_codes(codes.reshape(-1).tolist() + [5, 5])  # + partial
    assert got.sample_rate == 24000 and got.channels == 1
    assert len(got.samples) == 6 * te.config.codec_decoder.samples_per_frame
    np.testing.assert_allclose(got.samples, want.samples, atol=WAV_ATOL)


def test_warmup_keeps_greedy_codes(pair, tmp_path):
    _, te = pair
    _set(pair, 8)
    wav = _ref_wav(tmp_path / "w.wav", 5, seed=8)
    te._prefix_kv.clear()
    before = te.generate("warm", wav, "ref")
    codes = te.last_codes
    entries = list(te._prefix_kv)
    te.warmup(buckets=(32, 64), batch_sizes=(1, 2))
    assert list(te._prefix_kv) == entries
    after = te.generate("warm", wav, "ref")
    np.testing.assert_array_equal(te.last_codes, codes)
    np.testing.assert_array_equal(after.samples, before.samples)


def test_cli_ref_audio_save_voice(pair, tmp_path, capsys):
    from qwen3_tts_tpu_torch.cli import main
    je, _ = pair
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TC.tiny().to_dict()))
    wav = _ref_wav(tmp_path / "ref.wav", 6, seed=9)
    voice, out = tmp_path / "voice.json", tmp_path / "out.wav"
    rc = main(["--text", "hi there", "--device", "cpu", "--config", str(cfg),
               "--model-dir", str(je.model_dir), "--ref-audio", str(wav),
               "--ref-text", "reference words", "--save-voice", str(voice),
               "--max-steps", "6", "--seed", "1", "--output", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "Saved voice file to" in text
    vf = JVoice.load(voice)
    assert vf.ref_text == "reference words"
    assert len(vf.audio_codes) == 6 * 16
    assert len(vf.speaker_embedding) == 2048
    with wave.open(str(out)) as w:
        assert w.getframerate() == 24000 and w.getnframes() > 0
