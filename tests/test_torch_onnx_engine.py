"""TtsEngine of the port with the ONNX codec, on the CPU: a model directory
laid out as the reference ships it (`onnx/qwen3_tts_decoder.onnx`,
`onnx/qwen3_tts_codec_encoder.onnx`, `onnx/qwen3_tts_speaker_encoder.onnx`,
the fixture graphs of tests/torch_onnx_fixtures.py at toy sizes) and
EngineConfig.tiny() LMs on seeded development weights, one torch thread.

What is held.  The LM's codes on the ONNX-codec engine equal a
native-codec engine's on the same weights exactly (the codec never feeds
the LM; the native engine is held against the JAX package in
tests/test_torch_engine.py).  Every waveform equals a decode of the codes
it came from (the lane's own codes, decoded alone from a fresh state)
within WAV_TOL = 1e-5: f32 throughout, the graph is causal, so chunked and
whole decodes agree to rounding (~1e-7 measured), and a batched decode
(vmap) sums as the single one does.  The decoder graph against the numpy
reference within tests/test_onnx_codec.py's rtol 1e-4, atol 1e-5.  Codes
from the encoder graph exactly; embeddings within EMB_TOL = 1e-5 of the
JAX package's (its log-mel differs by up to 1e-4, tests/test_torch_clone.py).
"""

import numpy as np
import pytest
import torch

import torch_onnx_fixtures as tfx
from qwen3_tts_tpu.models.codec.onnx_decoder import OnnxAudioEncoder as JAE
from qwen3_tts_tpu.models.codec.onnx_decoder import OnnxSpeakerEncoder as JSE
from qwen3_tts_tpu.io.onnx_exec import OnnxExecutor as JEx
from qwen3_tts_tpu.ops import mel as jmel
from qwen3_tts_tpu_torch.core.config import EngineConfig as TC
from qwen3_tts_tpu_torch.core.config import SamplerConfig as TS
from qwen3_tts_tpu_torch.engine import TtsEngine
from qwen3_tts_tpu_torch.io.audio import AudioSample
from qwen3_tts_tpu_torch.io.convert import flatten_pytree
from qwen3_tts_tpu_torch.io.voice_file import VoiceFile
from qwen3_tts_tpu_torch.models.codec import decoder as tdec
from qwen3_tts_tpu_torch.models.codec.onnx_decoder import OnnxLoadError
from qwen3_tts_tpu_torch.runtime.generate import SamplerParams
from qwen3_tts_tpu_torch.serve import codec_path
from qwen3_tts_tpu_torch.serve.batch import BatchRequest, BatchSynthesizer
from qwen3_tts_tpu_torch.serve.continuous import ContinuousBatcher

torch.set_num_threads(1)

WAV_TOL = 1e-5
REF_RTOL, REF_ATOL = 1e-4, 1e-5
EMB_TOL = 1e-5
GREEDY = dict(temperature=0.0)
ENC = tfx.EncDims(hop=4, d=8)          # the tiny encoder's hop
ONNX_FILES = {"decoder": "qwen3_tts_decoder.onnx",
              "encoder": "qwen3_tts_codec_encoder.onnx",
              "speaker": "qwen3_tts_speaker_encoder.onnx"}


def _model_dir(root, parts=("decoder",)):
    """A model directory with the given fixture graphs under onnx/ and a
    preset speaker."""
    (root / "onnx").mkdir(parents=True, exist_ok=True)
    build = {"decoder": lambda p: tfx.build_decoder(tfx.MINI, path=p),
             "encoder": lambda p: tfx.build_encoder(ENC, path=p),
             "speaker": lambda p: tfx.build_speaker(path=p)}
    for part in parts:
        build[part](root / "onnx" / ONNX_FILES[part])
    spk = root / "preset_speakers"
    spk.mkdir(exist_ok=True)
    VoiceFile.new("", [], np.random.default_rng(0).standard_normal(2048)
                  .astype(np.float32) * 0.02).save(spk / "vivian.json")
    return root


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(native-codec engine, ONNX-codec engine) on the same LM weights."""
    root = tmp_path_factory.mktemp("onnx_engine")
    native = TtsEngine(model_dir=_model_dir(root / "native", ()),
                       config=TC.tiny(), device="cpu")
    onnx = TtsEngine(
        model_dir=_model_dir(root / "onnx", ("decoder", "encoder", "speaker")),
        config=TC.tiny(), device="cpu",
        weights=dict(assets=native.assets, talker=native.talker_params,
                     predictor=native.predictor_params))
    return native, onnx


def _set(engine, max_steps, seed=3, **sampler):
    engine.set_max_steps(max_steps)
    engine.set_sampler_config(TS(seed=seed, **(sampler or GREEDY)))


def _decode(engine, codes):
    wav, _ = engine.onnx_decoder.decode(
        np.asarray(codes), engine.onnx_decoder.create_state(), is_final=True)
    return wav


def _cat(pieces):
    return (np.concatenate(pieces) if len(pieces) else
            np.zeros(0, np.float32))


# ------------------------------------------------------- loading the graphs
def test_onnx_decoder_dir_decodes_with_the_graph(tmp_path):
    """A model directory with only onnx/qwen3_tts_decoder.onnx: the engine
    runs the graph, not a random native codec (before the ONNX codec was
    ported, the port decoded such a directory with random weights)."""
    eng = TtsEngine(model_dir=_model_dir(tmp_path), config=TC.tiny(),
                    device="cpu")
    assert eng.onnx_decoder is not None
    assert "codec_decoder" not in eng.dev_mode_components
    assert eng.codec_decoder_params is None
    codes = np.random.default_rng(7).integers(0, 20, size=(5, 16))
    np.testing.assert_allclose(eng.decode_codes(codes).samples,
                               tfx.mini_decoder_reference(codes),
                               rtol=REF_RTOL, atol=REF_ATOL)


def test_require_weights_turns_dev_mode_into_an_error(tmp_path, monkeypatch,
                                                      caplog):
    d = _model_dir(tmp_path)
    eng = TtsEngine(model_dir=d, config=TC.tiny(), device="cpu")
    assert "talker" in eng.dev_mode_components
    assert "onnx/*.onnx" in caplog.text
    monkeypatch.setenv("QTTS_REQUIRE_WEIGHTS", "1")
    with pytest.raises(RuntimeError, match=r"DEV MODE.*onnx/\*\.onnx"):
        TtsEngine(model_dir=d, config=TC.tiny(), device="cpu")


@pytest.mark.parametrize("part", sorted(ONNX_FILES))
def test_corrupt_onnx_file_raises_at_construction(tmp_path, part):
    d = _model_dir(tmp_path, ())
    path = d / "onnx" / ONNX_FILES[part]
    path.write_bytes(b"\x0bnot a graph")
    with pytest.raises(OnnxLoadError) as e:
        TtsEngine(model_dir=d, config=TC.tiny(), device="cpu")
    assert str(path) in str(e.value)


def test_npz_beside_an_onnx_file_wins(tmp_path):
    d = _model_dir(tmp_path, ("decoder", "speaker"))
    cfg = TC.tiny()
    params = tdec.init_decoder_params(cfg.codec_decoder,
                                      torch.Generator().manual_seed(5))
    (d / "codec").mkdir()
    np.savez(d / "codec" / "decoder.npz", **flatten_pytree(params))
    eng = TtsEngine(model_dir=d, config=cfg, device="cpu")
    assert eng.onnx_decoder is None and eng.onnx_encoder is None
    assert eng.onnx_speaker is not None
    for k, v in flatten_pytree(params).items():
        np.testing.assert_array_equal(
            flatten_pytree(eng.codec_decoder_params)[k], v)
    assert {"codec_decoder", "speaker_encoder"}.isdisjoint(
        eng.dev_mode_components)
    assert "codec_encoder" in eng.dev_mode_components


# ---------------------------------------------------------------- requests
@pytest.mark.parametrize("text,max_steps,seed,sampler", [
    ("onnx path", 10, 3, GREEDY),
    ("a sampled request", 9, 4, dict(temperature=0.8, top_k=5, top_p=0.9))])
def test_generate_with_voice_codes_equal_native(engines, text, max_steps,
                                                seed, sampler):
    native, onnx = engines
    for eng in engines:
        _set(eng, max_steps, seed, **sampler)
    a = native.generate_with_voice(text, native.get_speaker("vivian"))
    b = onnx.generate_with_voice(text, onnx.get_speaker("vivian"))
    np.testing.assert_array_equal(onnx.last_codes, native.last_codes)
    assert onnx.last_metrics.frames == native.last_metrics.frames
    assert len(a.samples) == native.last_metrics.frames * \
        native.config.codec_decoder.samples_per_frame
    np.testing.assert_allclose(b.samples, _decode(onnx, onnx.last_codes),
                               atol=WAV_TOL)
    assert len(b.samples) == len(onnx.last_codes) * tfx.SPF


@pytest.mark.parametrize("first_n", [1, 0])
def test_generate_stream_against_a_decode_of_its_codes(engines, first_n):
    import dataclasses
    native, onnx = engines
    for eng in engines:
        _set(eng, 10)
    old = onnx.config
    onnx.config = old.replace(runtime=dataclasses.replace(
        old.runtime, first_chunk_frames=first_n))
    try:
        chunks = list(onnx.generate_stream("stream me", onnx.get_speaker(
            "vivian")))
    finally:
        onnx.config = old
    assert len(chunks[0]) == (first_n or 4) * tfx.SPF
    native.generate_with_voice("stream me", native.get_speaker("vivian"))
    np.testing.assert_array_equal(onnx.last_codes, native.last_codes)
    np.testing.assert_allclose(_cat(chunks), _decode(onnx, onnx.last_codes),
                               atol=WAV_TOL)
    m = onnx.last_metrics
    assert m.ttft_ms is not None and m.frames == len(onnx.last_codes)


def _spy(monkeypatch, obj, name, log):
    real = getattr(obj, name)

    def spy(*a, **k):
        out = real(*a, **k)
        log.append(out)
        return out

    monkeypatch.setattr(obj, name, spy)


def test_stream_batch_lanes_against_decodes_of_their_codes(engines,
                                                           monkeypatch):
    _, onnx = engines
    _set(onnx, 10)
    log = []
    _spy(monkeypatch, onnx.generator, "chunk", log)
    texts = ["lane zero", "the second lane", "c"]
    waves = list(onnx.stream_batch(texts, onnx.get_speaker("vivian")))
    for i in range(len(texts)):
        codes = np.concatenate([c[i][v[i]].numpy() for _, c, v in log])
        assert len(codes) > 0
        np.testing.assert_allclose(_cat([w[i] for w in waves]),
                                   _decode(onnx, codes), atol=WAV_TOL)


def test_wave_lanes_against_decodes_of_their_codes(engines, monkeypatch):
    """A BatchSynthesizer wave (and a padded short last wave): each
    request's audio is a decode of its own codes alone, flushed, and
    lanes of equal length share one decode_batch."""
    _, onnx = engines
    _set(onnx, 8)
    log, calls = [], []
    _spy(monkeypatch, onnx.generator, "run_bulk_codes", log)
    _spy(monkeypatch, onnx.onnx_decoder, "decode_batch", calls)
    voice = onnx.get_speaker("vivian")
    reqs = [BatchRequest("lockstep one", voice),
            BatchRequest("lockstep two", voice),
            BatchRequest("short", voice, max_frames=5)]
    results = BatchSynthesizer(onnx, batch_size=2).synthesize(reqs)
    assert len(log) == 2 and calls
    lanes = [(0, 0), (0, 1), (1, 0)]
    for r, (wave, lane) in zip(results, lanes):
        _, codes, valid, _, _ = log[wave]
        own = codes[lane][valid[lane]].numpy()
        assert r.frames == len(own) > 0
        np.testing.assert_allclose(r.audio.samples, _decode(onnx, own),
                                   atol=WAV_TOL)
    assert results[2].frames == 5


def test_continuous_queue_lanes_against_decodes_of_their_codes(engines,
                                                                monkeypatch):
    """A ContinuousBatcher queue (refills included): every lane's audio,
    stream by stream, is a decode of that stream's codes alone; each
    request's audio is one of those streams."""
    _, onnx = engines
    _set(onnx, 8)
    segments = {}                   # lane -> [[codes], [audio]] per stream
    real_audio = codec_path.LaneCodec.chunk_audio
    real_reset = codec_path.LaneCodec.reset_lanes

    def chunk_audio(self, codes_np, ks, finals):
        out = real_audio(self, codes_np, ks, finals)
        for lane in range(self.b):
            if int(ks[lane]) > 0:
                seg = segments.setdefault(lane, [[[], []]])[-1]
                seg[0].append(codes_np[lane][: int(ks[lane])])
                seg[1].append(out[lane])
        return out

    def reset_lanes(self, mask):
        for lane in np.nonzero(mask)[0]:
            segments.setdefault(int(lane), [[[], []]]).append([[], []])
        return real_reset(self, mask)

    monkeypatch.setattr(codec_path.LaneCodec, "chunk_audio", chunk_audio)
    monkeypatch.setattr(codec_path.LaneCodec, "reset_lanes", reset_lanes)
    voice = onnx.get_speaker("vivian")
    reqs = [BatchRequest(t, voice) for t in ("a", "bb", "ccc", "dddd")]
    results = ContinuousBatcher(onnx, batch_size=2,
                                max_frames_per_stream=6).run(reqs)
    streams = []
    for segs in segments.values():
        for codes, audio in segs:
            if codes:
                streams.append(_cat(audio))
                np.testing.assert_allclose(
                    streams[-1], _decode(onnx, np.concatenate(codes)),
                    atol=WAV_TOL)
    assert len(streams) == len(reqs)
    for r in results:
        assert r.frames > 0
        assert any(len(s) == len(r.audio.samples)
                   and np.array_equal(s, r.audio.samples) for s in streams)


def test_lane_codec_lane_audio_and_reset(engines):
    """LaneCodec on the ONNX codec alone: run_group through
    run_bulk_codes, one lane's audio (chunk_audio with the other lane at
    0 frames) against a decode of the lane's codes (its state advanced),
    reset_lanes back to a fresh state."""
    _, onnx = engines
    _set(onnx, 8)
    voice = onnx.get_speaker("vivian")
    plans = [onnx._build_voice_prompt(t, voice, None)
             for t in ("one", "two lanes")]
    state, _, bucket = onnx.start_plans(plans, None,
                                        torch.Generator().manual_seed(0))
    codec = codec_path.LaneCodec(onnx, 2)
    state, codes, valid, _ = codec.run_group(
        state, SamplerParams.make(onnx.sampler_config), prompt_cap=bucket,
        n_frames=4, max_frames=8, budgets=[8, 8])
    k = int(valid[1].sum())
    none, wav = codec.chunk_audio(codes, np.array([0, k]),
                                  np.array([True, True]))
    np.testing.assert_allclose(wav, _decode(onnx, codes[1][:k]),
                               atol=WAV_TOL)
    assert codec.state[1]["past_key_0"].shape[2] == k > 0
    assert none.shape == (0,)
    assert codec.state[0]["past_key_0"].shape[2] == 0
    codec.reset_lanes(np.array([False, True]))
    assert codec.state[1]["past_key_0"].shape[2] == 0


# --------------------------------------------------------------- cloning
def _ref_wav(path, frames, seed=0):
    wav = (np.random.default_rng(seed).standard_normal(frames * ENC.hop + 3)
           * 0.2).astype(np.float32)
    AudioSample(samples=wav, sample_rate=24000).save_wav(path)
    return path


def test_create_voice_file_and_generate_through_the_onnx_encoders(
        engines, tmp_path):
    """Codes from the audio-encoder graph, the embedding from the speaker
    graph on the log-mel, each against the JAX engine's ONNX branch on the
    same graphs; generate writes the .cache sidecar, and its second call
    reads it, with the codes of generate_with_voice on the voice file."""
    from qwen3_tts_tpu.io.onnx_lite import read_onnx_graph as jread
    from qwen3_tts_tpu_torch.io.audio import load_reference_wav
    _, onnx = engines
    assert onnx.onnx_encoder is not None and onnx.onnx_speaker is not None
    wav_path = _ref_wav(tmp_path / "ref.wav", 9, seed=2)
    vf = onnx.create_voice_file(wav_path, "reference text")
    x = load_reference_wav(wav_path)
    jcodes = JAE(JEx(jread(tfx.build_encoder(ENC)[0]))).encode(x)
    jemb = JSE(JEx(jread(tfx.build_speaker()[0]))).encode_mels(
        np.asarray(jmel.log_mel(x)))
    np.testing.assert_array_equal(np.asarray(vf.audio_codes),
                                  jcodes.reshape(-1))
    np.testing.assert_array_equal(
        np.asarray(vf.audio_codes).reshape(-1, 16),
        tfx.encoder_reference(ENC, x))
    np.testing.assert_allclose(vf.embedding_array, jemb, atol=EMB_TOL)
    _set(onnx, 6)
    a = onnx.generate("clone me", wav_path, "reference text")
    codes_a = onnx.last_codes
    assert wav_path.with_suffix(".cache").exists()
    b = onnx.generate("clone me", wav_path, "reference text")
    np.testing.assert_array_equal(onnx.last_codes, codes_a)
    np.testing.assert_array_equal(b.samples, a.samples)
    onnx.generate_with_voice("clone me", vf)
    np.testing.assert_array_equal(onnx.last_codes, codes_a)


def test_decode_codes_and_warmup(engines):
    """decode_codes through the graph; warmup runs the codes-only chunk,
    the decoder and both encoders, and changes no request's result."""
    _, onnx = engines
    codes = np.random.default_rng(9).integers(0, 40, size=(4, 16))
    np.testing.assert_allclose(onnx.decode_codes(codes.reshape(-1)).samples,
                               tfx.mini_decoder_reference(codes),
                               rtol=REF_RTOL, atol=REF_ATOL)
    _set(onnx, 6)
    before = onnx.generate_with_voice("warm", onnx.get_speaker("vivian"))
    onnx.warmup(buckets=(32,), batch_sizes=(1, 2))
    after = onnx.generate_with_voice("warm", onnx.get_speaker("vivian"))
    np.testing.assert_array_equal(after.samples, before.samples)


# -------------------------------------------------------- codes-only forms
@pytest.mark.parametrize("uniform", [True, False])
def test_codes_only_forms_equal_the_audio_forms(engines, uniform):
    """Generator.chunk and run_bulk_codes against chunk_with_audio and
    run_bulk from equal states: codes, valid, saw_eos and frames equal."""
    native, _ = engines
    gen = native.generator
    sampler = SamplerParams.make(TS(temperature=0.0))
    voice = native.get_speaker("vivian")
    plans = [native._build_voice_prompt(t, voice, None)
             for t in ("first lane", "two")]

    def start():
        return native.start_plans(plans, None,
                                  torch.Generator().manual_seed(0))[0]

    cfg = native.config
    s1, s2 = start(), start()
    _, codes_a, valid_a = gen.chunk(s1, sampler, prompt_cap=32, n_frames=3,
                                    uniform_cursor=uniform)
    _, _, codes_b, valid_b, _ = gen.chunk_with_audio(
        s2, tdec.init_decoder_state(cfg.codec_decoder, 2, "cpu"), sampler,
        prompt_cap=32, n_frames=3, uniform_cursor=uniform)
    assert torch.equal(codes_a, codes_b) and torch.equal(valid_a, valid_b)
    budgets = torch.tensor([5, 9], dtype=torch.int32)
    s1, s2 = start(), start()
    _, codes_a, valid_a, done_a, eos_a = gen.run_bulk_codes(
        s1, sampler, prompt_cap=32, max_frames=9, budgets=budgets,
        uniform_cursor=uniform)
    _, _, codes_b, valid_b, _, done_b, eos_b = gen.run_bulk(
        s2, tdec.init_decoder_state(cfg.codec_decoder, 2, "cpu"), sampler,
        prompt_cap=32, max_frames=9, budgets=budgets, uniform_cursor=uniform)
    assert torch.equal(codes_a, codes_b) and torch.equal(valid_a, valid_b)
    assert torch.equal(eos_a, eos_b) and done_a == done_b
    assert int(valid_a[0].sum()) <= 5
