"""Streaming and prompt-prefix KV reuse of the port on the CPU:
qwen3_tts_tpu_torch.TtsEngine against qwen3_tts_tpu.TtsEngine at
EngineConfig.tiny() with the same weights (the `tiny_engine` fixture's,
converted through io/from_jax), one torch thread.

Greedy codes must be exactly equal.  Waveforms agree within WAV_ATOL =
1e-5: f32 throughout, the two frameworks only sum in other orders, and a
stream decodes the codec in other chunk boundaries than the bulk loop (the
ring codec is chunk-invariant to ~1e-6, tests/test_engine_e2e.py).  A
continued prefill against a full prefill is held within
tests/test_prefix_cache.py's PREFIX_RTOL, PREFIX_ATOL (the attention sums
over another window); across the two packages within XLA_RTOL, XLA_ATOL
(f32, other summation orders: measured ~1e-6).
"""

import dataclasses
import json
import wave

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.core.config import SamplerConfig as JS
from qwen3_tts_tpu.engine import split_sentences as j_split
from qwen3_tts_tpu.io.voice_file import VoiceFile as JVoice
from qwen3_tts_tpu.models.codec import decoder as jcd
from qwen3_tts_tpu.runtime.generate import SamplerParams as JSP
from qwen3_tts_tpu_torch.core.config import EngineConfig as TC
from qwen3_tts_tpu_torch.core.config import SamplerConfig as TS
from qwen3_tts_tpu_torch.engine import TtsEngine
from qwen3_tts_tpu_torch.engine import split_sentences as t_split
from qwen3_tts_tpu_torch.io.from_jax import engine_weights
from qwen3_tts_tpu_torch.io.voice_file import VoiceFile as TVoice
from qwen3_tts_tpu_torch.models.codec import decoder as tcd
from qwen3_tts_tpu_torch.runtime import generate as tgen
from qwen3_tts_tpu_torch.runtime.generate import SamplerParams as TSP

torch.set_num_threads(1)

WAV_ATOL = 1e-5
PREFIX_RTOL, PREFIX_ATOL = 2e-4, 2e-3
XLA_RTOL, XLA_ATOL = 1e-4, 1e-5
GREEDY = dict(temperature=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


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
        _np(je.codec_decoder_params))
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


def _set(pair, max_steps, seed=3, **sampler):
    for eng, sc in zip(pair, (JS, TS)):
        eng.set_max_steps(max_steps)
        eng.set_sampler_config(sc(seed=seed, **(sampler or GREEDY)))


def _first_chunk_frames(pair, n):
    for eng in pair:
        eng.config = eng.config.replace(runtime=dataclasses.replace(
            eng.config.runtime, first_chunk_frames=n))


def _cat(chunks):
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


@pytest.mark.parametrize("text,instruct,max_steps,first_n", [
    ("stream me", None, 10, 1),
    ("a longer streamed sentence", "Calm", 9, 2),
    ("six", None, 6, 0),                    # first chunk a whole chunk
])
def test_stream_matches_jax(pair, text, instruct, max_steps, first_n):
    je, te = pair
    _set(pair, max_steps)
    spf = te.config.codec_decoder.samples_per_frame
    old = (je.config, te.config)
    _first_chunk_frames(pair, first_n)
    try:
        want = list(je.generate_stream(text, je.get_speaker("vivian"),
                                       instruct))
        got = list(te.generate_stream(text, te.get_speaker("vivian"),
                                      instruct))
    finally:
        je.config, te.config = old
    assert [len(c) for c in got] == [len(c) for c in want]
    assert len(got[0]) == (first_n or 4) * spf
    np.testing.assert_allclose(_cat(got), _cat(want), atol=WAV_ATOL)
    m = te.last_metrics
    assert m.frames == je.last_metrics.frames == len(te.last_codes)
    assert m.eos == je.last_metrics.eos
    assert m.ttft_ms is not None and len(m.chunk_ms) == len(got)


def test_first_chunk_and_chunk_with_audio_match_jax(pair):
    """Generator.start_first_chunk, then chunk_with_audio (one lane), and
    start_plans_first_chunk (two lanes), greedy: codes and valid equal,
    wav within WAV_ATOL."""
    je, te = pair
    _set(pair, 16)
    cfg = te.config
    texts = ("first chunk", "and a second lane")
    jvoice, tvoice = je.get_speaker("vivian"), te.get_speaker("vivian")
    jplans = [je._build_voice_prompt(t, jvoice, None) for t in texts]
    tplans = [te._build_voice_prompt(t, tvoice, None) for t in texts]
    jsam, tsam = JSP.make(je.sampler_config), TSP.make(te.sampler_config)
    bucket = je._bucket(jplans[0].length)
    embeds, lengths = je.prompt_to_device(jplans[0], bucket)
    jdec = jcd.init_decoder_state(je.config.codec_decoder,
                                  je.codec_decoder_params, batch=1)
    w1 = je.generator.start_first_chunk(embeds, lengths,
                                        jax.random.PRNGKey(3), jdec, jsam,
                                        prompt_cap=bucket, n_frames=1)
    w2 = je.generator.chunk_with_audio(w1[0], w1[1], jsam, prompt_cap=bucket,
                                       n_frames=4)
    with torch.no_grad():
        embeds_t, lengths_t = te.prompt_to_device(tplans[0], bucket)
        g1 = te.generator.start_first_chunk(
            embeds_t, torch.from_numpy(lengths_t),
            torch.Generator().manual_seed(3),
            tcd.init_decoder_state(cfg.codec_decoder, 1, "cpu"), tsam,
            prompt_cap=bucket, n_frames=1)
        g2 = te.generator.chunk_with_audio(g1[0], g1[1], tsam,
                                           prompt_cap=bucket, n_frames=4)
    for want, got in ((w1, g1), (w2, g2)):
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                                   atol=WAV_ATOL)
    assert got[2].shape == (1, 4, 16) and int(g2[0].step) == 5

    ja, jl, jb = je._plans_to_arrays(jplans)
    jdec = jcd.init_decoder_state(je.config.codec_decoder,
                                  je.codec_decoder_params, batch=2)
    want = je.generator.start_plans_first_chunk(
        je.assets.text_table, je.assets.codec_tables, ja["text_idx"],
        ja["codec_idx"], ja["frame_slot"], ja["spk_flag"], ja["frames"],
        ja["spk_emb"], jl, jax.random.PRNGKey(3), jdec, jsam,
        prompt_cap=jb, n_frames=2)
    ta, tl, tb = te._plans_to_arrays(tplans)
    t = {k: torch.from_numpy(v) for k, v in ta.items()}
    with torch.no_grad():
        got = te.generator.start_plans_first_chunk(
            te.assets.text_table, te.assets.codec_tables, t["text_idx"],
            t["codec_idx"], t["frame_slot"], t["spk_flag"], t["frames"],
            t["spk_emb"], torch.from_numpy(tl),
            torch.Generator().manual_seed(3),
            tcd.init_decoder_state(cfg.codec_decoder, 2, "cpu"), tsam,
            prompt_cap=tb, n_frames=2)
    assert tb == jb
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               atol=WAV_ATOL)


@pytest.mark.parametrize("sampler", [GREEDY, dict(temperature=0.9,
                                                  top_k=40, top_p=0.9)],
                         ids=["greedy", "sampled"])
def test_stream_matches_bulk(pair, sampler):
    """The port's stream (1 + 4 + 4 ... frames) and its bulk loop (4 + 4
    ...) give the same codes on the exact path, greedy and seeded-sampled
    (one draw a frame from the request's generator either way), and the
    same audio within WAV_ATOL."""
    _, te = pair
    te.set_max_steps(11)
    voice = te.get_speaker("vivian")
    te.set_sampler_config(TS(seed=21, **sampler))
    bulk = te.generate_with_voice("stream or bulk", voice)
    bulk_codes = te.last_codes
    te.set_sampler_config(TS(seed=21, **sampler))
    chunks = list(te.generate_stream("stream or bulk", voice))
    np.testing.assert_array_equal(te.last_codes, bulk_codes)
    np.testing.assert_allclose(_cat(chunks), bulk.samples, atol=WAV_ATOL)
    spf = te.config.codec_decoder.samples_per_frame
    assert len(chunks[0]) == te.config.runtime.first_chunk_frames * spf
    assert all(len(c) <= te.config.runtime.frames_per_chunk * spf
               for c in chunks)


def test_stream_batch_matches_jax(pair):
    je, te = pair
    _set(pair, 8, seed=11)
    texts = ["one two", "three"]
    want = list(je.stream_batch(texts, je.get_speaker("vivian")))
    got = list(te.stream_batch(texts, te.get_speaker("vivian")))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert len(g) == len(w) == 2
        for a, b in zip(w, g):
            assert len(a) == len(b)
            np.testing.assert_allclose(b, a, atol=WAV_ATOL)
    te.set_sampler_config(TS(seed=11, **GREEDY))
    again = list(te.stream_batch(texts, te.get_speaker("vivian")))
    for w, g in zip(got, again):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)


def test_stream_batch_zero_pieces_after_a_lane_finishes(pair, monkeypatch):
    """Lane 1 samples EOS at its third frame (the sampler forced): from
    the chunk after, its pieces are empty, and lane 0 is what it is in a
    wave where nothing is forced."""
    from qwen3_tts_tpu_torch.core import protocol as P
    _, te = pair
    te.set_max_steps(12)
    voice = te.get_speaker("vivian")
    spf = te.config.codec_decoder.samples_per_frame
    te.set_sampler_config(TS(seed=4, **GREEDY))
    free = list(te.stream_batch(["lane zero", "lane one"], voice))
    real = tgen.sample_logits
    calls = []

    def forced(logits, *args):
        codes = real(logits, *args)
        calls.append(1)
        if len(calls) == 3:
            codes = codes.clone()
            codes[1] = P.EOS
        return codes

    monkeypatch.setattr(tgen, "sample_logits", forced)
    te.set_sampler_config(TS(seed=4, **GREEDY))
    waves = list(te.stream_batch(["lane zero", "lane one"], voice))
    assert [len(w[1]) for w in waves] == [spf, spf] + [0] * (len(waves) - 2)
    assert len(waves) == len(free) == 4          # 1 + 4 + 4 + 3 frames
    for w, f in zip(waves, free):
        np.testing.assert_array_equal(w[0], f[0])
    np.testing.assert_array_equal(waves[0][1], free[0][1])
    np.testing.assert_array_equal(waves[1][1], free[1][1][:spf])


def test_stream_batch_refuses_the_onnx_codec(pair, tmp_path, monkeypatch):
    """stream_batch on the ONNX codec (onnx/qwen3_tts_decoder.onnx, the
    MINI fixture graph) with the port's LM weights: each lane's codes
    equal the native-codec stream_batch's, and its audio is a decode of
    those codes alone within WAV_ATOL."""
    import torch_onnx_fixtures as tfx
    _, te = pair
    (tmp_path / "onnx").mkdir()
    tfx.build_decoder(tfx.MINI, path=tmp_path / "onnx" /
                      "qwen3_tts_decoder.onnx")
    oe = TtsEngine(model_dir=tmp_path, config=TC.tiny(), device="cpu",
                   weights=dict(assets=te.assets, talker=te.talker_params,
                                predictor=te.predictor_params),
                   speakers_dir=te.model_dir / "preset_speakers")
    assert oe.onnx_decoder is not None
    texts = ["lane zero", "the second lane"]
    lanes = {}
    for eng, name in ((te, "chunk_with_audio"), (oe, "chunk")):
        log = []
        real = getattr(eng.generator, name)

        def spy(*a, real=real, log=log, **k):
            out = real(*a, **k)
            log.append(out[1:] if name == "chunk" else out[2:4])
            return out

        monkeypatch.setattr(eng.generator, name, spy)
        eng.set_max_steps(9)
        eng.set_sampler_config(TS(seed=3, **GREEDY))
        waves = list(eng.stream_batch(texts, eng.get_speaker("vivian")))
        lanes[name] = [(np.concatenate([c[i][v[i]].numpy() for c, v in log]),
                        _cat([w[i] for w in waves])) for i in range(2)]
    for (codes, _), (o_codes, audio) in zip(lanes["chunk_with_audio"],
                                            lanes["chunk"]):
        np.testing.assert_array_equal(o_codes, codes)
        want, _ = oe.onnx_decoder.decode(codes, oe.onnx_decoder.create_state(),
                                         is_final=True)
        np.testing.assert_allclose(audio, want, atol=WAV_ATOL)


@pytest.mark.parametrize("text,max_chars", [
    ("First sentence. Second one! Third? " + "x" * 150, 120),
    ("a;b;cdef;ghij. klmno!!! p", 120),
    ("中文句子。第二句！第三句？最后……", 120),
    ("no punctuation at all but longer than the limit", 10),
    ("   ", 120),
    ("Line one\nLine two\n\nLine three.", 8),
])
def test_split_sentences_matches_jax(text, max_chars):
    assert t_split(text, max_chars) == j_split(text, max_chars)


def test_generate_long_and_stream_long_match_jax(pair):
    je, te = pair
    _set(pair, 4, seed=2)
    text = "One. Two. Three."
    want = je.generate_long(text, je.get_speaker("vivian"))
    got = te.generate_long(text, te.get_speaker("vivian"))
    assert len(got.samples) == len(want.samples) > 0
    np.testing.assert_allclose(got.samples, want.samples, atol=WAV_ATOL)
    _set(pair, 5, seed=2)
    want = list(je.stream_long(text, je.get_speaker("vivian")))
    got = list(te.stream_long(text, te.get_speaker("vivian")))
    assert [len(c) for c in got] == [len(c) for c in want]
    np.testing.assert_allclose(_cat(got), _cat(want), atol=WAV_ATOL)


# ------------------------------------------------ prompt-prefix KV reuse
def _clone(cls, n_frames=20, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 8, size=n_frames * 16)
    return cls.new("ref transcript", codes,
                   rng.standard_normal(2048).astype(np.float32) * 0.02)


@pytest.fixture
def small_prefix(pair, monkeypatch):
    """Both engines take prefixes of 8 rows and more (the tiny config's
    prompts are 64 rows at most); each starts with an empty cache."""
    for eng in pair:
        monkeypatch.setattr(type(eng), "PREFIX_CACHE_MIN_ROWS", 8)
        eng._prefix_kv.clear()
    yield pair
    for eng in pair:
        eng._prefix_kv.clear()
        eng._prefix_kv_max = 4


def test_prefix_continue_matches_full_prefill_and_jax(pair):
    """start_with_prefix(prefix KV, suffix) against a full prefill of the
    same prompt (logits, hidden, pos, the suffix's KV rows), and against
    the JAX package's start_with_prefix on the same inputs."""
    je, te = pair
    tplan = te._build_voice_prompt("task text here", _clone(TVoice), None)
    jplan = je._build_voice_prompt("task text here", _clone(JVoice), None)
    assert tplan.prefix_len == jplan.prefix_len > 0
    bucket = te._bucket(tplan.length)
    p_cap = min(((tplan.prefix_len + 63) // 64) * 64, bucket)
    suffix = tplan.suffix_plan()
    s_cap = ((suffix.length + 15) // 16) * 16
    total = te._bucket(max(tplan.length, p_cap, tplan.prefix_len + s_cap))
    with torch.no_grad():
        embeds, lengths = te.prompt_to_device(tplan, bucket)
        full = te.generator.start(embeds, torch.from_numpy(lengths),
                                  torch.Generator().manual_seed(3))
        embeds_s, lens_s = te.prompt_to_device(suffix, s_cap)
        cont = te.generator.start_with_prefix(
            full.cache.k[:, :, :, :p_cap], full.cache.v[:, :, :, :p_cap],
            tplan.prefix_len, embeds_s, torch.from_numpy(lens_s),
            torch.Generator().manual_seed(3), total_bucket=total)
    for name in ("logits", "hidden"):
        np.testing.assert_allclose(getattr(cont, name).numpy(),
                                   getattr(full, name).numpy(),
                                   rtol=PREFIX_RTOL, atol=PREFIX_ATOL)
    np.testing.assert_array_equal(cont.pos.numpy(), full.pos.numpy())
    lo, hi = tplan.prefix_len, tplan.length
    np.testing.assert_allclose(cont.cache.k[:, :, :, lo:hi].numpy(),
                               full.cache.k[:, :, :, lo:hi].numpy(),
                               rtol=PREFIX_RTOL, atol=PREFIX_ATOL)
    assert cont.cache.write_idx.tolist() == [total]
    assert cont.cache.lengths.tolist() == [tplan.length]

    jembeds, jlengths = je.prompt_to_device(jplan, bucket)
    jfull = je.generator.start(jembeds, jlengths, jax.random.PRNGKey(3))
    jembeds_s, jlens_s = je.prompt_to_device(jplan.suffix_plan(), s_cap)
    jcont = je.generator.start_with_prefix(
        jfull.cache.k[:, :, :, :p_cap], jfull.cache.v[:, :, :, :p_cap],
        jplan.prefix_len, jembeds_s, jnp.asarray(jlens_s),
        jax.random.PRNGKey(3), total_bucket=total)
    for name in ("logits", "hidden"):
        np.testing.assert_allclose(getattr(cont, name).numpy(),
                                   np.asarray(getattr(jcont, name)),
                                   rtol=XLA_RTOL, atol=XLA_ATOL)
    np.testing.assert_array_equal(cont.pos.numpy(), np.asarray(jcont.pos))


def _codes_and_audio(eng, text, voice, seed):
    eng.set_sampler_config((TS if isinstance(eng, TtsEngine) else JS)(
        seed=seed, **GREEDY))
    audio = eng.generate_with_voice(text, voice)
    return (eng.last_codes if isinstance(eng, TtsEngine) else None,
            audio.samples)


def _jax_greedy_codes(je, text, voice, seed, max_frames):
    """The JAX engine's _run_inference up to its codes (its _start_state,
    prefix cache included)."""
    plan = je._build_voice_prompt(text, voice, None)
    state, bucket = je._start_state(plan, jax.random.PRNGKey(seed))
    dec = jcd.init_decoder_state(je.config.codec_decoder,
                                 je.codec_decoder_params, batch=1)
    out = je.generator.run_bulk(state, dec, JSP.make(je.sampler_config),
                                prompt_cap=bucket, max_frames=max_frames)
    return np.asarray(out[2][0, :int(np.asarray(out[3][0]).sum())])


def test_prefix_cache_miss_and_hit_match_jax(small_prefix):
    """A clone voice's first request fills one entry (a miss), the same
    request again and another text of the voice hit it: each request's
    greedy codes equal the JAX engine's through its own prefix cache, and
    the hit's audio is the miss's bit for bit."""
    je, te = small_prefix
    _set(small_prefix, 6, seed=77)
    tvoice, jvoice = _clone(TVoice, 12, 1), _clone(JVoice, 12, 1)
    miss = _codes_and_audio(te, "cachetest", tvoice, 77)
    assert len(te._prefix_kv) == 1
    hit = _codes_and_audio(te, "cachetest", tvoice, 77)
    assert len(te._prefix_kv) == 1
    np.testing.assert_array_equal(hit[0], miss[0])
    np.testing.assert_array_equal(hit[1], miss[1])
    _, want = _codes_and_audio(je, "cachetest", jvoice, 77)
    np.testing.assert_allclose(miss[1], want, atol=WAV_ATOL)
    np.testing.assert_array_equal(
        miss[0], _jax_greedy_codes(je, "cachetest", jvoice, 77, 6))
    other = _codes_and_audio(te, "more", tvoice, 78)
    assert len(te._prefix_kv) == 1
    np.testing.assert_array_equal(
        other[0], _jax_greedy_codes(je, "more", jvoice, 78, 6))


def test_prefix_cache_lru_and_isolation(small_prefix, monkeypatch):
    """Different voices get different entries, never another voice's: the
    LRU keeps the last two of three, a voice's request through the cache
    equals its request with the cache off, and an evicted voice comes
    back the same."""
    _, te = small_prefix
    te.set_max_steps(4)
    te._prefix_kv_max = 2
    voices = [_clone(TVoice, 12, s) for s in range(3)]
    outs = [_codes_and_audio(te, "hello", v, 5) for v in voices]
    plans = [te._build_voice_prompt("hello", v, None) for v in voices]
    keys = [p.prefix_fingerprint() for p in plans]
    assert len(set(keys)) == 3
    assert [k for k, _ in te._prefix_kv] == keys[1:]     # the first evicted
    again = _codes_and_audio(te, "hello", voices[0], 5)
    assert [k for k, _ in te._prefix_kv] == [keys[2], keys[0]]
    np.testing.assert_array_equal(again[0], outs[0][0])
    np.testing.assert_array_equal(again[1], outs[0][1])
    monkeypatch.setenv("QTTS_PREFIX_CACHE", "0")
    off = _codes_and_audio(te, "hello", voices[1], 5)
    np.testing.assert_array_equal(off[0], outs[1][0])
    np.testing.assert_allclose(off[1], outs[1][1], atol=WAV_ATOL)


def test_prefix_cache_off_by_env(small_prefix, monkeypatch):
    monkeypatch.setenv("QTTS_PREFIX_CACHE", "0")
    _, te = small_prefix
    te.set_max_steps(4)
    codes, audio = _codes_and_audio(te, "no cache", _clone(TVoice, seed=3), 9)
    assert np.isfinite(audio).all() and len(codes) > 0
    assert len(te._prefix_kv) == 0


def test_stale_suffix_rows_invisible(small_prefix, monkeypatch):
    """The kept block [prefix_len, p_cap) holds the FIRST request's suffix
    KV; a later request with a shorter suffix must not see it: its codes
    through the cache equal its codes with the cache off."""
    _, te = small_prefix
    te.set_max_steps(5)
    voice = _clone(TVoice, 10, 9)
    _codes_and_audio(te, "abcdefgh", voice, 33)    # one id a character
    plan = te._build_voice_prompt("hi", voice, None)
    p_cap = ((plan.prefix_len + 63) // 64) * 64
    assert plan.length < p_cap                     # stale rows in the block
    cached = _codes_and_audio(te, "hi", voice, 44)
    monkeypatch.setenv("QTTS_PREFIX_CACHE", "0")
    plain = _codes_and_audio(te, "hi", voice, 44)
    np.testing.assert_array_equal(cached[0], plain[0])
    np.testing.assert_allclose(cached[1], plain[1], atol=WAV_ATOL)


def test_prefix_near_cap_falls_back(small_prefix, monkeypatch):
    """prefix_len + the suffix's 16-row cap past max_prompt_len: the full
    prefill, no entry, the same request as with the cache off."""
    _, te = small_prefix
    te.set_max_steps(3)
    voice = _clone(TVoice, 26, 4)
    plan = te._build_voice_prompt("ok", voice, None)
    s_cap = ((plan.length - plan.prefix_len + 15) // 16) * 16
    assert plan.prefix_len + s_cap > te.config.runtime.max_prompt_len
    got = _codes_and_audio(te, "ok", voice, 2)
    assert np.isfinite(got[1]).all()
    assert len(te._prefix_kv) == 0
    monkeypatch.setenv("QTTS_PREFIX_CACHE", "0")
    np.testing.assert_array_equal(_codes_and_audio(te, "ok", voice, 2)[1],
                                  got[1])


def test_prefix_entry_is_a_copy_of_its_slots(small_prefix):
    """An entry holds p_cap slots in storage of its own, not a view of the
    request's whole cache."""
    _, te = small_prefix
    te.set_max_steps(2)
    voice = _clone(TVoice, 12, 6)
    _codes_and_audio(te, "copy", voice, 1)
    plan = te._build_voice_prompt("copy", voice, None)
    p_cap = ((plan.prefix_len + 63) // 64) * 64
    (key, cap), (k, v) = next(iter(te._prefix_kv.items()))
    assert (key, cap) == (plan.prefix_fingerprint(), p_cap)
    tc = te.config.talker
    for t in (k, v):
        assert t.shape == (tc.n_layers, 1, tc.n_kv_heads, p_cap, tc.head_dim)
        assert t.is_contiguous() and t.storage_offset() == 0
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    before = k.clone()
    _codes_and_audio(te, "copy again", voice, 1)       # a hit
    assert torch.equal(te._prefix_kv[(key, cap)][0], before)


# ------------------------------------------------------------------ CLI
@pytest.mark.parametrize("flags,expect", [
    (["--stream"], "TTFT:"),
    (["--long", "--text", "One. Two."], "Generation took"),
    (["--voice-file", "VOICE"], "Voice: Dynamic"),
])
def test_cli_stream_long_and_voice_file(pair, tmp_path, capsys, flags,
                                        expect):
    from qwen3_tts_tpu_torch.cli import main
    je, _ = pair
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TC.tiny().to_dict()))
    voice = tmp_path / "voice.json"
    _clone(TVoice, 4, 2).save(voice)
    out = tmp_path / "out.wav"
    flags = [str(voice) if f == "VOICE" else f for f in flags]
    rc = main(["--text", "hi there", "--device", "cpu", "--config", str(cfg),
               "--model-dir", str(je.model_dir), "--speakers-dir",
               str(je.model_dir / "preset_speakers"), "--max-steps", "6",
               "--seed", "1", "--output", str(out), *flags])
    text = capsys.readouterr().out
    assert rc == 0 and expect in text
    if "--stream" in flags:
        assert "chunk 0: " in text and "chunk 1: " in text
    with wave.open(str(out)) as w:
        assert w.getframerate() == 24000 and w.getnframes() > 0
