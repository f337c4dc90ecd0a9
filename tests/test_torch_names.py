"""The small public names the port took over from the JAX package, each
against its JAX counterpart on the same seeded inputs: decode_full (f32,
atol 1e-4, tests/test_torch_models.py's codec tolerance),
make_mrope_positions and greedy_slice_argmax (equal), sample_with_allowlist
(greedy equal; sampled: every draw inside [0, limit) plus the allowlist),
and the engine-side ones: get_sampler_config, OnlineBatcher.synthesize and
OnlineRouter.synthesize (a submit of a BatchRequest: the same codes),
prefill_lane / Generator.refill_lane (prefill_lanes / refill_lanes of one
prompt: equal states), LaneCodec.lane_audio (chunk_audio's lane) and
io/checkpoint.enabled (the JAX package's QTTS_WEIGHT_CACHE rule, the
engine's default weight_cache)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.io import checkpoint as jckpt
from qwen3_tts_tpu.models.codec import decoder as jcd
from qwen3_tts_tpu.ops import rope as jrope
from qwen3_tts_tpu.ops import sampling as jsampling
from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
from qwen3_tts_tpu_torch.core.config import CodecDecoderConfig, EngineConfig
from qwen3_tts_tpu_torch.io import checkpoint as ckpt
from qwen3_tts_tpu_torch.io.from_jax import tree_to_torch
from qwen3_tts_tpu_torch.models.codec import decoder as tcd
from qwen3_tts_tpu_torch.ops import rope, sampling

torch.set_num_threads(1)


def test_decode_full_matches_jax():
    cfg = CodecDecoderConfig.tiny()
    jp = jcd.init_decoder_params(cfg, jax.random.PRNGKey(5))
    tp = tree_to_torch(jax.tree_util.tree_map(np.asarray, jp))
    codes = np.random.default_rng(3).integers(0, 2048, (2, 9, 16)).astype(
        np.int32)
    got = tcd.decode_full(cfg, tp, torch.from_numpy(codes))
    want = np.asarray(jcd.decode_full(cfg, jp, jnp.asarray(codes)))
    assert got.shape == want.shape == (2, 9 * cfg.samples_per_frame)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("start,length", [(0, 5), (37, 12), (4090, 3)])
def test_make_mrope_positions(start, length):
    got = rope.make_mrope_positions(start, length)
    want = jrope.make_mrope_positions(start, length)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_greedy_slice_argmax():
    logits = np.random.default_rng(0).standard_normal((3, 4, 100)).astype(
        np.float32)
    logits[0, 0, 20:30] = 5.0                       # ties: lowest index
    for start, size in ((0, 10), (20, 16), (64, 30), (95, 10)):
        got = sampling.greedy_slice_argmax(torch.from_numpy(logits), start,
                                           size)
        want = jsampling.greedy_slice_argmax(jnp.asarray(logits), start,
                                             size)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_with_allowlist():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((64, 300)).astype(np.float32) * 3
    logits[:, 250] = 20.0                          # outside: never drawn
    logits[:5, 280] = 30.0                         # allowed: greedy there
    allow = [280, 290]
    g = torch.Generator().manual_seed(0)
    greedy = sampling.sample_with_allowlist(torch.from_numpy(logits), g, 200,
                                            allow, 0.0, 40, 0.9)
    want = jsampling.sample_with_allowlist(
        jnp.asarray(logits), jax.random.PRNGKey(0), 200, allow, 0.0, 40, 0.9)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(want))
    assert (greedy.numpy()[:5] == 280).all()
    drawn = np.concatenate([sampling.sample_with_allowlist(
        torch.from_numpy(logits), g, 200, allow, 1.5, 0, 1.0).numpy()
        for _ in range(20)])
    ok = (drawn < 200) | np.isin(drawn, allow)
    assert ok.all() and len(set(drawn.tolist())) > 20


@pytest.fixture(scope="module")
def eng(tmp_path_factory):
    e = TtsEngine(tmp_path_factory.mktemp("none"), config=EngineConfig.tiny(),
                  device="cpu", speakers_dir="speakers")
    e.set_max_steps(8)
    return e


def test_get_sampler_config(eng):
    cfg = SamplerConfig(temperature=0.3, top_k=7, top_p=0.5, seed=9)
    eng.set_sampler_config(cfg)
    assert eng.get_sampler_config() is cfg


def test_synthesize_is_a_submit(eng):
    from qwen3_tts_tpu_torch.serve.batch import BatchRequest
    from qwen3_tts_tpu_torch.serve.online import OnlineBatcher, OnlineRouter
    voice = eng.get_speaker("vivian")
    eng.set_sampler_config(SamplerConfig(temperature=0.0, seed=2))
    for make in (lambda: OnlineBatcher(eng, batch_size=2, bucket=32,
                                       idle_poll_s=0.01),
                 lambda: OnlineRouter(eng, batch_size=2, buckets=(32, 64),
                                      idle_poll_s=0.01)):
        server = make()
        try:
            a = server.synthesize("one request", voice,
                                  max_frames=4).result(timeout=120)
            b = server.submit(BatchRequest("one request", voice,
                                           max_frames=4)).result(timeout=120)
        finally:
            server.stop()
        assert 0 < a.frames <= 4 and a.frames == b.frames
        np.testing.assert_array_equal(a.audio.samples, b.audio.samples)


def test_refill_lane_is_refill_lanes_of_one(eng):
    from qwen3_tts_tpu_torch.runtime.generate import prefill_lane
    gen = eng.generator
    voice = eng.get_speaker("vivian")
    plans = [eng._build_voice_prompt(t, voice, None)
             for t in ("lane zero", "lane one", "a refill")]
    embeds, lengths = eng.prompt_to_device(plans[:2], 32)
    new, new_len = eng.prompt_to_device(plans[2:], 32)

    def start():
        return gen.start(embeds, torch.from_numpy(lengths),
                         torch.Generator().manual_seed(0))
    one = gen.refill_lane(start(), new[0], int(new_len[0]), 1)
    many = gen.refill_lanes(start(), new, [int(new_len[0])], [1])
    fn = prefill_lane(eng.config, gen.talker_params, new[0],
                      int(new_len[0]), 1, start(),
                      a8=gen.a8_prefill)
    for st in (one, fn):
        for a, b in ((st.logits, many.logits), (st.hidden, many.hidden),
                     (st.cache.k, many.cache.k), (st.cache.v, many.cache.v),
                     (st.pos, many.pos), (st.cache.lengths,
                                          many.cache.lengths),
                     (st.cache.write_idx, many.cache.write_idx)):
            assert torch.equal(a, b)
    assert int(one.pos[1]) == int(new_len[0]) and int(one.pos[0]) == \
        int(lengths[0])


def test_lane_audio_is_chunk_audio_of_one_lane(eng):
    from qwen3_tts_tpu_torch.runtime.generate import SamplerParams
    from qwen3_tts_tpu_torch.serve.codec_path import LaneCodec
    voice = eng.get_speaker("vivian")
    plans = [eng._build_voice_prompt(t, voice, None) for t in ("a", "bb")]
    state, _, bucket = eng.start_plans(plans, None,
                                       torch.Generator().manual_seed(0))
    codec = LaneCodec(eng, 2)
    state, codes, valid, _ = codec.run_group(
        state, SamplerParams.make(eng.sampler_config), prompt_cap=bucket,
        n_frames=4, max_frames=4, budgets=[4, 4])
    ks = valid.sum(1)
    both = codec.chunk_audio(codes, ks, np.array([True, True]))
    for lane in (0, 1):
        got = codec.lane_audio(lane, codes[lane], int(ks[lane]), True)
        np.testing.assert_array_equal(got, both[lane])
    assert codec.lane_audio(0, codes[0], 0, True).shape == (0,)


@pytest.mark.parametrize("value", [None, "1", "0", "false", "yes"])
def test_checkpoint_enabled(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("QTTS_WEIGHT_CACHE", raising=False)
    else:
        monkeypatch.setenv("QTTS_WEIGHT_CACHE", value)
    assert ckpt.enabled() == jckpt.enabled() == (value not in ("0",
                                                               "false"))
