"""Continuous-batching serving in the port (qwen3_tts_tpu_torch) on the CPU,
against the JAX package (qwen3_tts_tpu) on the same inputs and weights.

- The plain versions of the three per-lane cache kernels against the
  Pallas kernels in interpret mode: `append_kv_lanes` and
  `inject_prompt_lanes` bit for bit (window edges 0/7/8/63, a duplicated
  lane with identical rows); `flash_gqa_decode_append`'s attention within
  ATTN_ATOL (f32 sums in another order) and its cache bit for bit,
  including a lane at slot 0 and a poisoned stale row at the slot being
  written.
- The codec's `reset_lanes` and the per-lane `update_cache` exactly.
- `Generator.refill_lanes` against the JAX one at `EngineConfig.tiny()`:
  the refilled lanes' logits and hidden state within tests/
  test_continuous.py's tolerance (rtol 2e-4, atol 2e-3), positions, prompt
  lengths, cursors and done flags exactly.
- `ContinuousBatcher` at `EngineConfig.tiny()` (exact path, greedy) against
  the JAX `ContinuousBatcher`: frames and EOS per request equal, audio
  within WAV_ATOL (f32 throughout; tests/test_torch_engine.py's bound).
- The batcher on the per-kernel schedule (`fused=True`, batch 8): it
  completes the queue on the kernels' plain versions, and no kernel's
  launch counter moves on the CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.core.config import SamplerConfig as JS
from qwen3_tts_tpu.kernels import flash_decode as jfd
from qwen3_tts_tpu.models.codec import decoder as jcd
from qwen3_tts_tpu.ops import attention as jatt
from qwen3_tts_tpu.runtime.generate import SamplerParams as JSP
from qwen3_tts_tpu.serve.batch import BatchRequest as JBR
from qwen3_tts_tpu.serve.continuous import ContinuousBatcher as JCB
from qwen3_tts_tpu_torch.core.config import EngineConfig as TC
from qwen3_tts_tpu_torch.core.config import SamplerConfig as TS
from qwen3_tts_tpu_torch.engine import TtsEngine
from qwen3_tts_tpu_torch.io.from_jax import engine_weights
from qwen3_tts_tpu_torch.kernels import flash_decode as tfd
from qwen3_tts_tpu_torch.models.codec import decoder as tcd
from qwen3_tts_tpu_torch.ops.attention import update_cache
from qwen3_tts_tpu_torch.runtime import generate as tg
from qwen3_tts_tpu_torch.serve.batch import BatchRequest as TBR
from qwen3_tts_tpu_torch.serve.continuous import ContinuousBatcher as TCB

ATTN_ATOL = 1e-5
WAV_ATOL = 1e-5
REFILL_RTOL, REFILL_ATOL = 2e-4, 2e-3


def _bf16(rng, shape, scale=0.3):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------- the cache kernels
def test_append_kv_lanes_matches_pallas():
    L, B, HKV, C, DH = 2, 4, 2, 64, 128
    rng = np.random.default_rng(7)
    k, v = _bf16(rng, (L, B, HKV, C, DH)), _bf16(rng, (L, B, HKV, C, DH))
    kt, vt = _bf16(rng, (L, B, HKV, DH)), _bf16(rng, (L, B, HKV, DH))
    starts = np.asarray([0, 7, 8, 63], np.int32)       # window edges
    jk, jv = jfd.append_kv_lanes(
        *(jnp.asarray(a, jnp.bfloat16) for a in (k, v, kt, vt)),
        jnp.asarray(starts), interpret=True)
    tk, tv = _t(k), _t(v)
    out = tfd.append_kv_lanes(tk, tv, _t(kt), _t(vt), torch.from_numpy(starts))
    assert out[0] is tk and out[1] is tv                 # in place
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))


def test_inject_prompt_lanes_matches_pallas():
    L, B, HKV, C, S, DH = 2, 4, 2, 64, 16, 128
    rng = np.random.default_rng(8)
    k, v = _bf16(rng, (L, B, HKV, C, DH)), _bf16(rng, (L, B, HKV, C, DH))
    ks, vs = _bf16(rng, (L, 3, HKV, S, DH)), _bf16(rng, (L, 3, HKV, S, DH))
    ks[:, 2], vs[:, 2] = ks[:, 0], vs[:, 0]     # lane 2 twice, same rows
    lanes = np.asarray([2, 0, 2], np.int32)
    jk, jv = jfd.inject_prompt_lanes(
        *(jnp.asarray(a, jnp.bfloat16) for a in (k, v, ks, vs)),
        jnp.asarray(lanes), interpret=True)
    tk, tv = _t(k), _t(v)
    tfd.inject_prompt_lanes(tk, tv, _t(ks), _t(vs), torch.from_numpy(lanes))
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))
    np.testing.assert_array_equal(tk[:, 1].float().numpy(), k[:, 1])


@pytest.mark.parametrize("poison", [False, True])
def test_decode_append_matches_pallas(poison):
    L, B, H, HKV, DH, C, PCAP = 2, 4, 4, 2, 128, 512, 128
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, H, DH)).astype(np.float32)
    k, v = _bf16(rng, (L, B, HKV, C, DH)), _bf16(rng, (L, B, HKV, C, DH))
    kn, vn = _bf16(rng, (B, HKV, DH)), _bf16(rng, (B, HKV, DH))
    lengths = np.asarray([0, 5, 100, 128], np.int32)
    write_idx = np.asarray([0, 5, PCAP + 7, C - 1], np.int32)   # start 0
    if poison:                         # stale rows at the slot being written
        for b, s in enumerate(write_idx):
            k[1, b, :, s] = 1e3
            v[1, b, :, s] = -1e3
    ja, jk, jv = jfd.flash_gqa_decode_append(
        jnp.asarray(q), *(jnp.asarray(a, jnp.bfloat16) for a in (k, v, kn, vn)),
        jnp.asarray(lengths), jnp.asarray(write_idx), jnp.int32(1), PCAP,
        interpret=True)
    tk, tv = _t(k), _t(v)
    ta = tfd.flash_gqa_decode_append(
        torch.from_numpy(q), tk, tv, _t(kn), _t(vn),
        torch.from_numpy(lengths), torch.from_numpy(write_idx), 1, PCAP)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja, np.float32),
                               rtol=0, atol=ATTN_ATOL)
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))


def test_per_lane_update_cache_matches_jax():
    rng = np.random.default_rng(10)
    cache = rng.standard_normal((3, 2, 16, 8)).astype(np.float32)
    new = rng.standard_normal((3, 2, 2, 8)).astype(np.float32)
    start = np.asarray([0, 5, 14], np.int32)
    want = jatt.update_cache(jnp.asarray(cache), jnp.asarray(new),
                             jnp.asarray(start))
    got = update_cache(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                       torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_codec_reset_lanes_matches_jax(tiny_engine):
    cfg = tiny_engine.config.codec_decoder
    js = jcd.init_decoder_state(cfg, tiny_engine.codec_decoder_params, 3)
    codes = np.random.default_rng(11).integers(0, 64, (3, 4, 16)).astype(
        np.int32)
    _, js = jcd.decode_chunk(cfg, tiny_engine.codec_decoder_params,
                             jnp.asarray(codes), js)
    mask = np.asarray([True, False, True])
    want = jcd.reset_lanes(js, jnp.asarray(mask))
    ts = tcd.DecoderState(
        ring_k=_t(js.ring_k, torch.float32), ring_v=_t(js.ring_v, torch.float32),
        ring_pos=_t(js.ring_pos, torch.int32), count=_t(js.count, torch.int32),
        conv_hist=[_t(h, torch.float32) for h in js.conv_hist],
        up_tail=[_t(u, torch.float32) for u in js.up_tail])
    got = tcd.reset_lanes(ts, torch.from_numpy(mask))
    for name in ("ring_k", "ring_v", "ring_pos", "count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    for g, w in zip(got.conv_hist + got.up_tail,
                    list(want.conv_hist) + list(want.up_tail)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want.count).tolist()[1] == 4


def test_talker_step_batch_gate():
    from qwen3_tts_tpu_torch.core.config import TalkerConfig
    from qwen3_tts_tpu_torch.kernels import talker_step as tts
    cfg = TalkerConfig()
    for b in (5, 7, 9, 104, 0):
        assert not tts.supported(cfg, b), b
    for b in (1, 2, 3, 4, *range(8, 97, 8)):
        assert tts.supported(cfg, b), b


# ------------------------------------------------- engines on the JAX weights
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
    saved = (je.max_steps, je.sampler_config, je.config, je.generator)
    yield je, te
    je.max_steps, je.sampler_config, je.config, je.generator = saved


def test_refill_lanes_matches_jax(pair):
    je, te = pair
    texts = ("the first occupant", "replacement one", "replacement two")
    jplans = [je._build_voice_prompt(t, je.get_speaker("vivian"), None)
              for t in texts]
    tplans = [te._build_voice_prompt(t, te.get_speaker("vivian"), None)
              for t in texts]
    bucket = je._bucket(max(p.length for p in jplans))
    lens_r = [min(p.length, bucket) for p in jplans[1:]]
    lanes = [1, 3]

    embeds, lens = je.prompt_to_device([jplans[0]] * 4, bucket)
    js = je.generator.start(embeds, jnp.asarray(lens), jax.random.PRNGKey(0))
    js, _, _ = je.generator.chunk(
        js, JSP.make(JS(temperature=0.0, seed=1)), prompt_cap=bucket,
        n_frames=2, uniform_cursor=False)
    eb, _ = je.prompt_to_device(jplans[1:], bucket)
    want = je.generator.refill_lanes(js, eb, lens_r, lanes)

    with torch.no_grad():
        embeds_t, lens_t = te.prompt_to_device([tplans[0]] * 4, bucket)
        ts = te.generator.start(embeds_t, torch.from_numpy(lens_t),
                                torch.Generator().manual_seed(0))
        ts, _, _ = tg.gen_frames(
            te.config, te.generator.talker_params,
            te.generator.predictor_params, te.generator.assets_pack, ts,
            tg.SamplerParams(0.0, 40, 0.9), 2, bucket, uniform_cursor=False)
        eb_t, _ = te.prompt_to_device(tplans[1:], bucket)
        got = te.generator.refill_lanes(ts, eb_t, lens_r, lanes)

    for name in ("logits", "hidden"):
        np.testing.assert_allclose(
            getattr(got, name).numpy()[lanes],
            np.asarray(getattr(want, name))[lanes], rtol=REFILL_RTOL,
            atol=REFILL_ATOL, err_msg=name)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    for name in ("lengths", "write_idx"):
        np.testing.assert_array_equal(
            getattr(got.cache, name).numpy(),
            np.asarray(getattr(want.cache, name)), err_msg=name)
    assert got.cache.write_idx.tolist() == [bucket + 2, bucket, bucket + 2,
                                            bucket]


def test_continuous_batcher_matches_jax(pair):
    """Exact path, greedy, 5 requests on 2 lanes with mixed budgets."""
    je, te = pair
    budgets = (3, 8, 5, 12, 4)
    out = []
    for eng, sc, req, batcher in ((je, JS, JBR, JCB), (te, TS, TBR, TCB)):
        eng.set_max_steps(16)
        eng.set_sampler_config(sc(temperature=0.0, seed=3))
        voice = eng.get_speaker("vivian")
        reqs = [req(f"serving request {i}", voice, max_frames=m)
                for i, m in enumerate(budgets)]
        out.append(batcher(eng, batch_size=2, max_frames_per_stream=12,
                           group_chunks=4).run(reqs))
    spf = te.config.codec_decoder.samples_per_frame
    for i, (w, g) in enumerate(zip(*out)):
        assert (g.frames, g.eos) == (w.frames, w.eos), i
        assert 0 < g.frames <= budgets[i]
        assert len(g.audio.samples) == g.frames * spf
        np.testing.assert_allclose(g.audio.samples, w.audio.samples,
                                   atol=WAV_ATOL, err_msg=str(i))
        assert g.ttft_ms is not None and g.ttft_ms >= 0


def test_batcher_on_the_step_schedule(pair):
    """fused=True at batch 8 (per-lane talker step and predictor frame, as
    on the card), on the CPU: the plain versions run and the queue
    completes; no kernel launch is counted."""
    from qwen3_tts_tpu_torch.kernels import chunk_step as tcs
    from qwen3_tts_tpu_torch.kernels import predictor_frame as tpf
    from qwen3_tts_tpu_torch.kernels import talker_step as tts
    from qwen3_tts_tpu_torch.models import predictor as tpred
    from qwen3_tts_tpu_torch.models import talker as ttalk
    from qwen3_tts_tpu_torch.core.config import PredictorConfig as TPC
    from qwen3_tts_tpu_torch.core.config import TalkerConfig as TTC
    _, te = pair
    # tests/test_torch_engine.py's fused config: the kernels' widths, two
    # layers each
    cfg = TC.tiny().replace(
        talker=TTC(d_model=2048, n_layers=2, n_heads=2, n_kv_heads=1,
                   head_dim=128, d_ff=256, mrope_sections=(24, 20, 20, 0),
                   dtype="bfloat16"),
        predictor=TPC(d_model=1024, n_layers=2, n_heads=4, n_kv_heads=2,
                      head_dim=64, d_ff=256, dtype="bfloat16"))
    g = torch.Generator().manual_seed(0)
    eng = TtsEngine(model_dir=te.model_dir, config=cfg, device="cpu",
                    fused=True, chunk=True, weights=dict(
                        assets=te.assets,
                        talker=ttalk.init_talker_params(cfg.talker, g),
                        predictor=tpred.init_predictor_params(
                            cfg.predictor, g),
                        codec_decoder=te.codec_decoder_params))
    counters = (tcs.gen_chunk_fused, tts.talker_step_fused,
                tpf.predict_frame_fused, tfd.append_kv_lanes,
                tfd.inject_prompt_lanes, tfd.flash_gqa_decode_append)
    before = [f.launches for f in counters]
    eng.set_max_steps(8)
    eng.set_sampler_config(TS(temperature=0.0, seed=2))
    voice = eng.get_speaker("vivian")
    budgets = [4, 8, 4, 8, 4, 8, 4, 8, 4, 4]
    reqs = [TBR(f"lane {i}", voice, max_frames=m)
            for i, m in enumerate(budgets)]
    results = TCB(eng, batch_size=8, max_frames_per_stream=8).run(reqs)
    spf = cfg.codec_decoder.samples_per_frame
    for r, m in zip(results, budgets):
        assert 0 < r.frames <= m
        assert len(r.audio.samples) == r.frames * spf
        assert np.isfinite(r.audio.samples).all()
    assert [f.launches for f in counters] == before
