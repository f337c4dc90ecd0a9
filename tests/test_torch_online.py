"""Online serving in the port (qwen3_tts_tpu_torch/serve/online.py) on the
CPU: `OnlineBatcher` and `OnlineRouter` at EngineConfig.tiny(), one torch
thread.

- The port's OnlineBatcher against the JAX package's on the same weights
  (io/from_jax.engine_weights), greedy, requests submitted one at a time
  so that each one's lane is fixed: frames and EOS equal, audio within
  WAV_ATOL (f32 throughout, tests/test_torch_serving.py's bound).
- The port counterparts of every case of tests/test_online.py: submit and
  complete, idle then resubmit, concurrent clients, stop fails pending,
  an oversized prompt fails its own future but not the scheduler, a crash
  of the loop fails the in-flight futures, the router routes to the
  smallest bucket, the router under concurrent mixed lengths.
- A frame budget that is not a positive integer, or one past the room of
  the state's cache, fails or is cut for its own request only, and the
  next request is served; a submit() after stop() fails at once.
- LaneCodec.run_chunk is run_group of one chunk.
- An engine on the ONNX codec (tests/torch_onnx_fixtures.py) serves to
  completion, with the frames and EOS of the native engine on the same LM.
- The worker runs without autograd: grad mode is per thread.
"""

import threading

import numpy as np
import jax
import pytest
import torch

import torch_onnx_fixtures as tfx
from qwen3_tts_tpu.core.config import SamplerConfig as JS
from qwen3_tts_tpu.serve.batch import BatchRequest as JBR
from qwen3_tts_tpu.serve.online import OnlineBatcher as JOB
from qwen3_tts_tpu_torch.core.config import EngineConfig as TC
from qwen3_tts_tpu_torch.core.config import SamplerConfig as TS
from qwen3_tts_tpu_torch.engine import PromptTooLongError, TtsEngine
from qwen3_tts_tpu_torch.io.from_jax import engine_weights
from qwen3_tts_tpu_torch.io.voice_file import VoiceFile
from qwen3_tts_tpu_torch.runtime.generate import SamplerParams
from qwen3_tts_tpu_torch.serve.batch import BatchRequest
from qwen3_tts_tpu_torch.serve.codec_path import LaneCodec
from qwen3_tts_tpu_torch.serve.online import OnlineBatcher, OnlineRouter

torch.set_num_threads(1)

WAV_ATOL = 1e-5
TIMEOUT = 120


def _model_dir(root, onnx=False):
    spk = root / "preset_speakers"
    spk.mkdir(parents=True)
    VoiceFile.new("", [], np.random.default_rng(0).standard_normal(2048)
                  .astype(np.float32) * 0.02).save(spk / "vivian.json")
    if onnx:
        (root / "onnx").mkdir()
        tfx.build_decoder(tfx.MINI,
                          path=root / "onnx" / "qwen3_tts_decoder.onnx")
    return root


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    eng = TtsEngine(model_dir=_model_dir(tmp_path_factory.mktemp("online")),
                    config=TC.tiny(), device="cpu")
    eng.set_max_steps(8)
    return eng


@pytest.fixture()
def batcher(engine):
    engine.set_sampler_config(TS(seed=4))
    ob = OnlineBatcher(engine, batch_size=2, bucket=32,
                       max_frames_per_stream=4, idle_poll_s=0.01).start()
    yield ob
    ob.stop()


def _ok(engine, r, budget):
    spf = engine.config.codec_decoder.samples_per_frame
    assert 0 < r.frames <= budget
    assert len(r.audio.samples) == r.frames * spf
    assert np.isfinite(r.audio.samples).all()


# ------------------------------------------------- against the JAX batcher
@pytest.fixture(scope="module")
def pair(tiny_engine):
    je = tiny_engine
    a = je.assets
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    weights = engine_weights(
        {n: np.asarray(getattr(a, n))
         for n in ("text_table", "codec_tables", "codec_tables_1024",
                   "proj_w", "proj_b", "tts_pad")},
        np_(je.talker_params), np_(je.predictor_params),
        np_(je.codec_decoder_params))
    te = TtsEngine(model_dir=je.model_dir, config=TC.tiny(), device="cpu",
                   weights=weights)
    saved = (je.max_steps, je.sampler_config, je.config, je.generator)
    yield je, te
    je.max_steps, je.sampler_config, je.config, je.generator = saved


def test_online_batcher_matches_jax(pair):
    """Exact path, greedy, 2 lanes, 5 requests with mixed budgets, one at a
    time (a cold start, then refills of lane 0)."""
    je, te = pair
    budgets = (3, 8, 5, 12, 4)
    out = []
    for eng, sc, req, cls in ((je, JS, JBR, JOB),
                              (te, TS, BatchRequest, OnlineBatcher)):
        eng.set_max_steps(16)
        eng.set_sampler_config(sc(temperature=0.0, seed=3))
        voice = eng.get_speaker("vivian")
        ob = cls(eng, batch_size=2, bucket=32, max_frames_per_stream=12,
                 idle_poll_s=0.01).start()
        try:
            out.append([ob.submit(req(f"online request {i}", voice,
                                      max_frames=m)).result(timeout=TIMEOUT)
                        for i, m in enumerate(budgets)])
        finally:
            ob.stop()
    for i, (w, g) in enumerate(zip(*out)):
        assert (g.frames, g.eos) == (w.frames, w.eos), i
        _ok(te, g, budgets[i])
        np.testing.assert_allclose(g.audio.samples, w.audio.samples,
                                   rtol=0, atol=WAV_ATOL, err_msg=str(i))


# ------------------------------------------ the JAX package's online cases
def test_submit_and_complete(batcher, engine):
    voice = engine.get_speaker("vivian")
    futs = [batcher.submit(BatchRequest(f"text {i}", voice, max_frames=3))
            for i in range(5)]
    for f in futs:
        _ok(engine, f.result(timeout=TIMEOUT), 3)


def test_idle_then_resubmit(batcher, engine):
    voice = engine.get_speaker("vivian")
    r1 = batcher.submit(BatchRequest("first", voice, max_frames=2)
                        ).result(timeout=TIMEOUT)
    # the worker parks, then takes more work
    r2 = batcher.submit(BatchRequest("second", voice, max_frames=2)
                        ).result(timeout=TIMEOUT)
    _ok(engine, r1, 2)
    _ok(engine, r2, 2)


def test_concurrent_clients(batcher, engine):
    voice = engine.get_speaker("vivian")
    results = {}

    def client(i):
        results[i] = batcher.submit(BatchRequest(
            f"client {i}", voice, max_frames=2)).result(timeout=TIMEOUT)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert len(results) == 4
    for r in results.values():
        _ok(engine, r, 2)


def test_stop_fails_pending(engine, monkeypatch):
    """One lane, three requests: the first holds the lane while the worker
    is held in its first chunk; stop() then finishes it with what it has
    and fails the two still queued with "scheduler stopped"."""
    engine.set_sampler_config(TS(seed=1))
    entered, release = threading.Event(), threading.Event()
    run_chunk = LaneCodec.run_chunk

    def held(self, *a, **kw):
        entered.set()
        release.wait(TIMEOUT)
        return run_chunk(self, *a, **kw)

    monkeypatch.setattr(LaneCodec, "run_chunk", held)
    ob = OnlineBatcher(engine, batch_size=1, bucket=32,
                       max_frames_per_stream=8, idle_poll_s=0.01)
    voice = engine.get_speaker("vivian")
    f1 = ob.submit(BatchRequest("a", voice, max_frames=8))
    assert entered.wait(TIMEOUT)
    queued = [ob.submit(BatchRequest(t, voice, max_frames=2))
              for t in ("b", "c")]
    stopper = threading.Thread(target=ob.stop)
    stopper.start()
    assert ob._stop.wait(TIMEOUT)
    release.set()
    stopper.join(TIMEOUT)
    assert not ob._thread.is_alive()
    r1 = f1.result(timeout=TIMEOUT)
    assert not r1.eos and r1.frames <= 4
    for f in queued:
        with pytest.raises(RuntimeError, match="scheduler stopped"):
            f.result(timeout=TIMEOUT)


def test_oversized_prompt_fails_future_not_scheduler(batcher, engine):
    voice = engine.get_speaker("vivian")
    f_bad = batcher.submit(BatchRequest("y" * 500, voice, max_frames=2))
    f_ok = batcher.submit(BatchRequest("short", voice, max_frames=2))
    with pytest.raises(PromptTooLongError):
        f_bad.result(timeout=TIMEOUT)
    _ok(engine, f_ok.result(timeout=TIMEOUT), 2)


@pytest.mark.parametrize("bad", ["12", 0, -3, 2.5, True])
def test_bad_budget_fails_its_future_not_scheduler(batcher, engine, bad):
    """A frame budget that is not a positive integer fails its own future
    at submit(); the scheduler serves the next request."""
    voice = engine.get_speaker("vivian")
    f_bad = batcher.submit(BatchRequest("bad budget", voice, max_frames=bad))
    with pytest.raises(ValueError, match="max_frames"):
        f_bad.result(timeout=TIMEOUT)
    _ok(engine, batcher.submit(BatchRequest("after it", voice, max_frames=2)
                               ).result(timeout=TIMEOUT), 2)


def test_oversized_budget_is_cut_to_the_cache(engine, monkeypatch):
    """A budget past the room of the state's cache runs to that room and
    no further: after every chunk each lane's cursor lies inside the cache
    (update_cache would drop a write past it without a word), and the next
    request is served.  Bucket 480 of the tiny config leaves a 512-slot
    cache room for 512 - 480 - 4 = 28 frames."""
    engine.set_sampler_config(TS(seed=3, temperature=0.0))
    run_chunk = LaneCodec.run_chunk
    seen = []

    def held(self, state, *a, **kw):
        out = run_chunk(self, state, *a, **kw)
        seen.append((int(out[0].cache.write_idx.max()),
                     out[0].cache.capacity))
        return out

    monkeypatch.setattr(LaneCodec, "run_chunk", held)
    ob = OnlineBatcher(engine, batch_size=1, bucket=480, idle_poll_s=0.01)
    voice = engine.get_speaker("vivian")
    try:
        big = ob.submit(BatchRequest("a long budget", voice,
                                     max_frames=10 ** 6)
                        ).result(timeout=TIMEOUT)
        nxt = ob.submit(BatchRequest("next", voice, max_frames=2)
                        ).result(timeout=TIMEOUT)
    finally:
        ob.stop()
    assert seen and seen[0][1] == 512
    assert all(cursor <= cap for cursor, cap in seen), seen
    assert big.eos or big.frames == 28
    assert 0 < big.frames <= 28
    assert len(big.audio.samples) == \
        big.frames * engine.config.codec_decoder.samples_per_frame
    _ok(engine, nxt, 2)


def test_submit_after_stop_fails_at_once(engine):
    """A stopped batcher or router fails a new request's future at once,
    with "scheduler stopped", instead of queueing it for no worker."""
    voice = engine.get_speaker("vivian")
    ob = OnlineBatcher(engine, batch_size=1, bucket=32, idle_poll_s=0.01)
    _ok(engine, ob.submit(BatchRequest("one", voice, max_frames=2)
                          ).result(timeout=TIMEOUT), 2)
    ob.stop()
    late = ob.submit(BatchRequest("late", voice, max_frames=2))
    assert late.done()
    with pytest.raises(RuntimeError, match="scheduler stopped"):
        late.result(timeout=0)
    router = OnlineRouter(engine, batch_size=1, buckets=(32, 64),
                          idle_poll_s=0.01)
    router.stop()
    late = router.submit(BatchRequest("late", voice, max_frames=2))
    with pytest.raises(RuntimeError, match="scheduler stopped"):
        late.result(timeout=0)


def test_scheduler_crash_fails_inflight_futures(engine, monkeypatch):
    def boom(self, *a, **kw):
        raise RuntimeError("backend exploded")

    monkeypatch.setattr(LaneCodec, "run_chunk", boom)
    engine.set_sampler_config(TS(seed=9))
    ob = OnlineBatcher(engine, batch_size=2, bucket=32,
                       max_frames_per_stream=2, idle_poll_s=0.01).start()
    voice = engine.get_speaker("vivian")
    fut = ob.submit(BatchRequest("crash", voice, max_frames=2))
    with pytest.raises(RuntimeError, match="backend exploded"):
        fut.result(timeout=TIMEOUT)
    ob.stop()
    assert not ob._thread.is_alive()


def test_router_routes_to_smallest_bucket(engine):
    engine.set_sampler_config(TS(seed=9))
    voice = engine.get_speaker("vivian")
    router = OnlineRouter(engine, batch_size=2, buckets=(32, 64),
                          max_frames_per_stream=3, idle_poll_s=0.01)
    try:
        r1 = router.submit(BatchRequest("hi", voice, max_frames=2)
                           ).result(timeout=TIMEOUT)
        assert set(router._batchers) == {32}       # started lazily
        long_text = "word " * 8                    # > 32 rows
        assert engine._build_voice_prompt(long_text, voice,
                                          None).length > 32
        r2 = router.submit(BatchRequest(long_text, voice, max_frames=2)
                           ).result(timeout=TIMEOUT)
        assert set(router._batchers) == {32, 64}
        _ok(engine, r1, 2)
        _ok(engine, r2, 2)
        hopeless = router.submit(BatchRequest("x " * 200, voice,
                                              max_frames=2))
        with pytest.raises(PromptTooLongError):
            hopeless.result(timeout=TIMEOUT)
    finally:
        router.stop()


def test_router_concurrent_mixed_lengths(engine):
    engine.set_sampler_config(TS(seed=10))
    voice = engine.get_speaker("vivian")
    router = OnlineRouter(engine, batch_size=2, buckets=(32, 64),
                          max_frames_per_stream=3, idle_poll_s=0.01)
    try:
        futs = [router.submit(BatchRequest(
            ("t " * (1 + 4 * (i % 4))).strip(), voice, max_frames=2))
            for i in range(6)]
        for f in futs:
            _ok(engine, f.result(timeout=TIMEOUT), 2)
    finally:
        router.stop()


# ----------------------------------------------------------- the lane codec
def test_run_chunk_is_one_chunk_group(engine):
    """run_chunk against run_group(max_frames = n_frames) from one state:
    codes, valid (budget-masked), saw_eos and done equal."""
    n = engine.config.runtime.frames_per_chunk
    sampler = SamplerParams(0.0, 40, 0.9)
    budgets = [n, 2]
    out = []
    with torch.no_grad():
        plans = [engine._build_voice_prompt(t, engine.get_speaker("vivian"),
                                            None) for t in ("one", "two")]
        embeds, lens = engine.prompt_to_device(plans, 32)
        for run in ("chunk", "group"):
            st = engine.generator.start(embeds, torch.from_numpy(lens),
                                        torch.Generator().manual_seed(0))
            codec = LaneCodec(engine, 2)
            if run == "chunk":
                res = codec.run_chunk(st, sampler, prompt_cap=32,
                                      n_frames=n, budgets=budgets)
            else:
                res = codec.run_group(st, sampler, prompt_cap=32,
                                      n_frames=n, max_frames=n,
                                      budgets=budgets)
            out.append((res, codec))
    (a, codec), (b, _) = out
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    assert a[0].done.tolist() == [True, True]     # both at their budgets
    assert a[2].sum(1).tolist() == [n, 2]


# ---------------------------------------------------- the ONNX codec engine
def test_onnx_codec_engine_served(engine, tmp_path):
    """An engine on the ONNX decoder graph (the native engine's LM weights)
    serves its requests to completion: frames and EOS equal to the native
    engine's, frames x the graph's samples per frame, finite."""
    onnx = TtsEngine(model_dir=_model_dir(tmp_path, onnx=True),
                     config=TC.tiny(), device="cpu",
                     weights=dict(assets=engine.assets,
                                  talker=engine.talker_params,
                                  predictor=engine.predictor_params))
    assert onnx.onnx_decoder is not None
    budgets = (3, 6, 4)
    out = []
    for eng in (engine, onnx):
        eng.set_sampler_config(TS(temperature=0.0, seed=2))
        voice = eng.get_speaker("vivian")
        ob = OnlineBatcher(eng, batch_size=2, bucket=32,
                           max_frames_per_stream=6, idle_poll_s=0.01)
        try:
            futs = [ob.submit(BatchRequest(f"onnx {i}", voice, max_frames=m))
                    for i, m in enumerate(budgets)]
            out.append([f.result(timeout=TIMEOUT) for f in futs])
        finally:
            ob.stop()
    for (n, o), m in zip(zip(*out), budgets):
        assert (o.frames, o.eos) == (n.frames, n.eos)
        assert 0 < o.frames <= m
        assert len(o.audio.samples) == o.frames * tfx.MINI.spf
        assert np.isfinite(o.audio.samples).all()


# ------------------------------------------------------------- no autograd
def test_worker_runs_without_autograd(engine, tmp_path, monkeypatch):
    """The talker's codec head requires grad: a state made with grad mode
    on would carry a graph.  The worker's chunks run with grad off (it is
    per thread: the caller's no_grad does not reach the worker) and its
    state carries none."""
    talker = dict(engine.talker_params)
    talker["codec_head"] = talker["codec_head"].detach().clone() \
        .requires_grad_(True)
    eng = TtsEngine(model_dir=_model_dir(tmp_path), config=TC.tiny(),
                    device="cpu",
                    weights=dict(assets=engine.assets, talker=talker,
                                 predictor=engine.predictor_params,
                                 codec_decoder=engine.codec_decoder_params))
    seen = []
    run_chunk = LaneCodec.run_chunk

    def spy(self, state, *a, **kw):
        out = run_chunk(self, state, *a, **kw)
        seen.append((torch.is_grad_enabled(), out[0].logits.requires_grad,
                     out[0].hidden.requires_grad))
        return out

    monkeypatch.setattr(LaneCodec, "run_chunk", spy)
    eng.set_max_steps(8)
    eng.set_sampler_config(TS(seed=5))
    ob = OnlineBatcher(eng, batch_size=2, bucket=32, idle_poll_s=0.01)
    try:
        with torch.no_grad():          # the caller's mode stays its own
            fut = ob.submit(BatchRequest("graph", eng.get_speaker("vivian"),
                                         max_frames=4))
        r = fut.result(timeout=TIMEOUT)
    finally:
        ob.stop()
    assert torch.is_grad_enabled()
    _ok(eng, r, 4)
    assert seen and all(s == (False, False, False) for s in seen), seen
    # the same head with grad on gives a graph: the check can fail
    with torch.enable_grad():
        st = eng.generator.start(
            torch.zeros(1, 32, 2048), torch.tensor([32], dtype=torch.int32),
            torch.Generator().manual_seed(0))
    assert st.logits.requires_grad
