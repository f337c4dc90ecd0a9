"""Wave batching in the port (qwen3_tts_tpu_torch/serve/batch.py
`BatchSynthesizer`) and the chunk kernel's batched forms
(kernels/chunk_step.py at B lanes), on the CPU, against the JAX package on
the same inputs and weights.

- Lane isolation of `gen_chunk_plain` (the batched kernel's plain version)
  at B = 8 and 32, F = 2: lanes of the second half duplicate the first, and
  every output (codes, logits, hidden, cache) is equal lane for lane;
  frame 0's code_0 is the argmax of each lane's logits; every cache slot
  but the chunk's is untouched (tests/test_chunk_kernel.py:266-338).
- The plain version's layer_taps replay layer by layer exactly, as
  chip_smoke.py replays the kernel's.
- With XLA's excess precision off (a subprocess, as in
  tests/test_torch_chunk_step.py), two distinct lanes with ragged prompt
  lengths and one cursor, against the JAX frame loop's chunk route
  (`_gen_frames_chunk`, the Pallas kernel in interpret mode) at batch 1,
  lane by lane, four greedy frames:
  * `gen_chunk_plain` at B = 8: every code equal, logits, hidden and the
    written k/v rows within EXACT_ATOL (f32 summation order), every other
    slot bit-equal;
  * the port's `gen_frames` at B = 24 and 32 (the route a wave takes: one
    `gen_chunk_fused` call per chunk): codes and valid flags equal.  The
    JAX kernel's own b >= 24 form rounds proj_w and the rope tables to bf16
    (ROADMAP Queue C) and is not the reference; the JAX XLA frame loop
    (bf16 weights) computes another quantization class than the w4a8
    kernel, so its greedy codes differ wherever quantization moves a near
    tie; at batch 1 the JAX frame loop runs the same w4a8 function as the
    port.
- `BatchSynthesizer` against the JAX one at EngineConfig.tiny() on the
  same weights (io/from_jax), the exact path on both, greedy: 5 requests
  at batch_size 4 (the second wave padded) with mixed budgets; frames and
  eos equal, audio within WAV_ATOL (tests/test_torch_engine.py's bound).
- Pad lanes of a short last wave take its first request's budget, and
  the real lanes, greedy and sampled, are the same as with the JAX
  synthesizer's pad budget (the engine's max_steps).
- A `chunk=True` engine on the CPU: a wave of 8 identical requests goes
  through `gen_chunk_fused` (one call per chunk at B = 8; no launch on the
  CPU) and gives 8 identical results, equal to the batch-1 wave of that
  request within WAV_ATOL (torch's CPU matmuls order their sums by shape).
- The chunk gate's messages; a wave on the single-process 1 x 1 mesh
  equal to the mesh-less wave (meshes of more ranks:
  tests/test_torch_parallel.py); a wave on the ONNX codec (the MINI
  fixture graph): codes equal the native-codec wave's, audio a decode of
  each lane's codes alone within WAV_ATOL.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.core.config import SamplerConfig as JS
from qwen3_tts_tpu.serve.batch import BatchRequest as JBR
from qwen3_tts_tpu.serve.batch import BatchSynthesizer as JBS
from qwen3_tts_tpu_torch.core.config import EngineConfig as TC
from qwen3_tts_tpu_torch.core.config import PredictorConfig as TPC
from qwen3_tts_tpu_torch.core.config import SamplerConfig as TS
from qwen3_tts_tpu_torch.core.config import TalkerConfig as TTC
from qwen3_tts_tpu_torch.engine import TtsEngine
from qwen3_tts_tpu_torch.io.from_jax import engine_weights, to_tensor
from qwen3_tts_tpu_torch.kernels import chunk_step as tcs
from qwen3_tts_tpu_torch.kernels import talker_step as tts
from qwen3_tts_tpu_torch.models import predictor as tpred
from qwen3_tts_tpu_torch.models import talker as ttalk
from qwen3_tts_tpu_torch.runtime import generate as tg
from qwen3_tts_tpu_torch.serve.batch import BatchRequest as TBR
from qwen3_tts_tpu_torch.serve.batch import BatchSynthesizer as TBS

WAV_ATOL = 1e-5
# tests/test_torch_chunk_step.py's config and cache layout
TALKER = dict(d_model=256, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=128,
              d_ff=256, mrope_sections=(24, 20, 20, 0), dtype="bfloat16")
PRED = dict(d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
            d_ff=256, dtype="bfloat16")
PCAP, CAP, START = 512, 1024, 517
GREEDY = (0.0, 40, 0.9)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this file runs: the suite runs several test
    processes at once, where torch's parallel CPU ops mostly wait on each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(n, seed, lengths):
    """n lane states: caches [L, n, 1, CAP, 128] (bf16 values), logits,
    hidden, prompt lengths, as numpy."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
        jnp.float32))
    shape = (TALKER["n_layers"], n, 1, CAP, 128)
    return dict(k=bf(rng.standard_normal(shape) * 0.3),
                v=bf(rng.standard_normal(shape) * 0.3),
                logits=rng.standard_normal((n, 2160)).astype(np.float32),
                hidden=(rng.standard_normal((n, 256)) * 0.3).astype(
                    np.float32),
                lengths=np.asarray(lengths, np.int32))


def _take(st, idx):
    """The lanes idx of a lane state (numpy)."""
    return dict(k=st["k"][:, idx], v=st["v"][:, idx],
                logits=st["logits"][idx], hidden=st["hidden"][idx],
                lengths=st["lengths"][idx])


def _plain(packs, st, n_frames):
    """gen_chunk_plain from lane state st (positions = prompt lengths, one
    cursor START), greedy.  Returns (codes, logits, hidden, k, v)."""
    tcfg, pcfg, tw, pw, ex = packs
    b = st["hidden"].shape[0]
    k = to_tensor(st["k"]).to(torch.bfloat16)
    v = to_tensor(st["v"]).to(torch.bfloat16)
    lengths = torch.from_numpy(st["lengths"])
    p = lengths.long()[None, :] + torch.arange(n_frames)[:, None]
    cos, sin = ttalk._rope_tables(tcfg, ttalk._pos4(p))
    codes, lg, hd = tcs.gen_chunk_plain(
        tcfg, pcfg, tw, pw, ex, torch.from_numpy(st["logits"]),
        torch.from_numpy(st["hidden"]), k, v, lengths,
        torch.full((b,), START, dtype=torch.int32), cos.float(), sin.float(),
        torch.zeros(n_frames, b), GREEDY, PCAP)
    return codes, lg, hd, k, v


# ------------------------------------------ the batched plain version
@pytest.fixture(scope="module")
def packs():
    tcfg, pcfg = TTC(**TALKER), TPC(**PRED)
    g = torch.Generator().manual_seed(11)
    rng = np.random.default_rng(12)
    rnd = lambda *s, scale: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32))
    with torch.no_grad():
        tp = ttalk.init_talker_params(tcfg, g)
        pp = tpred.init_predictor_params(pcfg, g)
        pack = {"proj_w": rnd(256, 256, scale=0.05),
                "proj_b": rnd(256, scale=0.01),
                "tts_pad": rnd(256, scale=0.02),
                "codec_tables": rnd(16, 2160, 256, scale=0.02),
                "codec_tables_1024": rnd(16, 2048, 256, scale=0.02)}
        return (tcfg, pcfg, tts.prep_layer_weights(tcfg, tp),
                tcs.prep_predictor_w4(pcfg, pp),
                tcs.prep_chunk_extras(tcfg, pcfg, tp, pp, pack))


@pytest.mark.parametrize("b", [8, 32])
def test_plain_lanes_are_isolated(packs, b):
    half, n_frames = b // 2, 2
    lengths = [1 + (100 + 61 * i) % 500 for i in range(half)]
    st = _take(_lanes(half, b, lengths), list(range(half)) * 2)
    codes, lg, hd, k, v = _plain(packs, st, n_frames)
    assert codes.shape == (b, n_frames, 16) and lg.shape == (b, 2160)
    for out in (codes, lg, hd):
        assert torch.equal(out[:half], out[half:])
    for new in (k, v):
        assert torch.equal(new[:, :half], new[:, half:])
    np.testing.assert_array_equal(codes[:, 0, 0].numpy(),
                                  st["logits"].argmax(-1))
    keep = np.ones(CAP, bool)
    keep[START:START + n_frames] = False
    for new, old in ((k, st["k"]), (v, st["v"])):
        new = new.float().numpy()
        np.testing.assert_array_equal(new[:, :, :, keep], old[:, :, :, keep])
        assert (np.abs(new[:, :, :, START:START + n_frames]).sum(-1)
                > 0).all()


@pytest.mark.parametrize("tile", [512, 128])
def test_plain_layer_taps_replay_layer_by_layer(packs, tile):
    """layer_taps of the plain version (the kernel's layout: per frame the
    residual entering each talker layer, then the last): the feedback of
    the frame's codes first, each layer replayed from its tap with the
    written cache gives the next tap and the written k/v row exactly, and
    the final norm of the last tap is the hidden; chip_smoke.py holds the
    kernel's layer_taps to the plain layers this way."""
    tcfg, pcfg, tw, pw, ex = packs
    b, n_frames = 8, 2
    st = _lanes(b, 31, [1 + (90 + 53 * i) % 500 for i in range(b)])
    k = to_tensor(st["k"]).to(torch.bfloat16)
    v = to_tensor(st["v"]).to(torch.bfloat16)
    lengths = torch.from_numpy(st["lengths"])
    p = lengths.long()[None, :] + torch.arange(n_frames)[:, None]
    cos, sin = (t.float() for t in ttalk._rope_tables(tcfg, ttalk._pos4(p)))
    xt = []
    codes, lg, hd = tcs.gen_chunk_plain(
        tcfg, pcfg, tw, pw, ex, torch.from_numpy(st["logits"]),
        torch.from_numpy(st["hidden"]), k, v, lengths,
        torch.full((b,), START, dtype=torch.int32), cos, sin,
        torch.zeros(n_frames, b), GREEDY, PCAP, prefix_tile=tile,
        layer_taps=xt)
    assert len(xt) == n_frames
    assert xt[0].shape == (b, tcfg.n_layers + 1, tcfg.d_model)
    for f in range(n_frames):
        assert torch.equal(xt[f][:, 0], tcs._feedback(
            ex["ctab_fb"], codes[:, f], ex["tts_pad"]))
        kc, vc = k.clone(), v.clone()
        for layer in range(tcfg.n_layers):
            y = tcs._talker_layer_plain(tcfg, tw, layer, xt[f][:, layer],
                                        cos[f], sin[f], kc, vc, lengths,
                                        START, f, PCAP, tile)
            assert torch.equal(y, xt[f][:, layer + 1]), (f, layer)
        assert torch.equal(kc, k) and torch.equal(vc, v), f
    assert torch.equal(tcs._rms(xt[-1][:, -1], ex["tfn"], tcfg.rms_eps), hd)


# --------------- against the JAX frame loop at batch 1, lane by lane
def wave_main():
    """Run by the `jax_lanes` fixture in a process whose XLA flags turn
    excess precision off; prints one JSON line of what the tests check."""
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    import test_torch_chunk_step as base
    from qwen3_tts_tpu.core.config import EngineConfig as JEC
    from qwen3_tts_tpu.models import transformer as jtr
    from qwen3_tts_tpu.runtime import generate as jg
    from qwen3_tts_tpu_torch.models.transformer import KVCache

    c = base._case()
    n_frames = 4
    st = c["state"]
    second = _lanes(1, 21, [37])
    lanes = dict(k=np.concatenate([st["k"], second["k"]], 1),
                 v=np.concatenate([st["v"], second["v"]], 1),
                 logits=np.concatenate([st["logits"], second["logits"]]),
                 hidden=np.concatenate([st["hidden"], second["hidden"]]),
                 lengths=np.asarray([base.LENGTH, 37], np.int32))
    cfg = JEC(talker=c["tcfg"], predictor=c["pcfg"])
    tp = dict(c["tparams"], fused_w4a8=c["jax"]["layer_w"])
    pack = {"pred_w": c["jax"]["pred_w"], "extras": c["jax"]["extras"]}
    sampler = jg.SamplerParams(temperature=jnp.float32(0.0),
                               top_k=jnp.int32(40), top_p=jnp.float32(0.9))
    want = []
    for i in range(2):
        one = _take(lanes, [i])
        ln = jnp.asarray(one["lengths"])
        state = jg.GenState(
            cache=jtr.KVCache(k=jnp.asarray(one["k"], jnp.bfloat16),
                              v=jnp.asarray(one["v"], jnp.bfloat16),
                              write_idx=jnp.asarray([START], jnp.int32),
                              lengths=ln),
            logits=jnp.asarray(one["logits"]),
            hidden=jnp.asarray(one["hidden"]), pos=ln, step=jnp.int32(0),
            done=jnp.zeros((1,), bool), key=jax.random.PRNGKey(0))
        state, codes, valid = jg._gen_frames_chunk(
            cfg, tp, pack, state, sampler, n_frames, PCAP, interpret=True)
        want.append(dict(codes=np.asarray(codes)[0],
                         valid=np.asarray(valid)[0],
                         logits=np.asarray(state.logits)[0],
                         hidden=np.asarray(state.hidden)[0],
                         k=np.asarray(state.cache.k, np.float32)[:, 0],
                         v=np.asarray(state.cache.v, np.float32)[:, 0]))
    rows = slice(START, START + n_frames)
    keep = np.ones(CAP, bool)
    keep[rows] = False
    out = {}

    # gen_chunk_plain at B = 8, lanes alternating
    idx = [i % 2 for i in range(8)]
    pr = c["port"]
    codes, lg, hd, k, v = _plain(
        (c["ttc"], c["tpc"], pr["layer_w"], pr["pred_w"], pr["extras"]),
        _take(lanes, idx), n_frames)
    k, v = k.float().numpy(), v.float().numpy()
    errs, same, other = [], True, True
    for i, j in enumerate(idx):
        w = want[j]
        same = same and np.array_equal(codes[i].numpy(), w["codes"])
        errs += [float(np.abs(lg[i].numpy() - w["logits"]).max()),
                 float(np.abs(hd[i].numpy() - w["hidden"]).max())]
        errs += [float(np.abs(a[:, i][:, :, rows] - w[n][:, :, rows]).max())
                 for a, n in ((k, "k"), (v, "v"))]
        other = other and all(
            np.array_equal(a[:, i][:, :, keep], w[n][:, :, keep])
            for a, n in ((k, "k"), (v, "v")))
    out["b8"] = dict(codes_equal=same, max_err=max(errs),
                     other_slots_equal=other)

    # the port's frame loop at B = 24 and 32: one gen_chunk_fused call
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    tcfg = EngineConfig(talker=c["ttc"], predictor=c["tpc"])
    gen = tg.Generator(tcfg, c["tp"], c["pp"], c["tpack"], fused=True,
                       chunk=True)
    calls = []
    real = tg.chunk_kernel.gen_chunk_fused

    def counted(*a, **kw):
        calls.append(int(a[6].shape[0]))
        return real(*a, **kw)

    tg.chunk_kernel.gen_chunk_fused = counted
    try:
        for b in (24, 32):
            idx = [i % 2 for i in range(b)]
            one = _take(lanes, idx)
            ln = torch.from_numpy(one["lengths"])
            state = tg.GenState(
                cache=KVCache(k=to_tensor(one["k"]).to(torch.bfloat16),
                              v=to_tensor(one["v"]).to(torch.bfloat16),
                              write_idx=torch.full((b,), START,
                                                   dtype=torch.int32),
                              lengths=ln),
                logits=torch.from_numpy(one["logits"]),
                hidden=torch.from_numpy(one["hidden"]), pos=ln, step=0,
                done=torch.zeros(b, dtype=torch.bool),
                generator=torch.Generator().manual_seed(0))
            del calls[:]
            state, codes, valid = tg.gen_frames(
                tcfg, gen.talker_params, gen.predictor_params, c["tpack"],
                state, tg.SamplerParams(*GREEDY), n_frames, PCAP)
            out[str(b)] = dict(
                codes_equal=all(np.array_equal(codes[i].numpy(),
                                               want[j]["codes"])
                                for i, j in enumerate(idx)),
                valid_equal=all(np.array_equal(valid[i].numpy(),
                                               want[j]["valid"])
                                for i, j in enumerate(idx)),
                chunk_calls=list(calls),
                write_idx=sorted(set(state.cache.write_idx.tolist())))
    finally:
        tg.chunk_kernel.gen_chunk_fused = real
    print(json.dumps(out))


@pytest.fixture(scope="module")
def jax_lanes():
    here = Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_allow_excess_precision=false "
                         "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join(
                   [str(here.parent), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c", "import test_torch_wave as t; t.wave_main()"],
        cwd=here, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_batched_plain_matches_jax_per_lane(jax_lanes):
    got = jax_lanes["b8"]
    assert got["codes_equal"] and got["other_slots_equal"], got
    assert got["max_err"] <= 1e-5, got       # test_torch_chunk_step's bound


@pytest.mark.parametrize("b", [24, 32])
def test_wide_waves_match_jax_frame_loop(jax_lanes, b):
    got = jax_lanes[str(b)]
    assert got["chunk_calls"] == [b], got    # one chunk, one batched call
    assert got["codes_equal"] and got["valid_equal"], got
    assert got["write_idx"] == [START + 4], got


# ------------------------------------------------ BatchSynthesizer
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


def test_batch_synthesizer_matches_jax(pair):
    """Exact path, greedy: 5 requests over two waves of 4 (the second
    padded with its first request), budgets mixed and defaulted."""
    je, te = pair
    budgets = (3, 8, None, 5, 7)
    out = []
    for eng, sc, req, synth in ((je, JS, JBR, JBS), (te, TS, TBR, TBS)):
        eng.set_max_steps(12)
        eng.set_sampler_config(sc(temperature=0.0, seed=5))
        voice = eng.get_speaker("vivian")
        reqs = [req(f"wave request {i}" + " more" * i, voice, max_frames=m)
                for i, m in enumerate(budgets)]
        out.append(synth(eng, batch_size=4).synthesize(reqs))
    spf = te.config.codec_decoder.samples_per_frame
    for i, (w, g) in enumerate(zip(*out)):
        assert (g.frames, g.eos) == (w.frames, w.eos), i
        assert 0 < g.frames <= (budgets[i] or 12)
        assert len(g.audio.samples) == g.frames * spf
        np.testing.assert_allclose(g.audio.samples, w.audio.samples,
                                   atol=WAV_ATOL, err_msg=str(i))


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_pad_lanes_take_the_first_requests_budget(pair, temperature,
                                                  monkeypatch):
    """Three requests at batch_size 2: the second wave is padded with a
    copy of its request and that request's budget; giving the pad lane the
    engine's max_steps (the JAX synthesizer's choice) changes no real
    lane's result."""
    _, te = pair
    te.set_max_steps(8)
    voice = te.get_speaker("vivian")
    reqs = [TBR("first request", voice, max_frames=3),
            TBR("second longer request", voice),
            TBR("third", voice, max_frames=2)]
    real = tg.Generator.run_bulk
    calls, out = [], []
    for jax_pad in (False, True):
        def run_bulk(self, state, dec_state, sampler, prompt_cap,
                     max_frames, budgets=None, uniform_cursor=True):
            budgets = budgets.clone()
            if jax_pad and len(calls) == 1:
                budgets[1:] = te.max_steps
                max_frames = int(budgets.max())
            calls.append((max_frames, budgets.tolist()))
            return real(self, state, dec_state, sampler, prompt_cap,
                        max_frames, budgets, uniform_cursor)

        monkeypatch.setattr(tg.Generator, "run_bulk", run_bulk)
        te.set_sampler_config(TS(temperature=temperature, top_k=40,
                                 top_p=0.9, seed=21))
        del calls[:]
        out.append(TBS(te, batch_size=2).synthesize(reqs))
        if not jax_pad:
            assert calls == [(8, [3, 8]), (2, [2, 2])]
    assert calls[1] == (8, [2, 8])
    spf = te.config.codec_decoder.samples_per_frame
    for r, m in zip(out[0], (3, 8, 2)):
        assert 0 < r.frames <= m and len(r.audio.samples) == r.frames * spf
    for a, b in zip(*out):
        assert (a.frames, a.eos) == (b.frames, b.eos)
        assert np.array_equal(a.audio.samples, b.audio.samples)


@pytest.fixture(scope="module")
def chunk_engine(pair):
    """fused=True, chunk=True on the CPU at the kernels' widths (two layers
    each; tests/test_torch_serving.py's config)."""
    _, te = pair
    cfg = TC.tiny().replace(
        talker=TTC(d_model=2048, n_layers=2, n_heads=2, n_kv_heads=1,
                   head_dim=128, d_ff=256, mrope_sections=(24, 20, 20, 0),
                   dtype="bfloat16"),
        predictor=TPC(d_model=1024, n_layers=2, n_heads=4, n_kv_heads=2,
                      head_dim=64, d_ff=256, dtype="bfloat16"))
    g = torch.Generator().manual_seed(0)
    return TtsEngine(model_dir=te.model_dir, config=cfg, device="cpu",
                     fused=True, chunk=True, weights=dict(
                         assets=te.assets,
                         talker=ttalk.init_talker_params(cfg.talker, g),
                         predictor=tpred.init_predictor_params(
                             cfg.predictor, g),
                         codec_decoder=te.codec_decoder_params))


def test_chunk_engine_wave_routes_through_the_kernel(chunk_engine,
                                                     monkeypatch):
    eng = chunk_engine
    calls = []
    real = tcs.gen_chunk_fused

    def counted(*a, **kw):
        calls.append(int(a[6].shape[0]))
        return real(*a, **kw)

    monkeypatch.setattr(tcs, "gen_chunk_fused", counted)
    launches = real.launches
    eng.set_max_steps(8)
    eng.set_sampler_config(TS(temperature=0.0, seed=2))
    voice = eng.get_speaker("vivian")
    r8 = TBS(eng, batch_size=8).synthesize([TBR("one request", voice)] * 8)
    assert calls == [8, 8]                   # 8 frames: two 4-frame chunks
    r1 = TBS(eng, batch_size=1).synthesize([TBR("one request", voice)])
    assert calls == [8, 8, 1, 1]
    assert real.launches == launches         # the plain version on the CPU
    spf = eng.config.codec_decoder.samples_per_frame
    assert r8[0].frames == r1[0].frames == 8
    assert len(r8[0].audio.samples) == 8 * spf
    for r in r8:
        assert (r.frames, r.eos) == (r8[0].frames, r8[0].eos)
        assert np.array_equal(r.audio.samples, r8[0].audio.samples)
    np.testing.assert_allclose(r8[0].audio.samples, r1[0].audio.samples,
                               atol=WAV_ATOL)


def test_default_engine_routes_by_measured_batch(chunk_engine, monkeypatch):
    """fused=True with chunk=None (the card's default resolution) packs the
    chunk kernel but routes only tg.CHUNK_BATCHES (one lane) through it: a
    wave of 8 takes the per-kernel step schedule (talker_step_fused every
    frame, no gen_chunk_fused), one lane the chunk kernel, one call a
    4-frame chunk; chunk=True (chunk_engine) takes every gated batch."""
    eng0 = chunk_engine
    eng = TtsEngine(model_dir=eng0.model_dir, config=eng0.config,
                    device="cpu", fused=True, weights=dict(
                        assets=eng0.assets, talker=eng0.talker_params,
                        predictor=eng0.predictor_params,
                        codec_decoder=eng0.codec_decoder_params))
    assert eng.chunk and tg.CHUNK_BATCHES == (1,)
    assert eng.generator.talker_params["chunk"]["batches"] == (1,)
    assert eng0.generator.talker_params["chunk"]["batches"] is None
    chunk_calls, step_calls = [], []
    from qwen3_tts_tpu_torch.models import transformer as ttr
    real_chunk, real_step = tcs.gen_chunk_fused, ttr.talker_step_fused

    def chunk_counted(*a, **kw):
        chunk_calls.append(int(a[6].shape[0]))
        return real_chunk(*a, **kw)

    def step_counted(*a, **kw):
        step_calls.append(1)
        return real_step(*a, **kw)

    monkeypatch.setattr(tcs, "gen_chunk_fused", chunk_counted)
    monkeypatch.setattr(ttr, "talker_step_fused", step_counted)
    eng.set_max_steps(8)
    eng.set_sampler_config(TS(temperature=0.0, seed=2))
    voice = eng.get_speaker("vivian")
    r8 = TBS(eng, batch_size=8).synthesize([TBR("one request", voice)] * 8)
    assert chunk_calls == [] and len(step_calls) >= 8
    n_step = len(step_calls)
    r1 = TBS(eng, batch_size=1).synthesize([TBR("one request", voice)])
    assert chunk_calls == [1, 1] and len(step_calls) == n_step
    spf = eng.config.codec_decoder.samples_per_frame
    for r in r8 + r1:
        assert r.frames == 8 and len(r.audio.samples) == 8 * spf
        assert np.isfinite(r.audio.samples).all()


# --------------------------------------------- gates and what is not ported
@pytest.mark.parametrize("batch,n_frames,why", [
    (2, 4, "chunk_step: batch 2 not in (1, 8, 16, 24, 32)"),
    (4, 4, "chunk_step: batch 4 not in (1, 8, 16, 24, 32)"),
    (24, 8, "chunk_step: batch 24 takes n_frames <= 4, not 8"),
    (48, 4, "chunk_step: batch 48 not in (1, 8, 16, 24, 32)")])
def test_gate_names_what_fails(batch, n_frames, why):
    t, p = TTC(), TPC()
    assert tcs.unsupported(t, p, batch, n_frames) == why
    assert not tcs.supported(t, p, batch, n_frames)
    for b, f in ((8, 8), (16, 8), (24, 4), (32, 4), (32, 1)):
        assert tcs.supported(t, p, b, f), (b, f)


@pytest.mark.parametrize("what", ["mesh", "onnx"])
def test_mesh_and_onnx_codec_are_not_ported(pair, what, tmp_path,
                                            monkeypatch):
    """`mesh` is ported now (parallel/, tests/test_torch_parallel.py): a
    wave on the single-process 1 x 1 mesh equals the mesh-less wave, codes
    and audio bit for bit.  A wave on the ONNX codec
    (onnx/qwen3_tts_decoder.onnx, the MINI fixture graph; the port's LM
    weights): each request's codes equal the native-codec wave's, and its
    audio is a decode of those codes alone within WAV_ATOL."""
    _, te = pair
    if what == "mesh":
        from qwen3_tts_tpu_torch.parallel.mesh import make_mesh
        te.set_max_steps(6)
        voice = te.get_speaker("vivian")
        waves = []
        for mesh in (None, make_mesh(1, 1, device="cpu")):
            te.set_sampler_config(TS(temperature=0.7, seed=5))
            waves.append(TBS(te, batch_size=2, mesh=mesh).synthesize(
                [TBR("wave one", voice), TBR("wave two, longer", voice),
                 TBR("a third", voice)]))
        for a, b in zip(*waves):
            assert (a.frames, a.eos) == (b.frames, b.eos)
            np.testing.assert_array_equal(a.codes, b.codes)
            np.testing.assert_array_equal(a.audio.samples, b.audio.samples)
        return
    import torch_onnx_fixtures as tfx
    (tmp_path / "onnx").mkdir()
    tfx.build_decoder(tfx.MINI, path=tmp_path / "onnx" /
                      "qwen3_tts_decoder.onnx")
    oe = TtsEngine(model_dir=tmp_path, config=TC.tiny(), device="cpu",
                   weights=dict(assets=te.assets, talker=te.talker_params,
                                predictor=te.predictor_params),
                   speakers_dir=te.model_dir / "preset_speakers")
    codes = {}
    for eng, name in ((te, "run_bulk"), (oe, "run_bulk_codes")):
        log = []
        real = getattr(eng.generator, name)

        def spy(*a, real=real, log=log, **k):
            out = real(*a, **k)
            log.append(out)
            return out

        monkeypatch.setattr(eng.generator, name, spy)
        eng.set_max_steps(8)
        eng.set_sampler_config(TS(temperature=0.0, seed=5))
        voice = eng.get_speaker("vivian")
        res = TBS(eng, batch_size=2).synthesize(
            [TBR("wave one", voice), TBR("wave two, longer", voice)])
        c, v = (log[0][2], log[0][3]) if name == "run_bulk" else log[0][1:3]
        codes[name] = [c[i][v[i]].numpy() for i in range(2)]
        assert [r.frames for r in res] == [len(x) for x in codes[name]]
    for i, r in enumerate(res):
        np.testing.assert_array_equal(codes["run_bulk_codes"][i],
                                      codes["run_bulk"][i])
        want, _ = oe.onnx_decoder.decode(codes["run_bulk"][i],
                                         oe.onnx_decoder.create_state(),
                                         is_final=True)
        np.testing.assert_allclose(r.audio.samples, want, atol=WAV_ATOL)
