"""The whole ported slice on the CPU: qwen3_tts_tpu_torch.TtsEngine against
qwen3_tts_tpu.TtsEngine at EngineConfig.tiny() with the same weights (the
`tiny_engine` fixture's, converted through io/from_jax).

Greedy frame codes must be exactly equal.  Waveforms agree to 1e-5: f32
throughout, the two frameworks only sum in other orders (measured ~1e-6).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from qwen3_tts_tpu.core.config import SamplerConfig as JS
from qwen3_tts_tpu.models.codec import decoder as jcd
from qwen3_tts_tpu.runtime.generate import SamplerParams
from qwen3_tts_tpu_torch.core.config import EngineConfig as TC
from qwen3_tts_tpu_torch.core.config import SamplerConfig as TS
from qwen3_tts_tpu_torch.engine import TtsEngine
from qwen3_tts_tpu_torch.io.from_jax import engine_weights
from qwen3_tts_tpu_torch.models.codec import decoder as tcd
from qwen3_tts_tpu_torch.runtime.generate import SamplerParams as TSP

WAV_ATOL = 1e-5


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
    saved = (je.max_steps, je.sampler_config, je.config, je.generator)
    yield je, te
    je.max_steps, je.sampler_config, je.config, je.generator = saved


def _jax_codes(je, text, instruct, seed, max_frames):
    """The JAX engine's _run_inference up to its codes."""
    plan = je._build_voice_prompt(text, je.get_speaker("vivian"), instruct)
    state, bucket = je._start_state(plan, jax.random.PRNGKey(seed))
    dec = jcd.init_decoder_state(je.config.codec_decoder,
                                 je.codec_decoder_params, batch=1)
    out = je.generator.run_bulk(state, dec,
                                SamplerParams.make(je.sampler_config),
                                prompt_cap=bucket, max_frames=max_frames)
    n = int(np.asarray(out[3][0]).sum())
    return np.asarray(out[2][0, :n])


@pytest.mark.parametrize("text,instruct,max_steps", [
    ("hello world", None, 12),
    ("a longer sentence for the next prompt bucket", "Calm", 16),
    ("six", None, 6),                       # budget inside a chunk
])
def test_greedy_slice_matches_jax(pair, text, instruct, max_steps):
    je, te = pair
    for eng, sc in ((je, JS), (te, TS)):
        eng.set_max_steps(max_steps)
        eng.set_sampler_config(sc(temperature=0.0, seed=3))
    want_audio = je.generate_with_voice(text, je.get_speaker("vivian"),
                                        instruct)
    got_audio = te.generate_with_voice(text, te.get_speaker("vivian"),
                                       instruct)
    want_codes = _jax_codes(je, text, instruct, 3,
                            min(max_steps, je.config.runtime.max_steps))
    np.testing.assert_array_equal(te.last_codes, want_codes)
    spf = te.config.codec_decoder.samples_per_frame
    assert te.last_metrics.frames == len(want_codes) <= max_steps
    assert len(got_audio.samples) == len(want_codes) * spf
    assert got_audio.sample_rate == 24000 and got_audio.channels == 1
    np.testing.assert_allclose(got_audio.samples, want_audio.samples,
                               atol=WAV_ATOL)
    assert te.last_metrics.eos == je.last_metrics.eos


def test_sampled_generation_is_seeded(pair):
    _, te = pair
    te.set_max_steps(8)
    voice = te.get_speaker("vivian")
    te.set_sampler_config(TS(temperature=0.9, top_k=40, top_p=0.9, seed=11))
    a = te.generate_with_voice("sampled", voice)
    codes_a = te.last_codes
    te.set_sampler_config(TS(temperature=0.9, top_k=40, top_p=0.9, seed=11))
    b = te.generate_with_voice("sampled", voice)
    np.testing.assert_array_equal(codes_a, te.last_codes)
    np.testing.assert_array_equal(a.samples, b.samples)
    assert np.isfinite(a.samples).all()
    assert (codes_a[:, 0] < 2160).all() and (codes_a[:, 1:] < 2048).all()


def test_per_lane_budgets_match_jax(pair):
    """Two lanes with their own frame budgets through Generator.run_bulk:
    codes, valid mask, frames run and saw_eos equal the JAX package's."""
    je, te = pair
    texts, budgets, max_frames = ("two lanes", "the second lane"), [3, 8], 8
    for eng, sc in ((je, JS), (te, TS)):
        eng.set_max_steps(16)
        eng.set_sampler_config(sc(temperature=0.0, seed=5))
    jplans = [je._build_voice_prompt(t, je.get_speaker("vivian"), None)
              for t in texts]
    state, _, bucket = je.start_plans(jplans, None, jax.random.PRNGKey(5))
    dec = jcd.init_decoder_state(je.config.codec_decoder,
                                 je.codec_decoder_params, batch=2)
    want = je.generator.run_bulk(state, dec,
                                 SamplerParams.make(je.sampler_config),
                                 prompt_cap=bucket, max_frames=max_frames,
                                 budgets=budgets)
    tplans = [te._build_voice_prompt(t, te.get_speaker("vivian"), None)
              for t in texts]
    with torch.no_grad():
        tstate, tbucket = te._start_state(tplans,
                                          torch.Generator().manual_seed(5))
        got = te.generator.run_bulk(
            tstate, tcd.init_decoder_state(te.config.codec_decoder, 2, "cpu"),
            TSP.make(te.sampler_config), prompt_cap=tbucket,
            max_frames=max_frames, budgets=budgets)
    assert tbucket == bucket
    valid = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), valid)
    assert valid.sum(1).tolist() == budgets
    np.testing.assert_array_equal(got[2].numpy()[valid],
                                  np.asarray(want[2])[valid])
    assert got[5] == int(want[5])
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))


@pytest.mark.parametrize("field", [
    dict(talker=dict(flash_decode=False)),
    dict(predictor=dict(flash_decode=True)),
    dict(runtime=dict(mesh_shape=(2,))),
    dict(talker=dict(layer_scan_unroll=2)),
])
def test_engine_refuses_fields_it_ignores(field):
    import dataclasses
    cfg = TC.tiny()
    kw = {k: dataclasses.replace(getattr(cfg, k), **v)
          if isinstance(v, dict) else v for k, v in field.items()}
    with pytest.raises(ValueError, match="does not read"):
        TtsEngine(config=cfg.replace(**kw), device="cpu")


def test_buckets_and_plan_arrays_match_jax(pair):
    je, te = pair
    for s in (1, 31, 32, 33, 64, 65, 500):
        assert te._bucket(s) == je._bucket(s)
    plans = [te._build_voice_prompt(t, te.get_speaker("vivian"), None)
             for t in ("one", "a little longer text")]
    jplans = [je._build_voice_prompt(t, je.get_speaker("vivian"), None)
              for t in ("one", "a little longer text")]
    ta, tl, tb = te._plans_to_arrays(plans)
    ja, jl, jb = je._plans_to_arrays(jplans)
    assert tb == jb
    np.testing.assert_array_equal(tl, jl)
    for key in ja:
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)


def test_speakers_and_unported_paths(pair, tmp_path):
    _, te = pair
    assert te.get_speaker("no_such_voice").name == "vivian"
    voice = te.get_speaker("vivian")
    te.set_max_steps(2)
    assert next(iter(te.generate_stream("x", voice))).dtype == np.float32
    # cloning from reference audio is ported (tests/test_torch_clone.py)
    from qwen3_tts_tpu_torch.io.audio import AudioSample
    ref = tmp_path / "ref.wav"
    AudioSample(samples=np.full(20, 0.1, np.float32)).save_wav(ref)
    audio = te.generate("x", ref, "ref")
    assert np.isfinite(audio.samples).all() and audio.sample_rate == 24000
    assert ref.with_suffix(".cache").exists()
    from qwen3_tts_tpu_torch.engine import PromptTooLongError
    with pytest.raises(PromptTooLongError):
        te.generate_with_voice("x" * 200, voice)


def test_imports_without_jax():
    """The port imports with jax, flax and the JAX package blocked."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'qwen3_tts_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib, qwen3_tts_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax') and sys.modules[k]"
        " for k in sys.modules)\n"
        "assert 'qwen3_tts_tpu_torch.kernels.chunk_step' in sys.modules\n"
        "assert 'qwen3_tts_tpu_torch.serve.continuous' in sys.modules\n"
        "assert 'qwen3_tts_tpu_torch.serve.codec_path' in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ------------------------------------------------ the fused decode path
# (d) The port's gen_frames on the fused path (Generator(fused=True): the
# plain versions of kernels/talker_step and kernels/predictor_frame on the
# CPU) against a JAX frame loop built here from the JAX package's Pallas
# kernels in interpret mode (generate.py's frame: greedy code_0,
# 2048->1024 projection, predict_frame_fused, feedback sum,
# talker_step_fused with weights="w4a8" and its cache write, final norm,
# codec head), at tests/test_chunk_kernel.py's config, three greedy frames.
# Under XLA's default --xla_allow_excess_precision=true the interpret-mode
# talker kernel skips some of its bf16 roundings (about 3 % of the hidden
# state, tests/test_torch_talker_step.py), enough to flip a greedy near-tie
# within three frames.  The comparison therefore runs in a process with
# that flag off, where every code of the three frames must be equal and the
# codec logits agree to FRAME_LOGIT_ATOL (f32 summation order of the final
# norm and the codec head: measured 5e-7 on logits of magnitude ~3).
FUSED_TALKER = dict(d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
                    head_dim=128, d_ff=256, mrope_sections=(24, 20, 20, 0),
                    dtype="bfloat16")
FUSED_PRED = dict(d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                  head_dim=64, d_ff=256, dtype="bfloat16")
PCAP, CAP, START, LENGTH = 512, 1024, 517, 100
FRAME_LOGIT_ATOL = 1e-5


def _fused_case():
    import jax.numpy as jnp
    from qwen3_tts_tpu.core.config import PredictorConfig as JPC
    from qwen3_tts_tpu.core.config import TalkerConfig as JTC
    from qwen3_tts_tpu.models import predictor as jpred
    from qwen3_tts_tpu.models import transformer as jtr
    tcfg, pcfg = JTC(**FUSED_TALKER), JPC(**FUSED_PRED)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tparams = jtr.init_decoder_params(tcfg, k1)
    tparams["codec_head"] = (jax.random.normal(
        jax.random.fold_in(k1, 7), (tcfg.n_codec_logits, tcfg.d_model))
        * 0.05).astype(jnp.bfloat16)
    pparams = jpred.init_predictor_params(pcfg, k2)
    rng = np.random.default_rng(3)
    pack = {
        "proj_w": rng.standard_normal((256, 256)) * 0.05,
        "proj_b": rng.standard_normal(256) * 0.01,
        "tts_pad": rng.standard_normal(256) * 0.02,
        "codec_tables": rng.standard_normal((16, 2160, 256)) * 0.02,
        "codec_tables_1024": rng.standard_normal((16, 2048, 256)) * 0.02}
    pack = {k: v.astype(np.float32) for k, v in pack.items()}
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
        jnp.float32))
    shape = (2, 1, 1, CAP, 128)
    state = dict(k=bf(rng.standard_normal(shape) * 0.3),
                 v=bf(rng.standard_normal(shape) * 0.3),
                 logits=rng.standard_normal((1, 2160)).astype(np.float32),
                 hidden=(rng.standard_normal((1, 256)) * 0.3).astype(
                     np.float32))
    return tcfg, pcfg, tparams, pparams, pack, state


def _jax_frames(case, n):
    import jax.numpy as jnp
    from qwen3_tts_tpu.kernels import predictor_frame as jpf
    from qwen3_tts_tpu.kernels import talker_step as jts
    from qwen3_tts_tpu.models import talker as jtalk
    from qwen3_tts_tpu.ops.norms import rms_norm as jrms
    from qwen3_tts_tpu.ops.rope import (inv_frequencies, mrope_cos_sin,
                                        section_ids)
    from qwen3_tts_tpu.ops.sampling import sample_logits as jsample
    from qwen3_tts_tpu.runtime.generate import _frame_emb_sum as jemb
    tcfg, pcfg, tparams, pparams, pack, st = case
    inv = jnp.asarray(inv_frequencies(tcfg.head_dim, tcfg.rope_theta))
    sec = jnp.asarray(section_ids(tcfg.mrope_sections))
    k, v = jnp.asarray(st["k"], jnp.bfloat16), jnp.asarray(st["v"],
                                                          jnp.bfloat16)
    logits, hidden = jnp.asarray(st["logits"]), jnp.asarray(st["hidden"])
    lengths = jnp.asarray([LENGTH], jnp.int32)
    out = []
    for f in range(n):
        code0 = jsample(logits, jax.random.PRNGKey(0), 0.0, 40, 0.9)
        h1024 = hidden @ jnp.asarray(pack["proj_w"]).T + pack["proj_b"]
        codes = jpf.predict_frame_fused(
            pcfg, pparams, h1024, code0, jnp.asarray(
                pack["codec_tables_1024"]), interpret=True)
        feedback = jemb(jnp.asarray(pack["codec_tables"]), codes) \
            + pack["tts_pad"]
        p = jnp.full((1, 1), LENGTH + f, jnp.int32)
        cos, sin = mrope_cos_sin(
            jnp.stack([p, p, p, jnp.zeros_like(p)], -1), inv, sec)
        h1, k, v = jts.talker_step_fused(
            tcfg, tparams, feedback.astype(jnp.bfloat16), cos[:, 0],
            sin[:, 0], k, v, lengths, jnp.int32(START + f), PCAP,
            interpret=True, weights="w4a8")
        hidden = jrms(h1[:, None, :], tparams["final_norm"],
                      tcfg.rms_eps)[:, 0]
        logits = jtalk._codec_logits(tparams, hidden)
        out.append((np.asarray(codes)[0], np.asarray(logits)[0]))
    return out


def _port_frames(case, n):
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    from qwen3_tts_tpu_torch.core.config import PredictorConfig as TPC
    from qwen3_tts_tpu_torch.core.config import TalkerConfig as TTC
    from qwen3_tts_tpu_torch.io.from_jax import to_tensor, tree_to_torch
    from qwen3_tts_tpu_torch.models.transformer import KVCache
    from qwen3_tts_tpu_torch.runtime import generate as tg
    _, _, tparams, pparams, pack, st = case
    cfg = EngineConfig(talker=TTC(**FUSED_TALKER),
                       predictor=TPC(**FUSED_PRED))
    pack_t = {k: to_tensor(v) for k, v in pack.items()}
    gen = tg.Generator(cfg, tree_to_torch(_np(tparams)),
                       tree_to_torch(_np(pparams)), pack_t, fused=True)
    i32 = lambda x: torch.tensor([x], dtype=torch.int32)
    state = tg.GenState(
        cache=KVCache(k=to_tensor(st["k"]).to(torch.bfloat16),
                      v=to_tensor(st["v"]).to(torch.bfloat16),
                      write_idx=i32(START), lengths=i32(LENGTH)),
        logits=to_tensor(st["logits"]), hidden=to_tensor(st["hidden"]),
        pos=i32(LENGTH), step=0, done=torch.zeros(1, dtype=torch.bool),
        generator=torch.Generator().manual_seed(0))
    out = []
    for _ in range(n):
        state, codes, valid = tg.gen_frames(
            cfg, gen.talker_params, gen.predictor_params, pack_t, state,
            tg.SamplerParams(0.0, 40, 0.9), 1, PCAP)
        assert bool(valid.all())
        out.append((codes[0, 0].numpy(), state.logits[0].numpy()))
    assert int(state.cache.write_idx[0]) == START + n
    return out


def fused_frames_main():
    """Run by test_fused_gen_frames_match_jax_frame_loop in a process
    whose XLA flags turn excess precision off."""
    jax.config.update("jax_platforms", "cpu")
    case = _fused_case()
    for f, ((jc, jl), (tc, tl)) in enumerate(zip(_jax_frames(case, 3),
                                                 _port_frames(case, 3))):
        np.testing.assert_array_equal(tc, jc, err_msg=f"frame {f}")
        np.testing.assert_allclose(tl, jl, atol=FRAME_LOGIT_ATOL, rtol=0,
                                   err_msg=f"frame {f}")
    print("frames equal")


def test_fused_gen_frames_match_jax_frame_loop():
    here = Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [str(here.parent), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c", "import test_torch_engine as t; "
         "t.fused_frames_main()"], cwd=here, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("frames equal")


# (e) The engine on the fused path at a config the kernels take (talker
# and predictor widths protocol-fixed at 2048 / 1024, two layers each,
# tests/test_chunk_kernel.py's head layout), on the CPU.
def _fused_engine_config():
    from qwen3_tts_tpu_torch.core.config import PredictorConfig as TPC
    from qwen3_tts_tpu_torch.core.config import TalkerConfig as TTC
    return TC.tiny().replace(
        talker=TTC(**dict(FUSED_TALKER, d_model=2048)),
        predictor=TPC(**dict(FUSED_PRED, d_model=1024)))


def test_fused_engine_serves_on_cpu(pair):
    from qwen3_tts_tpu_torch.kernels import predictor_frame as tpf
    from qwen3_tts_tpu_torch.kernels import talker_step as tts
    from qwen3_tts_tpu_torch.models import predictor as tpred
    from qwen3_tts_tpu_torch.models import talker as ttalk
    je, te = pair
    assert te.fused is False                 # fused=None on the CPU: exact
    cfg = _fused_engine_config()
    g = torch.Generator().manual_seed(0)
    eng = TtsEngine(model_dir=je.model_dir, config=cfg, device="cpu",
                    fused=True, chunk=False, weights=dict(
                        assets=te.assets,
                        talker=ttalk.init_talker_params(cfg.talker, g),
                        predictor=tpred.init_predictor_params(
                            cfg.predictor, g),
                        codec_decoder=te.codec_decoder_params))
    assert eng.fused and "fused_w4a8" in eng.generator.talker_params
    assert not eng.chunk and "chunk" not in eng.generator.talker_params
    before = (tts.talker_step_fused.launches,
              tpf.predict_frame_fused.launches)
    eng.set_max_steps(6)
    eng.set_sampler_config(TS(temperature=0.0, seed=1))
    voice = eng.get_speaker("vivian")
    audio = eng.generate_with_voice("fused path", voice)
    codes = eng.last_codes
    n = eng.last_metrics.frames
    assert 0 < n <= 6 and codes.shape == (n, 16)
    assert len(audio.samples) == n * cfg.codec_decoder.samples_per_frame
    assert np.isfinite(audio.samples).all()
    assert (codes[:, 0] < 2160).all() and (codes[:, 1:] < 2048).all()
    eng.generate_with_voice("fused path", voice)
    np.testing.assert_array_equal(eng.last_codes, codes)
    assert (tts.talker_step_fused.launches,
            tpf.predict_frame_fused.launches) == before    # plain on CPU


def test_fused_engine_refuses_configs_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="talker_step: head_dim 16 != 128"):
        TtsEngine(config=TC.tiny(), device="cpu", fused=True)


# (f) The chunk path (TtsEngine(fused=True, chunk=True): the plain version
# of kernels/chunk_step on the CPU) at the same config.
def test_chunk_engine_serves_on_cpu(pair):
    from qwen3_tts_tpu_torch.kernels import chunk_step as tcs
    from qwen3_tts_tpu_torch.kernels import predictor_frame as tpf
    from qwen3_tts_tpu_torch.kernels import talker_step as tts
    from qwen3_tts_tpu_torch.models import predictor as tpred
    from qwen3_tts_tpu_torch.models import talker as ttalk
    je, te = pair
    assert (te.fused, te.chunk) == (False, False)   # defaults on the CPU
    cfg = _fused_engine_config()
    g = torch.Generator().manual_seed(0)
    eng = TtsEngine(model_dir=je.model_dir, config=cfg, device="cpu",
                    fused=True, chunk=True, weights=dict(
                        assets=te.assets,
                        talker=ttalk.init_talker_params(cfg.talker, g),
                        predictor=tpred.init_predictor_params(
                            cfg.predictor, g),
                        codec_decoder=te.codec_decoder_params))
    assert eng.chunk and "chunk" in eng.generator.talker_params
    counters = (tcs.gen_chunk_fused, tts.talker_step_fused,
                tpf.predict_frame_fused)
    before = [f.launches for f in counters]
    eng.set_max_steps(6)
    eng.set_sampler_config(TS(temperature=0.0, seed=1))
    voice = eng.get_speaker("vivian")
    audio = eng.generate_with_voice("chunk path", voice)
    codes = eng.last_codes
    n = eng.last_metrics.frames
    assert 0 < n <= 6 and codes.shape == (n, 16)
    assert len(audio.samples) == n * cfg.codec_decoder.samples_per_frame
    assert np.isfinite(audio.samples).all()
    assert (codes[:, 0] < 2160).all() and (codes[:, 1:] < 2048).all()
    eng.generate_with_voice("chunk path", voice)
    np.testing.assert_array_equal(eng.last_codes, codes)
    assert [f.launches for f in counters] == before        # plain on CPU


def test_chunk_path_resolution_and_refusals():
    import dataclasses
    with pytest.raises(ValueError, match="chunk decode path: needs fused"):
        TtsEngine(config=_fused_engine_config(), device="cpu", fused=False,
                  chunk=True)
    cfg = _fused_engine_config()
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                  frames_per_chunk=9))
    with pytest.raises(ValueError,
                       match="chunk_step: n_frames 9 outside"):
        TtsEngine(config=cfg, device="cpu", fused=True, chunk=True)
