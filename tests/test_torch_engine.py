"""The whole ported slice on the CPU: qwen3_tts_tpu_torch.TtsEngine against
qwen3_tts_tpu.TtsEngine at EngineConfig.tiny() with the same weights (the
`tiny_engine` fixture's, converted through io/from_jax).

Greedy frame codes must be exactly equal.  Waveforms agree to 1e-5: f32
throughout, the two frameworks only sum in other orders (measured ~1e-6).
"""

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
    dict(int8_weights=True),
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


def test_speakers_and_unported_paths(pair):
    _, te = pair
    assert te.get_speaker("no_such_voice").name == "vivian"
    voice = te.get_speaker("vivian")
    with pytest.raises(NotImplementedError):
        next(iter(te.generate_stream("x", voice)))
    with pytest.raises(NotImplementedError):
        te.generate("x", "ref.wav", "ref")
    from qwen3_tts_tpu_torch.engine import PromptTooLongError
    with pytest.raises(PromptTooLongError):
        te.generate_with_voice("x" * 200, voice)


@pytest.mark.parametrize("flag", [["--stream"], ["--long"],
                                  ["--ref-audio", "r.wav"],
                                  ["--voice-file", "v.json"]])
def test_cli_refuses_unported_flags(flag, capsys):
    from qwen3_tts_tpu_torch.cli import main
    with pytest.raises(SystemExit) as e:
        main(["--text", "hi", "--device", "cpu", *flag])
    assert e.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


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
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
