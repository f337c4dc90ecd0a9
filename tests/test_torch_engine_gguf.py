"""The deployed weight path on the CPU: qwen3_tts_tpu_torch.TtsEngine
against qwen3_tts_tpu.TtsEngine, both reading one synthesized model
directory in the published layout (tests/test_engine_gguf.py's fixture at
EngineConfig.tiny(): assets, talker and predictor GGUFs; plus
codec/decoder.npz written from the JAX codec init, so that both engines
hold the same codec) with quant="q8_0": int8 device weights, a8w8 prompt
prefill, the exact decode path.

Greedy frame codes must be exactly equal, and the waveforms within 1e-4
(f32 weights and activations; the a8w8 prefill's int32 products are exact
in both, the f32 sums around them run in other orders).

The int8 weights equal, bit for bit, the JAX package's ops.quant
quantizers run op by op on the JAX loader's tensors.  The JAX engine runs
the same quantizers under jax.jit, where XLA rewrites the scale's
division by 127 as a multiplication by f32(1/127): its scales then differ
by one f32 ulp on some rows, and an integer at a rounding tie by one
(measured: 1 of 4.4 M in the codec head).  Against the JAX engine's own
weights the test therefore holds scales within one ulp and integers
within one unit on at most 1e-5 of the elements."""

import dataclasses
import os
import shutil

import numpy as np
import jax
import pytest
import torch

from qwen3_tts_tpu.core.config import SamplerConfig as JS
from qwen3_tts_tpu.models.codec import decoder as jcd
from qwen3_tts_tpu.models.codec import encoder as jenc
from qwen3_tts_tpu.models.codec import speaker as jspk
from qwen3_tts_tpu_torch.core.config import EngineConfig as TC
from qwen3_tts_tpu_torch.core.config import SamplerConfig as TS
from qwen3_tts_tpu_torch.engine import TtsEngine
from qwen3_tts_tpu_torch.ops.quant import is_quantized
from test_engine_gguf import gguf_model_dir  # noqa: F401  (fixture)
from test_torch_engine import _jax_codes

WAV_ATOL = 1e-4

torch.set_num_threads(1)


def _flatten(tree, prefix=""):
    """'a/b/0/c' npz keys of a nested dict / tuple (the JAX engine's
    _unflatten_npz inverts it)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


@pytest.fixture(scope="module")
def engines(gguf_model_dir):  # noqa: F811
    root, cfg = gguf_model_dir
    q8 = root / "gguf_q8_0"
    if not q8.exists():
        shutil.copytree(root / "gguf", q8)
    (root / "codec").mkdir(exist_ok=True)
    dec = jcd.init_decoder_params(cfg.codec_decoder, jax.random.PRNGKey(5))
    np.savez(root / "codec" / "decoder.npz", **_flatten(dec))
    # the cloning encoders too, so that the engines hold no random part
    enc = jenc.init_encoder_params(cfg.codec_encoder, jax.random.PRNGKey(6))
    np.savez(root / "codec" / "encoder.npz", **_flatten(enc))
    spk = jspk.init_speaker_params(cfg.speaker_encoder, jax.random.PRNGKey(7))
    np.savez(root / "codec" / "speaker.npz", **_flatten(spk))
    from qwen3_tts_tpu.engine import TtsEngine as JaxEngine
    old = os.environ.get("QTTS_WEIGHT_CACHE")
    os.environ["QTTS_WEIGHT_CACHE"] = "0"
    try:
        je = JaxEngine(model_dir=root, quant="q8_0", config=cfg)
    finally:
        if old is None:
            del os.environ["QTTS_WEIGHT_CACHE"]
        else:
            os.environ["QTTS_WEIGHT_CACHE"] = old
    te = TtsEngine(model_dir=root, quant="q8_0", config=TC.tiny(),
                   device="cpu", weight_cache=False)
    return je, te


def test_engine_loads_what_jax_loads(engines):
    je, te = engines
    assert te.dev_mode_components == [] and not te.fused
    for sub in ("talker", "predictor"):
        assert dataclasses.asdict(getattr(te.config, sub)) == \
            dataclasses.asdict(getattr(je.config, sub))
    assert te.assets.text_rows == je.assets.text_rows
    assert te.assets.codec_rows == je.assets.codec_rows == 3100
    for name in ("text_table", "codec_tables", "proj_w", "proj_b",
                 "tts_pad"):
        np.testing.assert_array_equal(
            getattr(te.assets, name).float().numpy(),
            np.asarray(getattr(je.assets, name), np.float32), err_msg=name)
    # projected in f32 by both, summed in other orders
    np.testing.assert_allclose(te.assets.codec_tables_1024.numpy(),
                               np.asarray(je.assets.codec_tables_1024),
                               atol=1e-6)
    from qwen3_tts_tpu.io import weights as JW
    from qwen3_tts_tpu.ops import quant as JQ
    gdir = te.model_dir / "gguf_q8_0"
    for tp, jp, head, fname, load, jcfg in (
            (te.talker_params, je.talker_params, "codec_head",
             "qwen3_tts_talker.gguf", JW.load_talker_gguf, je.config.talker),
            (te.predictor_params, je.predictor_params, "lm_head",
             "qwen3_tts_predictor.gguf", JW.load_predictor_gguf,
             je.config.predictor)):
        _, loaded = load(gdir / fname, jcfg)
        op_by_op = dict(loaded,
                        layers=JQ.quantize_decoder_layers(loaded["layers"]),
                        **{head: JQ.quantize_head(loaded[head])})
        assert is_quantized(tp[head]) and is_quantized(tp["layers"]["wo"])
        names = ("wqkv", "wo", "w_gate_up", "w_down")
        for w, want, jw in ((tp[head], op_by_op[head], jp[head]),
                            *((tp["layers"][n], op_by_op["layers"][n],
                               jp["layers"][n]) for n in names)):
            for k in ("q", "s"):
                np.testing.assert_array_equal(w[k].numpy(),
                                              np.asarray(want[k]))
            s, js = w["s"].numpy(), np.asarray(jw["s"])
            assert np.abs(s.view(np.int32) - js.view(np.int32)).max() <= 1
            dq = np.abs(w["q"].numpy().astype(np.int32)
                        - np.asarray(jw["q"]).astype(np.int32))
            assert dq.max() <= 1 and dq.sum() <= 1e-5 * dq.size
        for name in ("ln1", "ln2", "q_norm", "k_norm"):
            np.testing.assert_array_equal(tp["layers"][name].numpy(),
                                          np.asarray(jp["layers"][name]))
        np.testing.assert_array_equal(tp["final_norm"].numpy(),
                                      np.asarray(jp["final_norm"]))


@pytest.mark.parametrize("text,max_steps", [("loaded from gguf", 8),
                                            ("int8 weights", 6)])
def test_greedy_codes_and_audio_match_jax(engines, text, max_steps):
    je, te = engines
    for eng, sc in ((je, JS), (te, TS)):
        eng.set_max_steps(max_steps)
        eng.set_sampler_config(sc(temperature=0.0, seed=1))
    want_audio = je.generate_with_voice(text, je.get_speaker("vivian"))
    got_audio = te.generate_with_voice(text, te.get_speaker("vivian"))
    want_codes = _jax_codes(je, text, None, 1,
                            min(max_steps, je.config.runtime.max_steps))
    np.testing.assert_array_equal(te.last_codes, want_codes)
    spf = te.config.codec_decoder.samples_per_frame
    assert len(got_audio.samples) == len(want_codes) * spf > 0
    assert np.isfinite(got_audio.samples).all()
    np.testing.assert_allclose(got_audio.samples, want_audio.samples,
                               atol=WAV_ATOL)


def test_a8_prefill_switch(engines):
    """a8_prefill=False multiplies int8 weights in the dequant form: the
    same prompt then gives other (close) prefill logits."""
    _, te = engines
    plan = te._build_voice_prompt("switch", te.get_speaker("vivian"), None)
    g = torch.Generator().manual_seed(0)
    a8 = te.start_plans(plan, None, g)[0].logits
    te.generator.a8_prefill = False
    try:
        exact = te.start_plans(plan, None, g)[0].logits
    finally:
        te.generator.a8_prefill = True
    assert not torch.equal(a8, exact)
    assert (a8 - exact).abs().max() <= 0.05 * exact.abs().max()
