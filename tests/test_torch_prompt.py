"""qwen3_tts_tpu_torch prompt plans and assembly against qwen3_tts_tpu:
plans exactly equal (same tokenizer fallback, same layout code), assembly
within 1e-6 (f32 gathers and sums in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.prompt import PromptBuilder as JB
from qwen3_tts_tpu.prompt import assemble as jassemble
from qwen3_tts_tpu.utils.tokenizer import Tokenizer as JT
from qwen3_tts_tpu_torch.prompt import PromptBuilder as TB
from qwen3_tts_tpu_torch.prompt import assemble as tassemble
from qwen3_tts_tpu_torch.utils.tokenizer import Tokenizer as TT

SPK = (np.random.default_rng(0).standard_normal(2048) * 0.02).astype(
    np.float32)
REF = np.random.default_rng(1).integers(0, 2048, 3 * 16)

PLANS = {
    "core": lambda B, T: B.plan_core("hello world", T, spk_emb=SPK),
    "core_instruct": lambda B, T: B.plan_core(
        "hi", T, lang_id=None, spk_emb=SPK, instruct="Speak happily"),
    "custom": lambda B, T: B.plan_custom("custom voice", T, spk_id=3065),
    "clone": lambda B, T: B.plan_clone("cloned", T, ref_codes=REF,
                                       ref_text_ids=[5, 6, 7], spk_emb=SPK),
}


def _fields(p):
    return dict(text_idx=p.text_idx, codec_idx=p.codec_idx,
                frame_slot=p.frame_slot, spk_flag=p.spk_flag,
                frames=p.frames, spk_emb=p.spk_emb)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plans_equal(name):
    jp = PLANS[name](JB, JT())
    tp = PLANS[name](TB, TT())
    assert tp.length == jp.length and tp.prefix_len == jp.prefix_len
    assert tp.text_ids == jp.text_ids
    for a, b in ((tp, jp), (tp.padded(64, 64), jp.padded(64, 64))):
        for key, val in _fields(a).items():
            np.testing.assert_array_equal(val, _fields(b)[key], err_msg=key)


@pytest.mark.parametrize("name", ["core", "clone"])
def test_assemble_matches_jax(name):
    rng = np.random.default_rng(2)
    text = rng.standard_normal((300, 2048)).astype(np.float32)
    codecs = rng.standard_normal((16, 64, 2048)).astype(np.float32)
    p = PLANS[name](JB, JT()).padded(64, 4)
    args = [p.text_idx, p.codec_idx, p.frame_slot, p.spk_flag, p.frames,
            p.spk_emb]
    length = PLANS[name](JB, JT()).length
    want = jassemble(jnp.asarray(text), jnp.asarray(codecs),
                     *map(jnp.asarray, args), jnp.int32(length))
    got = tassemble(torch.from_numpy(text), torch.from_numpy(codecs),
                    *[torch.from_numpy(np.array(a)) for a in args],
                    torch.tensor(length))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # batched form: two lanes, the second a shorter copy
    got2 = tassemble(torch.from_numpy(text), torch.from_numpy(codecs),
                     *[torch.from_numpy(np.stack([a, a])) for a in args],
                     torch.tensor([length, 5]))
    np.testing.assert_allclose(got2[0].numpy(), np.asarray(want), atol=1e-6)
    assert not got2[1, 5:].any()


# ------------------------------------------- host tables and built prompts
def _tables(seed=3, text_rows=320, codec_rows=96):
    """Seeded f32 source arrays of both packages' Assets.from_arrays."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((1024, 2048)) * 0.02).astype(np.float32),
            (rng.standard_normal(1024) * 0.02).astype(np.float32),
            rng.standard_normal((text_rows, 2048)).astype(np.float32),
            rng.standard_normal((16, codec_rows, 2048)).astype(np.float32))


@pytest.fixture(scope="module")
def assets_pair():
    from qwen3_tts_tpu.io.assets import Assets as JA
    from qwen3_tts_tpu_torch.io.assets import Assets as TA
    arrays = _tables()
    return JA.from_arrays(*arrays), TA.from_arrays(*arrays)


BUILDS = {
    "core": lambda B, T, A: B.build_core("hello world", T, A, spk_emb=SPK),
    "core_instruct": lambda B, T, A: B.build_core(
        "hi", T, A, lang_id=None, spk_emb=SPK, instruct="Speak happily"),
    "core_spk_id": lambda B, T, A: B.build_core("speaker", T, A, spk_id=40),
    "custom": lambda B, T, A: B.build_custom_prompt("custom voice", T, A,
                                                    spk_id=3065),
    "clone": lambda B, T, A: B.build_clone_prompt(
        "cloned", T, A, ref_codes=REF % 96, ref_text_ids=[5, 6, 7],
        spk_emb=SPK),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_built_prompt_bit_equal(assets_pair, name):
    """PromptData of the materialized builders: numpy f32 on both sides,
    bit-equal (same host gathers and sums in the same order)."""
    ja, ta = assets_pair
    want = BUILDS[name](JB, JT(), ja)
    got = BUILDS[name](TB, TT(), ta)
    assert got.embd.dtype == np.float32 and got.embd.shape == want.embd.shape
    np.testing.assert_array_equal(got.embd, want.embd)
    assert got.text_ids == want.text_ids
    np.testing.assert_array_equal(got.spk_emb, want.spk_emb)
    assert np.abs(got.embd).max() > 0
    with pytest.raises(ValueError, match="build_clone_prompt"):
        TB.build_core("x", TT(), ta, mid_embeds=np.zeros((1, 2048)))


def test_host_and_device_lookups_match_jax(assets_pair):
    ja, ta = assets_pair
    ids = np.array([0, 5, 319, 320, 151671, 7])          # folded mod rows
    codes = np.array([[-1, 0, 95, 96, 2148, 3]])          # zeros off range
    frames = np.stack([np.arange(16) * 6, np.full(16, 200),
                       np.r_[np.full(8, -1), np.arange(8)]])
    for a, b in ((ta.text_emb_np(ids), ja.text_emb_np(ids)),
                 (ta.codec_emb_np(2, codes), ja.codec_emb_np(2, codes)),
                 (ta.frame_emb_sum_np(frames), ja.frame_emb_sum_np(frames))):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert ta.codec_emb_np(0, codes)[0, 3:5].max() == 0.0
    np.testing.assert_array_equal(ta.text_emb(ids).numpy(),
                                  np.asarray(ja.text_emb(ids)))
    np.testing.assert_array_equal(ta.codec_emb(2, codes).numpy(),
                                  np.asarray(ja.codec_emb(2, codes)))
    np.testing.assert_allclose(ta.frame_emb_sum(frames).numpy(),
                               np.asarray(ja.frame_emb_sum(frames)),
                               atol=1e-5)
    h = np.random.default_rng(4).standard_normal((3, 2048)).astype(
        np.float32)
    np.testing.assert_allclose(ta.project(h).numpy(),
                               np.asarray(ja.project(h)), atol=1e-5)
    # no mirror kept (tables handed in as tensors): made from the device
    from qwen3_tts_tpu_torch.io.assets import Assets as TA
    tb = TA.from_arrays(*[torch.from_numpy(a) for a in _tables()])
    assert tb._host_text is None
    np.testing.assert_array_equal(tb.text_emb_np(ids), ja.text_emb_np(ids))


def test_assets_from_npy_and_load(tmp_path):
    """The legacy NPY layout: Assets.from_npy and Assets.load equal to the
    JAX package's, the GGUF first where both exist, the JAX error text
    with neither; TtsEngine reads the NPY assets of its weights dir."""
    from qwen3_tts_tpu.io.assets import Assets as JA
    from qwen3_tts_tpu_torch.io.assets import Assets as TA
    proj_w, proj_b, text, codecs = _tables(seed=5, text_rows=64,
                                           codec_rows=32)
    d = tmp_path / "gguf"
    d.mkdir()
    np.save(d / "proj_weight.npy", proj_w)
    np.save(d / "proj_bias.npy", proj_b)
    np.save(d / "text_embedding_projected.npy", text)
    for i in range(16):
        np.save(d / f"codec_embedding_{i}.npy", codecs[i])
    want = JA.from_npy(d)
    for got in (TA.from_npy(d), TA.load(d)):
        for key in ("text_table", "codec_tables", "proj_w", "proj_b",
                    "tts_pad"):
            np.testing.assert_array_equal(getattr(got, key).numpy(),
                                          np.asarray(getattr(want, key)))
        np.testing.assert_allclose(got.codec_tables_1024.numpy(),
                                   np.asarray(want.codec_tables_1024),
                                   atol=1e-5)
        np.testing.assert_array_equal(got.host_tables()[1], codecs)
    for A in (TA, JA):
        with pytest.raises(FileNotFoundError,
                           match="no qwen3_assets.gguf or proj_weight.npy"):
            A.load(tmp_path / "empty")
    from qwen3_tts_tpu_torch import TtsEngine
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    eng = TtsEngine(tmp_path, config=EngineConfig.tiny(), device="cpu",
                    speakers_dir="speakers")
    assert "assets" not in eng.dev_mode_components
    np.testing.assert_array_equal(eng.assets.text_table.numpy(), text)
