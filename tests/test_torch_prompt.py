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
