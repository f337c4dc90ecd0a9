"""qwen3_tts_tpu_torch.models against qwen3_tts_tpu.models on the same
weights (JAX inits, converted through io/from_jax) and the same seeded
numpy inputs, at the tiny configs (f32).

Tolerances: hidden states, caches and logits atol 1e-4 (f32, other
summation orders through two layers); predictor codes exactly equal; the
codec: chunked == full inside the port to 1e-6, port == JAX to 1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.core.config import (CodecDecoderConfig, PredictorConfig,
                                       TalkerConfig)
from qwen3_tts_tpu.models import predictor as jpred
from qwen3_tts_tpu.models import talker as jtalk
from qwen3_tts_tpu.models import transformer as jtr
from qwen3_tts_tpu.models.codec import decoder as jcd
from qwen3_tts_tpu_torch.io.from_jax import tree_to_torch
from qwen3_tts_tpu_torch.models import predictor as tpred
from qwen3_tts_tpu_torch.models import talker as ttalk
from qwen3_tts_tpu_torch.models import transformer as ttr
from qwen3_tts_tpu_torch.models.codec import decoder as tcd

ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=1e-4)


@pytest.fixture(scope="module")
def talker():
    cfg = TalkerConfig.tiny()
    jp = jtalk.init_talker_params(cfg, jax.random.PRNGKey(3))
    return cfg, jp, tree_to_torch(_np(jp))


def test_decoder_forward_prefill_then_decode(talker):
    cfg, jp, tp = talker
    b, s, cap, prompt_cap = 2, 8, 32, 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    lengths = np.asarray([8, 5], np.int32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    pos4 = np.stack([pos, pos, pos, np.zeros_like(pos)], -1)
    jcos, jsin = jtalk._rope_tables(cfg, jnp.asarray(pos4))
    jc = jtr.init_kv_cache(cfg, b, cap, jnp.float32).replace(
        lengths=jnp.asarray(lengths))
    jh, jc = jtr.decoder_forward(cfg, jp, jnp.asarray(x), jcos, jsin, jc,
                                 prompt_cap=prompt_cap)
    tc = ttr.init_kv_cache(cfg, b, cap, torch.float32, "cpu")
    tc.lengths = torch.from_numpy(lengths)
    tcos, tsin = ttalk._rope_tables(cfg, torch.from_numpy(pos4))
    th, tc = ttr.decoder_forward(cfg, tp, torch.from_numpy(x), tcos, tsin,
                                 tc, prompt_cap=prompt_cap)
    _close(th, jh)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    assert tc.write_idx.tolist() == np.asarray(jc.write_idx).tolist()

    # one decode step at the cursor (slot 8), position = length
    x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    p = lengths[:, None]
    p4 = np.stack([p, p, p, np.zeros_like(p)], -1)
    jcos, jsin = jtalk._rope_tables(cfg, jnp.asarray(p4))
    jh, jc = jtr.decoder_forward(cfg, jp, jnp.asarray(x1), jcos, jsin, jc,
                                 prompt_cap=prompt_cap)
    tcos, tsin = ttalk._rope_tables(cfg, torch.from_numpy(p4))
    th, tc = ttr.decoder_forward(cfg, tp, torch.from_numpy(x1), tcos, tsin,
                                 tc, prompt_cap=prompt_cap)
    _close(th, jh)
    _close(tc.k, jc.k)


def test_talker_logits_prefill_and_step(talker):
    cfg, jp, tp = talker
    b, s = 2, 16
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32) * 0.1
    lengths = np.asarray([16, 11], np.int32)
    jc = jtalk.init_talker_cache(cfg, b, 64)
    jl, jh, jc = jtalk.talker_prefill(cfg, jp, jnp.asarray(emb),
                                      jnp.asarray(lengths), jc)
    tc = ttalk.init_talker_cache(cfg, b, 64, "cpu")
    tl, th, tc = ttalk.talker_prefill(cfg, tp, torch.from_numpy(emb),
                                      torch.from_numpy(lengths), tc)
    assert tl.shape == (b, cfg.n_codec_logits) and tl.dtype == torch.float32
    _close(tl, jl)
    _close(th, jh)
    fb = rng.standard_normal((b, cfg.d_model)).astype(np.float32) * 0.1
    jl, jh, jc = jtalk.talker_decode_step(cfg, jp, jnp.asarray(fb),
                                          jnp.asarray(lengths), jc,
                                          prompt_cap=s)
    tl, th, tc = ttalk.talker_decode_step(cfg, tp, torch.from_numpy(fb),
                                          torch.from_numpy(lengths), tc,
                                          prompt_cap=s)
    _close(tl, jl)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jl, -1)))


def test_predict_frame_codes_equal():
    cfg = PredictorConfig.tiny()
    jp = jpred.init_predictor_params(cfg, jax.random.PRNGKey(4))
    tp = tree_to_torch(_np(jp))
    rng = np.random.default_rng(2)
    b = 3
    h1024 = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
    code0 = rng.integers(0, 2048, b).astype(np.int32)
    tables = (rng.standard_normal((16, 2048, cfg.d_model)) * 0.5
              ).astype(np.float32)
    want = jpred.predict_frame(cfg, jp, jnp.asarray(h1024),
                               jnp.asarray(code0), jnp.asarray(tables))
    got = tpred.predict_frame(cfg, tp, torch.from_numpy(h1024),
                              torch.from_numpy(code0),
                              torch.from_numpy(tables))
    assert got.dtype == torch.int32 and got.shape == (b, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mult", [1, 2])
def test_codec_chunked_equals_full_and_jax(mult):
    cfg = dataclasses.replace(CodecDecoderConfig.tiny(),
                              upsample_kernel_mult=mult)
    jp = jcd.init_decoder_params(cfg, jax.random.PRNGKey(5))
    tp = tree_to_torch(_np(jp))
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 2048, (2, 12, 16)).astype(np.int32)
    spf = cfg.samples_per_frame

    full, _ = tcd.decode_chunk(cfg, tp, torch.from_numpy(codes),
                               tcd.init_decoder_state(cfg, 2, "cpu"))
    st = tcd.init_decoder_state(cfg, 2, "cpu")
    parts = []
    for a, e in ((0, 4), (4, 5), (5, 12)):     # ring of 8 wraps
        w, st = tcd.decode_chunk(cfg, tp, torch.from_numpy(codes[:, a:e]),
                                 st)
        assert w.shape == (2, (e - a) * spf)
        parts.append(w)
    assert st.count.tolist() == [12, 12]
    _close(torch.cat(parts, 1), full.numpy(), 1e-6)

    want = jcd.decode_full(cfg, jp, jnp.asarray(codes))
    _close(full, want)


def test_assets_from_arrays_matches_jax():
    from qwen3_tts_tpu.io.assets import Assets as JA
    from qwen3_tts_tpu_torch.io.assets import Assets as TA
    rng = np.random.default_rng(4)
    proj_w = rng.standard_normal((1024, 2048)).astype(np.float32) * 0.02
    proj_b = rng.standard_normal(1024).astype(np.float32) * 0.02
    text = rng.standard_normal((300, 2048)).astype(np.float32)
    codecs = rng.standard_normal((16, 8, 2048)).astype(np.float32)
    ja = JA.from_arrays(proj_w, proj_b, text, codecs)
    ta = TA.from_arrays(proj_w, proj_b, text, codecs)
    assert (ta.text_rows, ta.codec_rows) == (ja.text_rows, ja.codec_rows)
    for key, val in ta.pack().items():
        _close(val, ja.pack()[key])
    _close(ta.text_table, ja.text_table)
