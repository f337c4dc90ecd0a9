"""The port's chunk module (qwen3_tts_tpu_torch/kernels/chunk_step.py) on the
CPU: its prep, its sampler and its plain version against the JAX package's
Pallas kernel (qwen3_tts_tpu/kernels/chunk_step.py) run in interpret mode,
as tests/test_chunk_kernel.py runs it, at that file's config, on the same
seeded numpy inputs and the same bf16 parameters.

- prep: the port's integers, scales and extras equal the JAX prep's after
  io/from_jax.chunk_pack_from_jax, exactly (the predictor's scales f32);
- sampler: greedy is the argmax with the lowest index on ties; sampled,
  the same 4000 uniforms give the same codes on >= 99 % of draws (the f32
  sums run in another order), inside the top-k/top-p support, with the
  empirical distribution within 0.05 of the reference one;
- the chunk: with XLA's --xla_allow_excess_precision off (a subprocess:
  XLA reads its flags once per process) the plain version gives every code
  of four greedy frames, logits and hidden within EXACT_ATOL, and the
  written k/v rows within the same bound, every other cache slot bit-equal;
  the whole slice (Generator(fused=True, chunk=True) through gen_frames,
  two chunks of four frames) gives the codes and valid flags of the JAX
  package's _gen_frames_chunk called twice.  Under the default flags the
  interpret-mode kernel skips some bf16 roundings (see
  tests/test_torch_talker_step.py), so test_chunk_kernel.py's policy holds:
  frame 0's code_0 exact, codes equal until a flip where the top-2 gap is
  below GAP, logits within LOGIT_TOL + 5 % while no code flipped, and the
  predictor's window logits within that band until a code differs.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.core.config import PredictorConfig as JPC
from qwen3_tts_tpu.core.config import TalkerConfig as JTC
from qwen3_tts_tpu.kernels import chunk_step as jcs
from qwen3_tts_tpu.kernels.talker_step import prep_layer_weights as jprep
from qwen3_tts_tpu.models import predictor as jpred
from qwen3_tts_tpu.models import transformer as jtr
from qwen3_tts_tpu_torch.core.config import PredictorConfig as TPC
from qwen3_tts_tpu_torch.core.config import TalkerConfig as TTC
from qwen3_tts_tpu_torch.io.from_jax import (chunk_pack_from_jax, to_tensor,
                                             tree_to_torch)
from qwen3_tts_tpu_torch.kernels import chunk_step as tcs
from qwen3_tts_tpu_torch.kernels import talker_step as tts
from qwen3_tts_tpu_torch.models import talker as ttalk
from qwen3_tts_tpu_torch.ops.sampling import sample_threshold

# tests/test_chunk_kernel.py's config and cache layout
TALKER = dict(d_model=256, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=128,
              d_ff=256, mrope_sections=(24, 20, 20, 0), dtype="bfloat16")
PRED = dict(d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
            d_ff=256, dtype="bfloat16")
PCAP, CAP, START, LENGTH = 512, 1024, 517, 100
LOGIT_TOL, GAP = 0.35, 0.25      # tests/test_chunk_kernel.py's band
EXACT_ATOL = 1e-5                # flag off: f32 summation order (2.4e-7)
# The two frameworks' f32 RMSNorm (mean of squares, rsqrt) differ in the
# last bit on about half of all rows, so the carried f32 hidden can differ
# by an ulp (2.4e-7 measured).  Over the eight frames of the slice test
# that drift flipped one code in frame 7 with the inputs of seed 3 (which
# tests/test_torch_engine.py uses); seeds 4-8 agree on every code.
STATE_SEED = 4


def _case():
    tcfg, pcfg = JTC(**TALKER), JPC(**PRED)
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    tparams = jtr.init_decoder_params(tcfg, k1)
    tparams["codec_head"] = (jax.random.normal(
        jax.random.fold_in(k1, 7), (tcfg.n_codec_logits, tcfg.d_model))
        * 0.05).astype(jnp.bfloat16)
    pparams = jpred.init_predictor_params(pcfg, k2)
    rng = np.random.default_rng(STATE_SEED)
    pack = {"proj_w": rng.standard_normal((256, 256)) * 0.05,
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
    jpack = {k: jnp.asarray(v) for k, v in pack.items()}
    jax_prep = dict(
        pred_w=jcs.prep_predictor_w4(pcfg, pparams),
        extras=jcs.prep_chunk_extras(tcfg, pcfg, tparams, pparams, jpack),
        layer_w=jprep(tcfg, tparams, weights="w4a8"))
    tp = tree_to_torch(jax.tree_util.tree_map(np.asarray, tparams))
    pp = tree_to_torch(jax.tree_util.tree_map(np.asarray, pparams))
    tpack = {k: to_tensor(v) for k, v in pack.items()}
    ttc, tpc = TTC(**TALKER), TPC(**PRED)
    port_prep = dict(
        pred_w=tcs.prep_predictor_w4(tpc, pp),
        extras=tcs.prep_chunk_extras(ttc, tpc, tp, pp, tpack),
        layer_w=tts.prep_layer_weights(ttc, tp))
    return dict(tcfg=tcfg, pcfg=pcfg, tparams=tparams, pparams=pparams,
                pack=pack, state=state, jax=jax_prep, port=port_prep,
                ttc=ttc, tpc=tpc, tp=tp, pp=pp, tpack=tpack)


@pytest.fixture(scope="module")
def case():
    return _case()


def _jax_chunk(c, n_frames, start=START, k=None, v=None, logits=None,
               hidden=None):
    st = c["state"]
    tp = dict(c["tparams"], fused_w4a8=c["jax"]["layer_w"])
    out = jcs.gen_chunk_fused(
        c["tcfg"], c["pcfg"], tp, c["jax"]["pred_w"], c["jax"]["extras"],
        jnp.asarray(st["logits"] if logits is None else logits),
        jnp.asarray(st["hidden"] if hidden is None else hidden),
        jnp.asarray(st["k"] if k is None else k, jnp.bfloat16),
        jnp.asarray(st["v"] if v is None else v, jnp.bfloat16),
        jnp.asarray([LENGTH], jnp.int32), jnp.int32(start),
        jnp.asarray([start], jnp.int32), jnp.zeros((n_frames, 1)),
        jnp.asarray([[0.0, 40.0, 0.9, 0.0]], jnp.float32),
        n_frames=n_frames, prompt_cap=PCAP, interpret=True)
    codes, lg, hd, k2, v2 = (np.asarray(a, np.float32) for a in out)
    return codes.astype(np.int32), lg[:, :2160], hd, k2, v2


def _port_chunk(c, n_frames, start=START, k=None, v=None, logits=None,
                hidden=None, taps=None, fn=tcs.gen_chunk_fused, **kw):
    """Returns (codes, logits, hidden, k cache, v cache) as numpy.  A
    frame0 in kw (gen_chunk_plain's) moves the frames' positions with it."""
    st, pr = c["state"], c["port"]
    kc = to_tensor(st["k"] if k is None else k).to(torch.bfloat16)
    vc = to_tensor(st["v"] if v is None else v).to(torch.bfloat16)
    p = start + kw.get("frame0", 0) + torch.arange(n_frames)[:, None]
    cos, sin = ttalk._rope_tables(c["ttc"], ttalk._pos4(p))
    i32 = lambda x: torch.tensor([x], dtype=torch.int32)
    codes, lg, hd = fn(
        c["ttc"], c["tpc"], pr["layer_w"], pr["pred_w"], pr["extras"],
        to_tensor(st["logits"] if logits is None else logits),
        to_tensor(st["hidden"] if hidden is None else hidden), kc, vc,
        i32(LENGTH), i32(start), cos.float(), sin.float(),
        torch.zeros(n_frames, 1), (0.0, 40, 0.9), PCAP, taps=taps, **kw)
    return (codes.numpy(), lg.numpy(), hd.numpy(), kc.float().numpy(),
            vc.float().numpy())


# ----------------------------------------------------------------- prep
def test_prep_matches_jax(case):
    conv = chunk_pack_from_jax(
        jax.tree_util.tree_map(np.asarray, case["jax"]["pred_w"]),
        jax.tree_util.tree_map(np.asarray, case["jax"]["extras"]))
    for part in ("pred_w", "extras"):
        got = case["port"][part]
        assert set(got) == set(conv[part]), part
        for name, t in got.items():
            want = conv[part][name]
            assert t.dtype == want.dtype and torch.equal(t, want), name
    for name in ("wqkv_s", "wo_s", "gu_s", "dn_s"):
        assert case["port"]["pred_w"][name].dtype == torch.float32
    assert case["port"]["layer_w"]["wqkv_s"].dtype == torch.bfloat16


def test_preps_from_int8_weights_match_jax(case):
    """From int8-dict engine weights (ops.quant.quantize_decoder_layers and
    quantize_head on both models): the chunk kernel's predictor (q * s in
    f32, then grouped int4, as JAX `_pack_w4`), its extras (the heads'
    own integers) and the talker's w4a8 layers equal the JAX preps'."""
    from qwen3_tts_tpu.ops import quant as JQ
    c = case

    def q8(p, head):
        return dict(p, layers=JQ.quantize_decoder_layers(p["layers"]),
                    **{head: JQ.quantize_head(p[head])})

    jt, jp = q8(c["tparams"], "codec_head"), q8(c["pparams"], "lm_head")
    jpack = {k: jnp.asarray(v) for k, v in c["pack"].items()}
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    conv = chunk_pack_from_jax(
        np_tree(jcs.prep_predictor_w4(c["pcfg"], jp)),
        np_tree(jcs.prep_chunk_extras(c["tcfg"], c["pcfg"], jt, jp, jpack)))
    tt, tp = tree_to_torch(np_tree(jt)), tree_to_torch(np_tree(jp))
    got = {"pred_w": tcs.prep_predictor_w4(c["tpc"], tp),
           "extras": tcs.prep_chunk_extras(c["ttc"], c["tpc"], tt, tp,
                                           c["tpack"])}
    for part in ("pred_w", "extras"):
        assert set(got[part]) == set(conv[part]), part
        for name, t in got[part].items():
            want = conv[part][name]
            assert t.dtype == want.dtype and torch.equal(t, want), name
    # the int8 heads pass through: the int8 weights' own integers
    assert torch.equal(got["extras"]["chead_q"],
                       tt["codec_head"]["q"][:tcs.V_CODEC])
    lw = tts.prep_layer_weights(c["ttc"], tt, "w4a8")
    from qwen3_tts_tpu_torch.io.from_jax import talker_w4a8_from_jax
    want = talker_w4a8_from_jax(np_tree(jprep(c["tcfg"], jt,
                                              weights="w4a8")))
    for name, t in lw.items():
        assert torch.equal(t, want[name]), name


def test_chunk_path_refuses_other_talker_modes(case):
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    from qwen3_tts_tpu_torch.runtime import generate as tg
    cfg = EngineConfig(talker=case["ttc"], predictor=case["tpc"])
    for mode in ("int8", "w8a8", "bf16"):
        with pytest.raises(ValueError, match="w4a8"):
            tg.Generator(cfg, case["tp"], case["pp"], case["tpack"],
                         fused=True, chunk=True, talker_mode=mode)
    with pytest.raises(ValueError, match="talker_mode"):
        tg.Generator(cfg, case["tp"], case["pp"], case["tpack"],
                     fused=True, talker_mode="int4")


# -------------------------------------------------------------- sampler
def test_sampler_greedy_is_argmax_lowest_index_on_ties():
    rng = np.random.default_rng(0)
    lg = (rng.standard_normal((3, 2160)) * 2).astype(np.float32)
    lg[1, [7, 900, 2000]] = lg[1].max() + 1.0       # a three-way tie
    lg[2, [2159, 5]] = 50.0
    got = sample_threshold(torch.from_numpy(lg), torch.zeros(3), 0.0, 40,
                           0.9).numpy()
    np.testing.assert_array_equal(got, np.argmax(lg, axis=-1))
    assert got.tolist()[1:] == [7, 5]
    jl = np.full((3, jcs.VP), jcs.NEG_INF, np.float32)
    jl[:, :2160] = lg
    want = np.asarray(jcs._sample_inkernel(jnp.asarray(jl),
                                           jnp.zeros((3, 1)), 0.0, 40,
                                           0.9))[:, 0]
    np.testing.assert_array_equal(got, want)


def test_sampler_matches_jax_draws_and_distribution():
    rng = np.random.default_rng(1)
    lg = (rng.standard_normal(2160) * 2).astype(np.float32)
    temp, k, p, n = 0.7, 40, 0.9, 4000
    us = rng.random(n).astype(np.float32)
    got = sample_threshold(torch.from_numpy(np.tile(lg, (n, 1))),
                           torch.from_numpy(us), temp, k, p).numpy()
    jl = np.full((n, jcs.VP), jcs.NEG_INF, np.float32)
    jl[:, :2160] = lg
    want = np.asarray(jcs._sample_inkernel(
        jnp.asarray(jl), jnp.asarray(us[:, None]), temp, k, p))[:, 0]
    assert (got == want).mean() >= 0.99
    order = np.argsort(-lg)
    keepk = np.arange(2160) < k
    pr = np.exp((lg[order] - lg[order][0]) / temp) * keepk
    pr /= pr.sum()
    keepp = (np.cumsum(pr) - pr) < p
    assert set(got.tolist()) <= set(order[keepk & keepp].tolist())
    fin = np.where(keepk & keepp, pr, 0)
    ref = np.zeros(2160)
    ref[order] = fin / fin.sum()
    assert np.abs(np.bincount(got, minlength=2160) / n - ref).max() < 0.05


# ---------------------------------------------------------------- chunk
def _codes_agree(got, want, taps):
    """Frame by frame, token by token: equal until the first difference,
    which must sit where the plain version's top-2 gap is below GAP.
    Returns (codes compared equal, whether all were equal)."""
    equal = 0
    for f in range(got.shape[1]):
        for t in range(16):
            if got[0, f, t] == want[0, f, t]:
                equal += 1
                continue
            assert t > 0 or f > 0, "frame 0's code_0 must be exact"
            if t > 0:
                top2 = np.sort(taps[f * 15 + t - 1][0].numpy())[-2:]
                assert top2[1] - top2[0] <= GAP, (f, t, top2)
            return equal, False
    return equal, True


def test_plain_chunk_matches_pallas(case):
    taps = []
    got = _port_chunk(case, 4, taps=taps)
    want = _jax_chunk(case, 4)
    assert got[0].shape == (1, 4, 16) and got[0].dtype == np.int32
    assert got[1].shape == (1, 2160) and got[2].shape == (1, 256)
    assert len(taps) == 60
    equal, all_equal = _codes_agree(got[0], want[0], taps)
    assert equal >= 4
    if all_equal:
        for a, b in ((got[1], want[1]), (got[2], want[2])):
            np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0.05)
    keep = np.ones(CAP, bool)
    keep[START:START + 4] = False
    for a, b in ((got[3], want[3]), (got[4], want[4])):
        np.testing.assert_array_equal(a[:, :, :, keep], b[:, :, :, keep])
    # one frame: the predictor's window logits (the JAX kernel's debug
    # tap) within the band through the first code that differs
    taps = []
    got = _port_chunk(case, 1, taps=taps)
    want = _jax_chunk(case, 1)
    plog = np.asarray(jcs.gen_chunk_fused.last_plog[0])[:, 0]
    for t in range(1, 16):
        np.testing.assert_allclose(taps[t - 1][0].numpy(), plog[t],
                                   atol=LOGIT_TOL, rtol=0.05)
        if got[0][0, 0, t] != want[0][0, 0, t]:
            break


def test_two_frames_against_two_single_frames(case):
    """F = 2 against two F = 1 calls threading the state: frame 0 is the
    same computation (identical); frame 1 attends its predecessor as a
    chunk-local slot in one and as a cache slot in the other."""
    c2 = _port_chunk(case, 2)
    a = _port_chunk(case, 1)
    b = _port_chunk(case, 1, start=START + 1, k=a[3], v=a[4], logits=a[1],
                    hidden=a[2])
    np.testing.assert_array_equal(c2[0][:, 0], a[0][:, 0])
    np.testing.assert_array_equal(c2[3][:, :, :, START], a[3][:, :, :, START])
    assert (c2[0][0, 1] == b[0][0, 0]).mean() >= 0.8
    np.testing.assert_allclose(c2[1], b[1], atol=LOGIT_TOL, rtol=0.05)
    np.testing.assert_allclose(c2[3][:, :, :, START:START + 2],
                               b[3][:, :, :, START:START + 2], atol=0.05,
                               rtol=0.05)


def test_plain_follows_forced_codes(case):
    """force_codes (the card checks' way to hold the plain version on the
    kernel's path): its own codes change nothing; other codes steer the
    frame while it still returns its own picks.  Frame 1 run alone from
    frame 0's state on F = 2's codes stays within the band of F = 2's."""
    c2 = _port_chunk(case, 2)
    same = _port_chunk(case, 2, fn=tcs.gen_chunk_plain,
                       force_codes=torch.from_numpy(c2[0]))
    for a, b in zip(c2, same):
        np.testing.assert_array_equal(a, b)
    forced = c2[0].copy()
    forced[0, 0, 3] = (forced[0, 0, 3] + 1) % 2048
    taps = []
    steered = _port_chunk(case, 2, fn=tcs.gen_chunk_plain, taps=taps,
                          force_codes=torch.from_numpy(forced))
    np.testing.assert_array_equal(steered[0][0, 0, :4], c2[0][0, 0, :4])
    assert steered[0][0, 0, 4] == np.argmax(taps[3][0].numpy())
    assert not np.array_equal(steered[2], c2[2])
    a = _port_chunk(case, 1)
    b = _port_chunk(case, 1, start=START + 1, k=a[3], v=a[4], logits=a[1],
                    hidden=a[2], fn=tcs.gen_chunk_plain,
                    force_codes=torch.from_numpy(c2[0][:, 1:]))
    assert (b[0][0, 0] == c2[0][0, 1]).mean() >= 0.8
    np.testing.assert_allclose(b[1], c2[1], atol=LOGIT_TOL, rtol=0.05)
    np.testing.assert_allclose(b[3][:, :, :, START + 1],
                               c2[3][:, :, :, START + 1], atol=0.05,
                               rtol=0.05)


@pytest.mark.parametrize("orders", [(), tcs.CHUNK_ORDERS])
def test_plain_frame_alone_from_the_chunk_start(case, orders):
    """gen_chunk_plain's frame0: frame f run alone from the chunk's start
    with offset f, from the state after frame f - 1 and with its codes
    forced, is frame f of the F-frame run bit for bit (codes, logits,
    hidden, both caches): the talker merges the chunk's slots [START,
    START + f] last in both, where a new chunk at START + f would fold
    them into its prefix tiles.  frame0 = 0 is the default call."""
    n = 3
    runs = [_port_chunk(case, f, fn=tcs.gen_chunk_plain, orders=orders)
            for f in range(1, n + 1)]
    base = _port_chunk(case, 1, fn=tcs.gen_chunk_plain, orders=orders,
                       frame0=0)
    for a, b in zip(base, runs[0]):
        np.testing.assert_array_equal(a, b)
    for f in range(1, n):
        prev, want = runs[f - 1], runs[f]
        got = _port_chunk(case, 1, k=prev[3], v=prev[4], logits=prev[1],
                          hidden=prev[2], fn=tcs.gen_chunk_plain,
                          orders=orders, frame0=f,
                          force_codes=torch.from_numpy(want[0][:, f:f + 1]))
        np.testing.assert_array_equal(got[0][:, 0], want[0][:, f])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="past the cache capacity"):
        _port_chunk(case, 2, fn=tcs.gen_chunk_plain,
                    frame0=CAP - START - 1)


@pytest.mark.parametrize("tile", [64, 128])
def test_plain_prefix_tile_changes_only_the_order(case, tile):
    """prefix_tile (the card checks' measure of order drift) scans the same
    visible slots: the codes and the written k/v rows of the default 512
    tiles, the logits within the band."""
    want = _port_chunk(case, 2)
    got = _port_chunk(case, 2, fn=tcs.gen_chunk_plain, prefix_tile=tile)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=LOGIT_TOL, rtol=0.05)
    for a, b in zip(got[3:], want[3:]):
        np.testing.assert_allclose(a[:, :, :, START:START + 2],
                                   b[:, :, :, START:START + 2], atol=0.05,
                                   rtol=0.05)


def _jax_slice(c, n_chunks, n_frames):
    from qwen3_tts_tpu.core.config import EngineConfig as JEC
    from qwen3_tts_tpu.runtime import generate as jg
    cfg = JEC(talker=c["tcfg"], predictor=c["pcfg"])
    st = c["state"]
    cache = jtr.KVCache(k=jnp.asarray(st["k"], jnp.bfloat16),
                        v=jnp.asarray(st["v"], jnp.bfloat16),
                        write_idx=jnp.asarray([START], jnp.int32),
                        lengths=jnp.asarray([LENGTH], jnp.int32))
    state = jg.GenState(cache=cache, logits=jnp.asarray(st["logits"]),
                        hidden=jnp.asarray(st["hidden"]),
                        pos=jnp.asarray([LENGTH], jnp.int32),
                        step=jnp.int32(0), done=jnp.zeros((1,), bool),
                        key=jax.random.PRNGKey(0))
    tp = dict(c["tparams"], fused_w4a8=c["jax"]["layer_w"])
    pack = {"pred_w": c["jax"]["pred_w"], "extras": c["jax"]["extras"]}
    sampler = jg.SamplerParams(temperature=jnp.float32(0.0),
                               top_k=jnp.int32(40), top_p=jnp.float32(0.9))
    out = []
    for _ in range(n_chunks):
        state, codes, valid = jg._gen_frames_chunk(
            cfg, tp, pack, state, sampler, n_frames, PCAP, interpret=True)
        out.append((np.asarray(codes), np.asarray(valid)))
    return out, int(state.cache.write_idx[0])


def _port_slice(c, n_chunks, n_frames):
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    from qwen3_tts_tpu_torch.models.transformer import KVCache
    from qwen3_tts_tpu_torch.runtime import generate as tg
    cfg = EngineConfig(talker=c["ttc"], predictor=c["tpc"])
    gen = tg.Generator(cfg, c["tp"], c["pp"], c["tpack"], fused=True,
                       chunk=True)
    assert "chunk" in gen.talker_params
    # the per-frame schedule's predictor weights too (per-lane frames)
    assert "fused_int8" in gen.predictor_params
    st = c["state"]
    i32 = lambda x: torch.tensor([x], dtype=torch.int32)
    state = tg.GenState(
        cache=KVCache(k=to_tensor(st["k"]).to(torch.bfloat16),
                      v=to_tensor(st["v"]).to(torch.bfloat16),
                      write_idx=i32(START), lengths=i32(LENGTH)),
        logits=to_tensor(st["logits"]), hidden=to_tensor(st["hidden"]),
        pos=i32(LENGTH), step=0, done=torch.zeros(1, dtype=torch.bool),
        generator=torch.Generator().manual_seed(0))
    out = []
    for _ in range(n_chunks):
        state, codes, valid = tg.gen_frames(
            cfg, gen.talker_params, gen.predictor_params, c["tpack"], state,
            tg.SamplerParams(0.0, 40, 0.9), n_frames, PCAP)
        out.append((codes.numpy(), valid.numpy()))
    assert state.step == n_chunks * n_frames
    return out, int(state.cache.write_idx[0])


def exact_main():
    """Run by test_chunk_bit_exact_without_excess_precision in a process
    whose XLA flags turn excess precision off."""
    jax.config.update("jax_platforms", "cpu")
    c = _case()
    got, want = _port_chunk(c, 4), _jax_chunk(c, 4)
    np.testing.assert_array_equal(got[0], want[0])
    errs = [float(np.abs(a - b).max()) for a, b in zip(got[1:3], want[1:3])]
    rows = slice(START, START + 4)
    errs += [float(np.abs(a[:, :, :, rows] - b[:, :, :, rows]).max())
             for a, b in zip(got[3:], want[3:])]
    print(f"chunk F=4: max abs err logits, hidden, k rows, v rows: {errs}")
    assert max(errs) <= EXACT_ATOL, errs
    keep = np.ones(CAP, bool)
    keep[rows] = False
    for a, b in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(a[:, :, :, keep], b[:, :, :, keep])
    (jout, jwi), (tout, twi) = _jax_slice(c, 2, 4), _port_slice(c, 2, 4)
    assert jwi == twi == START + 8, (jwi, twi)
    for i, ((jc, jv), (tc_, tv)) in enumerate(zip(jout, tout)):
        np.testing.assert_array_equal(tc_, jc, err_msg=f"chunk {i}")
        np.testing.assert_array_equal(tv, jv, err_msg=f"chunk {i}")
    print("chunk equal")


def test_chunk_bit_exact_without_excess_precision():
    here = Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [str(here.parent), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c", "import test_torch_chunk_step as t; "
         "t.exact_main()"], cwd=here, env=env, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.strip().endswith("chunk equal")


# -------------------------------------------------- gates and wrapper
def test_gates_name_what_fails():
    t, p = TTC(), TPC()
    assert tcs.supported(t, p, 1, 4) and tcs.supported(t, p, 1, 8)
    assert tcs.unsupported(t, p, 2, 4) == \
        "chunk_step: batch 2 not in (1, 8, 16, 24, 32)"
    assert tcs.unsupported(t, p, 1, 9) == \
        "chunk_step: n_frames 9 outside [1, 8]"
    assert "talker_step: head_dim" in tcs.unsupported(TTC.tiny(), p, 1, 4)
    assert "d_ff 1000" in tcs.unsupported(t, TPC(d_ff=1000), 1, 4)


def test_wrapper_routes_cpu_to_plain_and_rejects_other_devices(case):
    before = tcs.gen_chunk_fused.launches
    codes = _port_chunk(case, 1)[0]
    assert tcs.gen_chunk_fused.launches == before
    assert codes.shape == (1, 1, 16)
    pr = case["port"]
    # the kernel route's input check (reached only for CUDA tensors)
    # accepts the prepped packs and the carried state, and names a bad one
    st = case["state"]
    cos, sin = ttalk._rope_tables(case["ttc"], ttalk._pos4(
        START + torch.arange(4)[:, None]))
    tensors = dict(logits=to_tensor(st["logits"]),
                   hidden=to_tensor(st["hidden"]), cos=cos.float(),
                   sin=sin.float(), u=torch.zeros(4, 1),
                   lengths=torch.tensor([LENGTH], dtype=torch.int32),
                   write_idx=torch.tensor([START], dtype=torch.int32),
                   cache_k=to_tensor(st["k"]).to(torch.bfloat16),
                   cache_v=to_tensor(st["v"]).to(torch.bfloat16))
    tensors.update({"t_" + k: pr["layer_w"][k] for k in tcs._TALKER})
    tensors.update({"p_" + k: pr["pred_w"][k] for k in tcs._TALKER})
    tensors.update({k: pr["extras"][k] for k in tcs._EXTRAS})
    tcs._check(case["ttc"], case["tpc"], pr["extras"], tensors)
    tensors["p_wo_s"] = tensors["p_wo_s"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="p_wo_s must be torch.float32"):
        tcs._check(case["ttc"], case["tpc"], pr["extras"], tensors)
    meta = torch.zeros(1, 256, device="meta")
    with pytest.raises(ValueError):
        tcs.gen_chunk_fused(case["ttc"], case["tpc"], pr["layer_w"],
                            pr["pred_w"], pr["extras"], meta, meta, meta,
                            meta, meta, meta, meta, meta, meta,
                            (0.0, 40, 0.9), PCAP)
    with pytest.raises(ValueError):
        tcs.sample_fused(meta, meta, 0.0, 40, 0.9)


# ------------------------------------- the plain layer in the kernel's orders
# chunk_step._talker_layer_plain(orders=...) swaps the CUDA chunk kernel's
# sum orders in (its RMSNorm and q/k-norm sums and 1 / sqrt, its
# attention's split, combine and merge sums, its score dots): the card's
# layer check holds the kernel to that (ROADMAP Queue C #1).  Each order is an equally valid f32
# order of the same sums, so against torch's orders it may only flip a
# bf16 rounding, and the next w4a8 quantization then moves an output by one
# int8 unit: ORDER_TOL of max |torch-order residual| (one H100, full width:
# up to 2.2e-2 per layer, PERF.md Queue C #1).
ORDER_TOL = 3e-2


def _layer_inputs(c, b, seed):
    """b lanes at START with ragged prompt lengths: the residual entering
    a layer (bf16), rope tables for frame f = 1, the caches."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((b, 256)) * 0.3).astype(
        np.float32)).bfloat16()
    st = c["state"]
    k = to_tensor(np.repeat(st["k"], b, axis=1)).to(torch.bfloat16)
    v = to_tensor(np.repeat(st["v"], b, axis=1)).to(torch.bfloat16)
    lens = torch.tensor([LENGTH - 7 * i for i in range(b)], dtype=torch.int32)
    p = (START + 1) * torch.ones(1, b, dtype=torch.long)
    cos, sin = ttalk._rope_tables(c["ttc"], ttalk._pos4(p))
    return x, cos[0].float(), sin[0].float(), k, v, lens


@pytest.mark.parametrize("orders", [("rms",), ("qk",), ("softmax",),
                                    ("scores",), ("softmax", "scores"),
                                    tcs.KERNEL_ORDERS])
def test_kernel_order_layer_matches_torch_order(case, orders):
    x, cos, sin, k, v, lens = _layer_inputs(case, 3, 21)
    w = case["port"]["layer_w"]
    for layer in range(2):
        kt, vt, kk, vk = k.clone(), v.clone(), k.clone(), v.clone()
        want = tcs._talker_layer_plain(case["ttc"], w, layer, x, cos, sin,
                                       kt, vt, lens, START, 1, PCAP, 128)
        got = tcs._talker_layer_plain(case["ttc"], w, layer, x, cos, sin,
                                      kk, vk, lens, START, 1, PCAP, 128,
                                      orders=orders)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = (got.float() - want.float()).abs().max()
        assert err <= ORDER_TOL * want.float().abs().max(), (layer, err)
        # the k/v row of frame 1 is the only slot written
        keep = torch.ones(CAP, dtype=torch.bool)
        keep[START + 1] = False
        assert torch.equal(kk[:, :, :, keep], k[:, :, :, keep])
        err = (kk[layer, :, :, START + 1].float()
               - kt[layer, :, :, START + 1].float()).abs().max()
        assert err <= ORDER_TOL * kt[layer, :, :, START + 1].abs().max()
    with pytest.raises(ValueError, match="unknown orders"):
        tcs._talker_layer_plain(case["ttc"], w, 0, x, cos, sin, k, v, lens,
                                START, 1, PCAP, 128, orders=("rms", "tree"))


def test_kernel_order_talker_matches_jax_step(case):
    """The talker in the kernel's orders at frame 0 (the cache prefix, then
    the token itself at START) against the JAX package's talker step (the
    Pallas kernel in interpret mode, as tests/test_torch_talker_step.py
    runs it), on the same weights: the two layers' increment (the residual
    after them less x, which the skip connections carry) and the written
    k/v rows within that file's REL_TOL, 5 % of max |increment| (under
    XLA's default flags the interpret-mode kernel skips some bf16
    roundings: 3.1 % here, the same in torch's orders), so that a lost
    attention or MLP term fails."""
    from qwen3_tts_tpu.kernels import talker_step as jts
    x, cos, sin, k, v, lens = _layer_inputs(case, 2, 22)
    p = START * torch.ones(1, 2, dtype=torch.long)
    cos, sin = (t[0].float() for t in ttalk._rope_tables(case["ttc"],
                                                         ttalk._pos4(p)))
    kk, vk = k.clone(), v.clone()
    got = tcs._talker_plain(case["ttc"], case["port"]["layer_w"], x, cos,
                            sin, kk, vk, lens, START, 0, PCAP, 128,
                            orders=tcs.KERNEL_ORDERS)
    h, jk, jv = jts.talker_step_fused(
        case["tcfg"], case["tparams"], jnp.asarray(x.float().numpy(),
                                                   jnp.bfloat16),
        jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()),
        jnp.asarray(k.float().numpy(), jnp.bfloat16),
        jnp.asarray(v.float().numpy(), jnp.bfloat16),
        jnp.asarray(lens.numpy()), jnp.int32(START), PCAP, interpret=True,
        weights="w4a8")
    want = np.asarray(h, np.float32)
    x0 = x.float().numpy()
    inc, want_inc = got.float().numpy() - x0, want - x0
    err = np.abs(inc - want_inc).max()
    assert err <= 0.05 * np.abs(want_inc).max(), err
    for cache, jc in ((kk, jk), (vk, jv)):
        a = cache.float().numpy()[:, :, :, START]
        b = np.asarray(jc, np.float32)[:, :, :, START]
        assert np.abs(a - b).max() <= 0.05 * np.abs(b).max()


# The kernel-order attention (_attend_kernel_order: SPLIT-slot splits of
# the prefix combined in split order, 8-lane score dots) against the
# torch-order plain attention (512-slot tiles, einsum dots), both from the
# same bf16 q and cache: the same f32 function summed in other orders, so
# the bf16 context agrees to about one bf16 rounding: ATTN_RTOL = 2^-6 of
# |plain| (a bf16 ulp is 2^-8 to 2^-7 of the value) plus ATTN_ATOL for
# outputs near zero.
ATTN_RTOL, ATTN_ATOL = 2.0 ** -6, 1e-4


@pytest.mark.parametrize("start", [0, 1, tcs.SPLIT - 1, tcs.SPLIT,
                                   tcs.SPLIT + 1, 3 * tcs.SPLIT + 5])
def test_kernel_order_attention_across_split_bounds(start):
    """Prefixes on both sides of a split bound, prompt_cap inside the
    prefix (generated slots [prompt_cap, start) visible), per-lane prompt
    lengths (prompt_cap, half of it, none), frames f = 0..3 (the chunk's
    own slots)."""
    rng = np.random.default_rng(100 + start)
    b, hkv, g, dh, cap = 3, 2, 2, 128, 4 * tcs.SPLIT + 16
    bf = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()
    kc, vc = bf(b, hkv, cap, dh), bf(b, hkv, cap, dh)
    prompt_cap = start - start // 3
    lengths = torch.tensor([prompt_cap, prompt_cap // 2, 0],
                           dtype=torch.int32)
    for f in range(4):
        q = bf(b, hkv * g, dh)
        want = tcs._chunk_attend_plain(q, kc, vc, lengths, start, f,
                                       prompt_cap, tcs.PREFIX_TILE)
        for kernel_scores in (True, False):
            got = tcs._attend_kernel_order(q, kc, vc, lengths, start, f,
                                           prompt_cap, kernel_scores)
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=ATTN_RTOL, atol=ATTN_ATOL)


def test_phase_labels_count_542_barriers_per_frame():
    """The chunk kernel at EngineConfig()'s depths: 1 + 16 x 6 x 4 + 15 +
    1 + 28 x 5 + 1 grid barriers per frame, no "p_attn" phase."""
    from qwen3_tts_tpu_torch import EngineConfig
    cfg = EngineConfig()
    labels = tcs.phase_labels(cfg.talker, cfg.predictor, 2)
    assert len(labels) == 2 * 542
    assert "p_attn" not in labels and labels.count("t_attn") == 2 * 28
    assert labels.count("p_wo") == 2 * 16 * 6


# ------------------------------------------------------- the launch plan
SMS = 132                       # an H100's SMs
SMEM_227K = 232448              # the most shared memory a block may have


@pytest.mark.parametrize("batch", tcs.PLAN_BATCHES)
def test_plan_at_full_width_covers_every_tile_once_and_fits(batch):
    """The wrapper's plan at EngineConfig()'s widths for every batch of the
    gate that the batched body runs: every weighted phase's tile ranges are
    contiguous and cover its output tiles exactly once, the ring holds
    each block's share of every phase, each pass's staged rows and the
    attention scratch fit the row region, and the whole fits 227 KB."""
    from qwen3_tts_tpu_torch import EngineConfig
    cfg = EngineConfig()
    p = tcs.plan(cfg.talker, cfg.predictor, batch, SMS)
    warps = tcs.block_warps(batch)
    assert p["blocks"] == SMS and p["warps"] == warps
    assert p["mt"] == (1 if batch <= 16 else 2)
    assert p["smem_bytes"] == (p["ring_bytes"] + p["region_bytes"]
                               + tcs.SMALL_BYTES) <= SMEM_227K
    assert p["region_bytes"] >= warps * tcs.PRED_WARP_BYTES
    assert set(p["phases"]) == set(tcs.PLAN_KINDS)
    mats = tcs._plan_mats(cfg.talker, cfg.predictor)
    for kind, ph in p["phases"].items():
        n, k, r, qcol, scol, stride, lda = mats[kind]
        assert ph["tiles"] == n // 8 and n % 8 == 0
        ranges = ph["ranges"]
        assert len(ranges) == p["blocks"] and ranges[0][0] == 0
        assert ranges[-1][1] == ph["tiles"]
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
        assert all(t0 <= t1 for t0, t1 in ranges)
        covered = sorted(t for t0, t1 in ranges for t in range(t0, t1))
        assert covered == list(range(ph["tiles"]))
        for t0, t1 in ranges:
            assert r * 8 * (t1 - t0) * (stride + scol) <= ph["ring_bytes"]
        assert ph["ring_bytes"] <= p["ring_bytes"]
        assert ph["rows"] in ((batch, 16, 8) if batch > 16 else (batch, 8))
        assert ph["rows"] * lda <= ph["row_bytes"] <= p["region_bytes"]
    # the largest ring: the talker's gate_up, six tiles of a block at 132
    # blocks
    assert p["ring_bytes"] == p["phases"]["t_gate_up"]["ring_bytes"]
    if p["blocks"] == SMS:
        assert p["ring_bytes"] == 2 * 48 * (1024 + 64 + 32)


def test_plan_refuses_what_does_not_fit_naming_the_phase():
    """A talker too wide for its grid (d_ff 8192 on a 40-SM card: 26
    gate_up tiles a block) cannot hold its share of gate_up in the ring:
    the plan names that phase, in either block size (8 lanes: 8 warps, 32:
    16); both fit the full width."""
    from qwen3_tts_tpu_torch import EngineConfig
    cfg = EngineConfig()
    for batch, warps in ((8, 8), (32, 16)):
        p = tcs.plan(cfg.talker, cfg.predictor, batch, SMS)
        assert p["warps"] == warps and p["smem_bytes"] <= SMEM_227K
        with pytest.raises(ValueError, match="phase t_gate_up does not fit"):
            tcs.plan(TTC(d_ff=8192), cfg.predictor, batch, 40)


@pytest.mark.parametrize("batch", [1, 2, 48])
def test_plan_is_for_the_batched_body_only(batch):
    """One lane runs the one-lane kernel, which takes no plan; a batch
    outside the gate has none either: plan raises ValueError naming the
    batch, and PLAN_BATCHES is the gate's batches but 1."""
    from qwen3_tts_tpu_torch import EngineConfig
    cfg = EngineConfig()
    assert tcs.PLAN_BATCHES == (8, 16, 24, 32)
    with pytest.raises(ValueError, match=f"batch {batch} takes no plan"):
        tcs.plan(cfg.talker, cfg.predictor, batch, SMS)


# ------------------------------------ the rest of the frame in kernel order
# gen_chunk_plain(orders=FRAME_ORDERS) swaps in the chunk kernel's order for
# the projection's dots, the feedback's sum and the RMSNorms outside the
# talker layers: each is an equally valid f32 order, so against torch's it
# moves a bf16 output by at most one rounding, which later layers may
# carry: ORDER_TOL of max |torch-order output| for the frame's logits and
# hidden (the talker layer's bound above).
@pytest.mark.parametrize("orders", [("proj",), ("feedback",), ("norms",),
                                    ("qk",), tcs.CHUNK_ORDERS])
def test_frame_orders_change_only_the_order(case, orders):
    st, pr = case["state"], case["port"]
    hid = to_tensor(st["hidden"])
    ex = pr["extras"]
    if "proj" in orders:
        want = tcs._project(hid, ex).float()
        got = tcs._project(hid, ex, kernel_order=True)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        # one bf16 rounding at most
        assert ((got.float() - want).abs()
                <= 2.0 ** -7 * want.abs() + 1e-6).all()
    if "feedback" in orders:
        codes = torch.tensor([[(37 * q + 5) % 2048 for q in range(16)]],
                             dtype=torch.int32)
        want = tcs._feedback(ex["ctab_fb"], codes, ex["tts_pad"]).float()
        got = tcs._feedback(ex["ctab_fb"], codes, ex["tts_pad"], True)
        assert ((got.float() - want).abs()
                <= 2.0 ** -7 * want.abs() + 1e-6).all()
    # one frame, its own codes forced: the orders only move the sums
    base = _port_chunk(case, 1, fn=tcs.gen_chunk_plain)
    got = _port_chunk(case, 1, fn=tcs.gen_chunk_plain, orders=orders,
                      force_codes=torch.from_numpy(base[0]))
    for a, b in zip(got[1:3], base[1:3]):
        assert np.abs(a - b).max() <= ORDER_TOL * np.abs(b).max()
    with pytest.raises(ValueError, match="unknown orders"):
        _port_chunk(case, 1, fn=tcs.gen_chunk_plain, orders=("tree",))
