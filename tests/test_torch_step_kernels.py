"""The step schedule's redesigned kernels (csrc/talker_step.cu and
csrc/predictor_frame.cu: one cooperative launch per step or frame) on
the CPU, where their arithmetic is held through the plain versions:

- the talker step in the kernel's sum orders (chunk_step._talker_plain
  with KERNEL_ORDERS: the 256-thread RMSNorm, the per-head q/k norms, the
  64-slot prefix splits combined in split order, the current token merged
  last) against talker_step_plain and the JAX package's Pallas kernel in
  interpret mode, on the same seeded numpy inputs, at cursors on both
  sides of the 64-slot split bounds.  Tolerance REL_TOL = 5e-2 of max
  |reference|, that of tests/test_torch_talker_step.py: the orders differ,
  so a bf16 rounding flips now and then, and the next int8 quantization
  carries it (and under XLA's default flags the interpret-mode kernel
  skips some bf16 roundings of its own); the cache slots the step does not
  write stay bit for bit;
- each GEMV input quantized once (the kernel's norm phase, or its
  producers' running max |x| and the staging): bit-equal to quantizing the
  row in one piece (w4a8.cuh quantize_rows' arithmetic, which every GEMV
  block of the earlier design repeated), and the w4a8 product from those
  rows, column block by column block, bit-equal to qmm4_plain;
- the kernels' kept scratch at B = 1, 4, 8, 32 (and 96 for the talker),
  and their phase lists (one cooperative launch: a grid barrier between
  two phases);
- the gates.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.core.config import TalkerConfig as JTC
from qwen3_tts_tpu.kernels import talker_step as jts
from qwen3_tts_tpu.models import transformer as jtr
from qwen3_tts_tpu.ops.rope import inv_frequencies, mrope_cos_sin, section_ids
from qwen3_tts_tpu_torch.core.config import PredictorConfig as TPC
from qwen3_tts_tpu_torch.core.config import TalkerConfig as TTC
from qwen3_tts_tpu_torch.io.from_jax import talker_w4a8_from_jax
from qwen3_tts_tpu_torch.kernels import chunk_step as tcs
from qwen3_tts_tpu_torch.kernels import predictor_frame as tpf
from qwen3_tts_tpu_torch.kernels import talker_step as tts
from qwen3_tts_tpu_torch.ops.quant import pack_int4, quantize_int4_grouped

PCAP, CAP = 32, 1024
CFG = dict(d_model=256, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=128,
           d_ff=256, mrope_sections=(24, 20, 20, 0), dtype="bfloat16")
REL_TOL = 0.05


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    jcfg, tcfg = JTC(**CFG), TTC(**CFG)
    params = jtr.init_decoder_params(jcfg, jax.random.PRNGKey(0))
    jw = jax.tree_util.tree_map(
        np.asarray, jts.prep_layer_weights(jcfg, params, weights="w4a8"))
    return jcfg, tcfg, params, talker_w4a8_from_jax(jw)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a)).to(dtype)


def _rope(cfg, pos):
    inv = jnp.asarray(inv_frequencies(cfg.head_dim, cfg.rope_theta))
    sec = jnp.asarray(section_ids(cfg.mrope_sections))
    p = jnp.asarray(np.asarray(pos, np.int32)[:, None])
    cos, sin = mrope_cos_sin(jnp.stack([p, p, p, jnp.zeros_like(p)], -1),
                             inv, sec)
    return np.asarray(cos)[:, 0], np.asarray(sin)[:, 0]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("cursor", [47, 64, 65, 1023])
def test_split_order_step_matches_plain_and_pallas(setup, cursor):
    jcfg, tcfg, params, w = setup
    rng = np.random.default_rng(cursor)
    shape = (jcfg.n_layers, 1, jcfg.n_kv_heads, CAP, jcfg.head_dim)
    k = _bf16(rng.standard_normal(shape) * 0.3)
    v = _bf16(rng.standard_normal(shape) * 0.3)
    x = _bf16(rng.standard_normal((1, jcfg.d_model)) * 0.3)
    length = 29
    cos, sin = _rope(jcfg, [cursor])
    jh, jk, jv = jts.talker_step_fused(
        jcfg, params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(cos),
        jnp.asarray(sin), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray([length], jnp.int32),
        jnp.int32(cursor), PCAP, interpret=True, weights="w4a8")
    lens = torch.tensor([length], dtype=torch.int32)
    wi = torch.tensor([cursor], dtype=torch.int32)
    args = (_t(x), _t(cos, torch.float32), _t(sin, torch.float32))
    ks, vs, kp, vp = _t(k), _t(v), _t(k), _t(v)
    split = tcs._talker_plain(tcfg, w, *args, ks, vs, lens, cursor, 0, PCAP,
                              128, orders=tcs.KERNEL_ORDERS)
    plain = tts.talker_step_plain(tcfg, w, *args, kp, vp, lens, wi, PCAP)
    got = split.float().numpy()
    assert got.shape == (1, jcfg.d_model) and np.isfinite(got).all()
    assert _rel(got, plain.float().numpy()) <= REL_TOL
    assert _rel(got, np.asarray(jh, np.float32)) <= REL_TOL
    keep = np.arange(CAP) != cursor
    for cache, other, want, orig in ((ks, kp, jk, k), (vs, vp, jv, v)):
        c = cache.float().numpy()
        want = np.asarray(want, np.float32)
        # layer 0's row precedes any sum the orders change
        np.testing.assert_array_equal(c[0, :, :, cursor], want[0, :, :, cursor])
        assert _rel(c[:, :, :, cursor], want[:, :, :, cursor]) <= REL_TOL
        assert _rel(c[:, :, :, cursor],
                    other.float().numpy()[:, :, :, cursor]) <= REL_TOL
        np.testing.assert_array_equal(c[:, :, :, keep], orig[:, :, :, keep])


def test_quantize_once_equals_per_block_quantize():
    """The kernel's activations: the running max over column pieces (its
    producers' atomicMax) gives quantize_rows' scale and integers, and the
    w4a8 product from those rows, one output-column block at a time (the
    kernel's blocks), is qmm4_plain bit for bit."""
    rng = np.random.default_rng(3)
    b, k, n = 3, 512, 40
    x = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32)
                         * 0.7).to(torch.bfloat16)
    xq, sx = tts.quantize_rows_plain(x)
    amax = torch.zeros(b)
    for piece in x.float().abs().split(96, dim=1):       # 6 producers
        amax = torch.maximum(amax, piece.amax(dim=1))
    sx2 = torch.clamp(amax, min=1e-8)[:, None] * tts.INV127
    assert torch.equal(sx, sx2)
    assert torch.equal(xq, torch.round(x.float() / sx2))
    assert xq.abs().max() <= 127
    q, s = quantize_int4_grouped(torch.from_numpy(
        rng.standard_normal((k, n)).astype(np.float32)))
    wq, ws = pack_int4(q), s.t().contiguous()
    whole = tts.qmm4_plain(x, wq, ws)
    blocks = [tts.qmm4_rows_plain(xq, sx, wq[c0:c0 + 8], ws[c0:c0 + 8])
              for c0 in range(0, n, 8)]
    assert torch.equal(torch.cat(blocks, dim=1), whole)


@pytest.mark.parametrize("batch", [1, 4, 8, 32, 96])
@pytest.mark.parametrize("per_lane", [False, True])
def test_step_scratch_shapes(batch, per_lane):
    cfg = TTC()
    cap = 1024
    sc = tts.step_scratch(cfg, "cpu", batch, cap, per_lane)
    g = cfg.n_heads // cfg.n_kv_heads
    splits = batch * cfg.n_kv_heads * (cap // tts.SPLIT) * g
    assert sc["part"].numel() == splits * (cfg.head_dim + 2)
    assert sc["amax"].shape == (cfg.n_layers, 2, batch)
    assert sc["xq"].shape == (batch, cfg.d_model)
    assert sc["xq"].dtype == torch.int8
    assert sc["arrive"].shape == (batch * cfg.n_kv_heads,)
    assert not sc["arrive"].any() and not sc["barrier"].any()
    assert ("k_tok" in sc) == per_lane
    if per_lane:
        assert sc["k_tok"].shape == (cfg.n_layers, batch, cfg.n_kv_heads,
                                     cfg.head_dim)


@pytest.mark.parametrize("batch", [1, 4, 8, 32])
def test_frame_scratch_shapes(batch):
    cfg = TPC()
    sc = tpf.frame_scratch(cfg, "cpu", batch, blocks=132)
    assert sc["kc"].shape == (cfg.n_layers, batch, cfg.n_kv_heads,
                              tpf.N_TOKENS, cfg.head_dim)
    assert sc["ssq"].shape == (2, batch, 132)
    assert sc["best_v"].shape == sc["best_i"].shape == (batch, 132)
    assert sc["logits"].shape == (batch, tpf.N_TOKENS - 1, tpf.WINDOW)
    assert sc["arrive"].shape == (cfg.n_kv_heads,)
    assert not sc["arrive"].any() and not sc["barrier"].any()


def test_gates_of_the_redesigned_kernels():
    """w8a8's tensor-core dots take whole 64-byte blocks of K, the int8
    and bf16 modes whole 16-byte vectors, w4a8 256-row nibble groups; the
    predictor's tiles whole 64-value blocks; batches as before."""
    assert tts.supported(TTC(d_ff=6000 + 16), 8, "int8")
    assert "d_ff 6032 % 64" in tts.unsupported(TTC(d_ff=6032), 8, "w8a8")
    assert tts.supported(TTC(d_ff=6016), 8, "w8a8")
    assert "d_ff 6016 % 256" in tts.unsupported(TTC(d_ff=6016), 8, "w4a8")
    assert tpf.supported(TPC(), 1) and tpf.supported(TPC(), 32)
    assert "d_ff 3056 % 64" in tpf.unsupported(
        dataclasses.replace(TPC(), d_ff=3056), 8)
    assert "batch 33" in tpf.unsupported(TPC(), 33)
    assert "batch 5" in tts.unsupported(TTC(), 5)


def test_phase_labels():
    """196 phases a step (7 a layer) and 400 a frame (4 per token and layer,
    a head phase after tokens 1..15, the finish), at any batch."""
    t = tts.phase_labels(TTC())
    assert len(t) == 7 * 28 == 196
    assert t[:7] == ["norm1", "qkv", "attn", "wo", "norm2", "gate_up", "down"]
    p = tpf.phase_labels(TPC())
    assert len(p) == 16 * 6 * 4 + 15 + 1 == 400
    assert p.count("head") == 15 and p[-1] == "finish"
    assert p[24] == "qkv" and p[6 * 4 * 2] == "head"
