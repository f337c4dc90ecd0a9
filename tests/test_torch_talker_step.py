"""The port's talker-step module (qwen3_tts_tpu_torch/kernels/talker_step.py)
on the CPU: its weight prep and its plain version against the JAX
package's Pallas kernel (qwen3_tts_tpu/kernels/talker_step.py) run in
interpret mode, as tests/test_talker_kernel.py runs it, on the same seeded
numpy inputs and the same bf16 parameters.  Mostly in the default weight
mode, w4a8; the int8, w8a8 and bf16 modes at the end: their prep integers
equal JAX's from bf16 and from int8-dict weights, their plain steps agree
with the Pallas kernel within the tolerances of JAX
test_kernel_weight_modes_match_xla, and w8a8, whose dot is exact in
integers, bit for bit with excess precision off.

Both sides quantize to the same int4 weights (checked exactly) and take
the same integer group dots.  Under XLA's default
--xla_allow_excess_precision=true, the interpret-mode kernel skips some of
its own bf16 roundings inside XLA fusions (the MLP's), which the plain
version, like the JAX package's op-by-op code, performs.  So:

- with that flag off (a subprocess, since XLA reads its flags once per
  process), the plain version equals the Pallas kernel BIT FOR BIT:
  hidden state and every cache slot;
- in this process (default flags, as the tier-1 suite runs), layer 0's
  k/v row is bit-equal (it precedes any MLP), every untouched cache slot
  is bit-equal, and the hidden state (before the final norm) and the later
  layers' k/v rows are held to 5 % of the largest reference value: each
  skipped rounding moves a bf16 activation by up to half an ulp, which can
  move its int8 quantization by one step in the next matmul (measured:
  2.7 % at 2 layers).
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

from qwen3_tts_tpu.core.config import TalkerConfig as JTC
from qwen3_tts_tpu.kernels import talker_step as jts
from qwen3_tts_tpu.models import transformer as jtr
from qwen3_tts_tpu.ops.rope import inv_frequencies, mrope_cos_sin, section_ids
from qwen3_tts_tpu_torch.core.config import TalkerConfig as TTC
from qwen3_tts_tpu_torch.io.from_jax import talker_w4a8_from_jax, tree_to_torch
from qwen3_tts_tpu_torch.kernels import talker_step as tts
from qwen3_tts_tpu_torch.ops.quant import (pack_int4, quantize_int4_grouped,
                                           unpack_int4)

PCAP, CAP = 512, 1024
# tests/test_talker_kernel.py's config
CFG = dict(d_model=256, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=128,
           d_ff=256, mrope_sections=(24, 20, 20, 0), dtype="bfloat16")
REL_TOL = 0.05          # of max |reference|, default XLA flags


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = JTC(**CFG), TTC(**CFG)
    params = jtr.init_decoder_params(jcfg, jax.random.PRNGKey(0))
    jw = jax.tree_util.tree_map(
        np.asarray, jts.prep_layer_weights(jcfg, params, weights="w4a8"))
    tparams = tree_to_torch(jax.tree_util.tree_map(np.asarray, params))
    return jcfg, tcfg, params, jw, tparams


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a)).to(dtype)


def _jax_int4(jw, name):
    """Values of the JAX half-split packing, [L, K, N] in K order."""
    u = jw[name + "_q"].astype(np.uint8).astype(np.int16)
    q = np.concatenate([u & 0xF, (u >> 4) & 0xF], axis=-2)
    return np.where(q >= 8, q - 16, q)


def _rope(cfg, pos):
    inv = jnp.asarray(inv_frequencies(cfg.head_dim, cfg.rope_theta))
    sec = jnp.asarray(section_ids(cfg.mrope_sections))
    p = jnp.asarray(np.asarray(pos, np.int32)[:, None])
    cos, sin = mrope_cos_sin(jnp.stack([p, p, p, jnp.zeros_like(p)], -1),
                             inv, sec)
    return np.asarray(cos)[:, 0], np.asarray(sin)[:, 0]      # [B, Dh]


def _state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, CAP, cfg.head_dim)
    k = _bf16(rng.standard_normal(shape) * 0.3)
    v = _bf16(rng.standard_normal(shape) * 0.3)
    x = _bf16(rng.standard_normal((b, cfg.d_model)) * 0.3)
    return k, v, x


def _jax_step(setup, x, k, v, lengths, pos, mode="w4a8"):
    jcfg, _, params, _, _ = setup
    cos, sin = _rope(jcfg, [pos] * x.shape[0])
    h, k2, v2 = jts.talker_step_fused(
        jcfg, params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(cos),
        jnp.asarray(sin), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(lengths, jnp.int32),
        jnp.int32(pos), PCAP, interpret=True, weights=mode)
    return (np.asarray(h, np.float32), np.asarray(k2, np.float32),
            np.asarray(v2, np.float32))


def _port_step(setup, w, x, kc, vc, lengths, pos, mode="w4a8"):
    jcfg, tcfg = setup[0], setup[1]
    b = x.shape[0]
    cos, sin = _rope(jcfg, [pos] * b)
    return tts.talker_step_fused(
        tcfg, w, _t(x), _t(cos, torch.float32), _t(sin, torch.float32), kc,
        vc, torch.tensor(lengths, dtype=torch.int32),
        torch.full((b,), pos, dtype=torch.int32), PCAP, mode=mode)


def _assert_close(got, want, tol=REL_TOL):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_prep_matches_jax(setup):
    """The port's int4 values and bf16 scales equal the JAX prep's exactly,
    and io/from_jax converts the JAX prep into the port's own prep."""
    _, tcfg, _, jw, tparams = setup
    tw = tts.prep_layer_weights(tcfg, tparams)
    conv = talker_w4a8_from_jax(jw)
    for name in ("wqkv", "wo", "gu", "dn"):
        np.testing.assert_array_equal(unpack_int4(tw[name + "_q"]).numpy(),
                                      _jax_int4(jw, name), err_msg=name)
        np.testing.assert_array_equal(
            tw[name + "_s"].float().numpy(),
            np.asarray(jw[name + "_s"], np.float32).transpose(0, 2, 1),
            err_msg=name)
    for name, t in tw.items():
        assert conv[name].dtype == t.dtype and torch.equal(conv[name], t), name


def test_int4_packing_layout():
    """ops.quant's documented layout: byte j of each 4-byte word holds K
    row 8m+j (low nibble) and 8m+4+j (high nibble); unpack inverts pack."""
    col = torch.tensor([1, 2, 3, 4, 5, 6, 7, -7], dtype=torch.int8)[:, None]
    assert pack_int4(col)[0].tolist() == [0x51, 0x62, 0x73, 0x94]
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(-8, 8, (3, 256, 5)).astype(np.int8))
    assert torch.equal(unpack_int4(pack_int4(q)), q)
    w = torch.from_numpy(rng.standard_normal((256, 3)).astype(np.float32))
    qi, s = quantize_int4_grouped(w)
    assert qi.abs().max() <= 7 and s.shape == (2, 3) and s.dtype == torch.bfloat16


def _check_step(setup, b, decoded, exact, mode="w4a8", tol=REL_TOL):
    jcfg, tcfg, _, jw, tparams = setup
    lengths = [200, 512][:b]
    k, v, x = _state(jcfg, b, 10 + decoded)
    pos = PCAP + decoded
    want_h, want_k, want_v = _jax_step(setup, x, k, v, lengths, pos, mode)
    kc, vc = _t(k), _t(v)
    w = (talker_w4a8_from_jax(jw) if mode == "w4a8"
         else tts.prep_layer_weights(tcfg, tparams, mode))
    got = _port_step(setup, w, x, kc, vc, lengths, pos, mode)
    assert got.shape == (b, jcfg.d_model) and got.dtype == torch.bfloat16
    got_h = got.float().numpy()
    if exact:
        np.testing.assert_array_equal(got_h, want_h)
    else:
        _assert_close(got_h, want_h, tol)
    keep = np.arange(CAP) != pos
    for cache, want, orig in ((kc, want_k, k), (vc, want_v, v)):
        got_c = cache.float().numpy()
        np.testing.assert_array_equal(got_c[0, :, :, pos], want[0, :, :, pos])
        if exact:
            np.testing.assert_array_equal(got_c[:, :, :, pos],
                                          want[:, :, :, pos])
        else:
            _assert_close(got_c[:, :, :, pos], want[:, :, :, pos], tol)
        np.testing.assert_array_equal(got_c[:, :, :, keep],
                                      orig[:, :, :, keep])


@pytest.mark.parametrize("b,decoded", [(1, 0), (2, 0), (2, 3)])
def test_plain_step_matches_pallas(setup, b, decoded):
    _check_step(setup, b, decoded, exact=False)


def test_plain_two_chained_steps(setup):
    """Step t writes its k/v and step t+1 attends to it."""
    jcfg, _, _, jw, _ = setup
    k, v, x = _state(jcfg, 1, 5)
    lengths = [128]
    w = talker_w4a8_from_jax(jw)
    kc, vc = _t(k), _t(v)
    jk, jv = k, v
    for t in range(2):
        want_h, jk, jv = _jax_step(setup, x, jk, jv, lengths, PCAP + t)
        got = _port_step(setup, w, x, kc, vc, lengths, PCAP + t)
    _assert_close(got.float().numpy(), want_h)
    for cache, want in ((kc, jk), (vc, jv)):
        _assert_close(cache.float().numpy()[:, :, :, PCAP:PCAP + 2],
                      want[:, :, :, PCAP:PCAP + 2])


def exact_main():
    """Run by test_plain_step_bit_exact_without_excess_precision in a
    process whose XLA flags turn excess precision off."""
    cfg = JTC(**CFG)
    params = jtr.init_decoder_params(cfg, jax.random.PRNGKey(0))
    jw = jax.tree_util.tree_map(
        np.asarray, jts.prep_layer_weights(cfg, params, weights="w4a8"))
    tparams = tree_to_torch(jax.tree_util.tree_map(np.asarray, params))
    for mode in ("w4a8", "w8a8"):
        _check_step((cfg, TTC(**CFG), params, jw, tparams), 2, 3,
                    exact=True, mode=mode)
    print("bit-exact")


def test_plain_step_bit_exact_without_excess_precision():
    """w4a8 and w8a8: both take exact integer dots."""
    here = Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [str(here.parent), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c", "import test_torch_talker_step as t; "
         "t.exact_main()"], cwd=here, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("bit-exact")


def test_plain_step_per_lane_cursors_batch8(setup):
    """B = 8 with ragged per-lane cursors (continuous batching; the cases of
    tests/test_talker_kernel.py:314): the plain version in per-lane mode
    against the Pallas kernel's batched per-lane form within REL_TOL (its
    batched scores take bf16 inputs, the port's stay f32), every untouched
    slot bit for bit; and each lane bit-equal to the plain version at
    B = 1 on that lane alone."""
    jcfg, tcfg, params, jw, _ = setup
    b = 8
    lengths = [(96 * (i + 1)) % 512 or 512 for i in range(b)]
    starts = [PCAP + (3 * i) % 6 for i in range(b)]
    k, v, x = _state(jcfg, b, 21)
    cos, sin = _rope(jcfg, starts)
    jh, jk, jv = jts.talker_step_fused(
        jcfg, params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(cos),
        jnp.asarray(sin), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(lengths, jnp.int32),
        jnp.asarray(starts, jnp.int32), PCAP, interpret=True, weights="w4a8")
    w = talker_w4a8_from_jax(jw)
    kc, vc = _t(k), _t(v)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    got = tts.talker_step_fused(
        tcfg, w, _t(x), _t(cos, torch.float32), _t(sin, torch.float32), kc,
        vc, i32(lengths), i32(starts), PCAP, uniform_cursor=False)
    _assert_close(got.float().numpy(), np.asarray(jh, np.float32))
    for cache, want, orig in ((kc, jk, k), (vc, jv, v)):
        got_c, want = cache.float().numpy(), np.asarray(want, np.float32)
        for i, s in enumerate(starts):
            _assert_close(got_c[:, i, :, s], want[:, i, :, s])
            keep = np.arange(CAP) != s
            np.testing.assert_array_equal(got_c[:, i, :, keep],
                                          orig[:, i, :, keep])
    for i in range(b):
        k1, v1 = _t(k[:, i:i + 1]), _t(v[:, i:i + 1])
        one = tts.talker_step_fused(
            tcfg, w, _t(x[i:i + 1]), _t(cos[i:i + 1], torch.float32),
            _t(sin[i:i + 1], torch.float32), k1, v1, i32(lengths[i:i + 1]),
            i32(starts[i:i + 1]), PCAP)
        assert torch.equal(one[0], got[i]), i
        assert torch.equal(k1[:, 0], kc[:, i]) and torch.equal(v1[:, 0],
                                                               vc[:, i]), i


def test_supported_gate():
    assert tts.supported(TTC(), 1) and tts.supported(TTC(), 4)
    assert tts.supported(TTC(), 8) and tts.supported(TTC(), 96)
    assert tts.unsupported(TTC(), 5) == (
        "talker_step: batch 5 is not 1-4 or a multiple of 8 up to 96")
    assert "head_dim" in tts.unsupported(TTC.tiny(), 1)
    assert "d_ff" in tts.unsupported(TTC(d_ff=6000), 1)


def test_wrapper_routes_cpu_to_plain_and_rejects_other_devices(setup):
    jcfg, tcfg, _, jw, _ = setup
    w = talker_w4a8_from_jax(jw)
    k, v, x = _state(jcfg, 1, 0)
    before = tts.talker_step_fused.launches
    _port_step(setup, w, x, _t(k), _t(v), [100], PCAP)
    assert tts.talker_step_fused.launches == before
    meta = _t(x).to("meta")
    with pytest.raises(ValueError):
        tts.talker_step_fused(tcfg, w, meta, meta, meta, meta, meta, meta,
                              meta, PCAP)


# ---------------------------------------------------- int8, w8a8, bf16 modes
# tests/test_talker_kernel.py: test_kernel_weight_modes_match_xla (bf16,
# w8a8) and the int8 mode's test_kernel_matches_xla bound
MODE_TOL = {"int8": 0.05, "w8a8": 0.12, "bf16": 0.06}


@pytest.mark.parametrize("source", ["bf16", "int8"])
def test_prep_all_modes_equal_jax(setup, source):
    """Every mode's prep from bf16 layers and from int8 dicts
    (ops.quant.quantize_decoder_layers): the JAX prep's integers and
    scales, output-major; w4a8 from int8 re-quantizes q * s in f32."""
    from qwen3_tts_tpu.ops import quant as JQ
    jcfg, tcfg, params, _, _ = setup
    if source == "int8":
        params = dict(params,
                      layers=JQ.quantize_decoder_layers(params["layers"]))
    tparams = tree_to_torch(jax.tree_util.tree_map(np.asarray, params))
    for mode in tts.MODES:
        jw = jax.tree_util.tree_map(
            np.asarray, jts.prep_layer_weights(jcfg, params, weights=mode))
        tw = tts.prep_layer_weights(tcfg, tparams, mode)
        for name in ("wqkv", "wo", "gu", "dn"):
            q, sc = tw[name + "_q"], tw[name + "_s"]
            if mode == "w4a8":
                np.testing.assert_array_equal(unpack_int4(q).numpy(),
                                              _jax_int4(jw, name))
                np.testing.assert_array_equal(
                    sc.float().numpy(),
                    np.asarray(jw[name + "_s"], np.float32).transpose(0, 2, 1))
                continue
            assert q.dtype == (torch.bfloat16 if mode == "bf16"
                               else torch.int8), (mode, name)
            np.testing.assert_array_equal(
                q.float().numpy().transpose(0, 2, 1),
                np.asarray(jw[name + "_q"], np.float32), err_msg=mode)
            np.testing.assert_array_equal(
                sc.numpy(), np.asarray(jw[name + "_s"], np.float32))


@pytest.mark.parametrize("mode", ["int8", "w8a8", "bf16"])
def test_plain_step_modes_match_pallas(setup, mode):
    _check_step(setup, 2, 3, exact=False, mode=mode, tol=MODE_TOL[mode])


def test_modes_gate_and_dispatch(setup):
    """The mode gates; decoder_forward runs the packed mode's kernel, and
    the predictor's own "fused_int8" pack is not taken for a talker
    step."""
    assert tts.unsupported(TTC(), 1, "int4") == (
        "talker_step: mode 'int4' is not one of "
        "('w4a8', 'int8', 'w8a8', 'bf16')")
    assert tts.supported(TTC(d_ff=6000 + 16), 8, "int8")
    assert not tts.supported(TTC(d_ff=6000 + 16), 8, "w4a8")
    assert "above 8192" in tts.unsupported(TTC(d_ff=8192 + 256), 1, "w8a8")
    from qwen3_tts_tpu_torch.models import transformer as ttr
    jcfg, tcfg, _, _, tparams = setup
    assert tts.packed_mode({"fused_int8": {}}) is None
    assert tts.packed_mode({"fused_w4a8": {}}) == "w4a8"
    k, v, x = _state(jcfg, 1, 3)
    for mode in tts.MODES:
        p = dict(tparams, talker_step_mode=mode, **{
            "fused_" + mode: tts.prep_layer_weights(tcfg, tparams, mode)})
        assert tts.packed_mode(p) == mode
        cache = ttr.KVCache(_t(k), _t(v),
                            torch.tensor([PCAP], dtype=torch.int32),
                            torch.tensor([100], dtype=torch.int32))
        cos, sin = _rope(jcfg, [PCAP])
        h, _ = ttr.decoder_forward(tcfg, p, _t(x)[:, None],
                                   _t(cos, torch.float32)[:, None],
                                   _t(sin, torch.float32)[:, None], cache,
                                   PCAP)
        want = tts.talker_step_plain(
            tcfg, p["fused_" + mode], _t(x), _t(cos, torch.float32),
            _t(sin, torch.float32), _t(k), _t(v),
            torch.tensor([100], dtype=torch.int32),
            torch.tensor([PCAP], dtype=torch.int32), PCAP, mode)
        from qwen3_tts_tpu_torch.ops.norms import rms_norm
        assert torch.equal(h[:, 0], rms_norm(want, p["final_norm"],
                                             tcfg.rms_eps)), mode
