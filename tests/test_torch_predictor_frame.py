"""The port's predictor-frame module
(qwen3_tts_tpu_torch/kernels/predictor_frame.py) on the CPU: its int8
weight prep and its plain version against the JAX package's Pallas kernel
(qwen3_tts_tpu/kernels/predictor_frame.py) run in interpret mode, as
tests/test_predictor_kernel.py runs it, on the same seeded numpy inputs
and the same bf16 parameters.

Codes.  The int8 matmuls sum bf16 x int8 products in f32 in another
order than XLA, and under XLA's default --xla_allow_excess_precision=true
the interpret-mode kernel also skips some of its bf16 roundings inside
fusions (see tests/test_torch_talker_step.py).  Both move the window
logits in their last bits, so a greedy argmax over 2048 random logits can
flip at a near-tie, after which every later token of that lane follows
another code.  The policy is that of tests/test_chunk_kernel.py: along
each lane, codes must be equal token after token, and the first token
where they differ must be one whose top-2 logit gap (in the plain
version's logits) is at most GAP = 0.05; the comparison of that lane stops
there.  (Flips seen while writing this test: at gaps of 0.0015-0.014.)
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.core.config import PredictorConfig as JPC
from qwen3_tts_tpu.kernels import predictor_frame as jpf
from qwen3_tts_tpu.models import predictor as jpred
from qwen3_tts_tpu.ops.quant import quantize_weight as jquant
from qwen3_tts_tpu_torch.core.config import PredictorConfig as TPC
from qwen3_tts_tpu_torch.io.from_jax import tree_to_torch
from qwen3_tts_tpu_torch.kernels import predictor_frame as tpf

# tests/test_predictor_kernel.py's config
CFG = dict(d_model=128, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=64,
           d_ff=256, dtype="bfloat16")
GAP = 0.05      # a flip is allowed only where the top-2 gap is below this


def _setup():
    jcfg, tcfg = JPC(**CFG), TPC(**CFG)
    params = jpred.init_predictor_params(jcfg, jax.random.PRNGKey(0))
    tparams = tree_to_torch(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(1)
    tables = np.asarray(jnp.asarray(
        rng.standard_normal((16, 2048, 128)) * 0.3,
        jnp.bfloat16).astype(jnp.float32))
    return jcfg, tcfg, params, tparams, tables


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, 128)).astype(np.float32)
    c0 = ((np.arange(b) * 977 + seed * 131) % 2048).astype(np.int32)
    return h, c0


def _jax_codes(setup, h, c0):
    jcfg, _, params, _, tables = setup
    return np.asarray(jpf.predict_frame_fused(
        jcfg, params, jnp.asarray(h), jnp.asarray(c0),
        jnp.asarray(tables, jnp.bfloat16), interpret=True))


def _port_codes(setup, h, c0, taps=None):
    _, tcfg, _, tparams, tables = setup
    w = tpf.prep_predictor_weights(tcfg, tparams)
    return tpf.predict_frame_plain(
        tcfg, w, torch.from_numpy(h), torch.from_numpy(c0),
        torch.from_numpy(tables.copy()).to(torch.bfloat16),
        taps=taps).numpy()


def _assert_codes_match(got, want, taps):
    """The lane-wise prefix policy of the module docstring; returns the
    number of (lane, token) codes found equal."""
    assert (got[:, 0] == want[:, 0]).all()
    equal = 0
    for lane in range(got.shape[0]):
        for t in range(1, got.shape[1]):
            if got[lane, t] == want[lane, t]:
                equal += 1
                continue
            top2 = np.sort(taps[t - 1][lane].numpy())[-2:]
            assert top2[1] - top2[0] <= GAP, (lane, t, top2)
            break
    return equal


def test_prep_matches_jax(setup):
    """int8 weights and f32 scales equal the JAX prep's once its q-head
    permutation is undone; the lm-head equals its per-row quantization."""
    jcfg, tcfg, params, tparams, _ = setup
    _check_prep(jcfg, tcfg, params, tparams)


def test_prep_from_int8_weights_matches_jax(setup):
    """From int8-dict engine weights (ops.quant.quantize_decoder_layers and
    quantize_head) both preps pass the integers through unchanged."""
    from qwen3_tts_tpu.ops import quant as JQ
    jcfg, tcfg, params, _, _ = setup
    q8 = dict(params, layers=JQ.quantize_decoder_layers(params["layers"]),
              lm_head=JQ.quantize_head(params["lm_head"]))
    _check_prep(jcfg, tcfg, q8,
                tree_to_torch(jax.tree_util.tree_map(np.asarray, q8)))


def _check_prep(jcfg, tcfg, params, tparams):
    jw = jax.tree_util.tree_map(np.asarray,
                                jpf._prep_layer_weights(jcfg, params))
    tw = tpf.prep_predictor_weights(tcfg, tparams)
    h, hkv, dh = jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    dq = h * dh
    perm = jpf._head_perm(h, hkv, dh)

    def unperm_cols(a):           # [..., N]: q columns back in head order
        out = a.copy()
        out[..., perm] = a[..., :dq]
        return out

    want_q = {"wqkv": unperm_cols(jw["wqkv_q"]), "gu": jw["gu_q"],
              "dn": jw["dn_q"]}
    wo = jw["wo_q"].copy()
    wo[:, perm] = jw["wo_q"][:, :dq]
    want_q["wo"] = wo
    for name, q in want_q.items():
        np.testing.assert_array_equal(
            tw[name + "_q"].numpy(), q.transpose(0, 2, 1), err_msg=name)
    np.testing.assert_array_equal(tw["wqkv_s"].numpy(),
                                  unperm_cols(jw["wqkv_s"][:, 0]))
    for name in ("wo", "gu", "dn"):
        np.testing.assert_array_equal(tw[name + "_s"].numpy(),
                                      jw[name + "_s"][:, 0], err_msg=name)
    head = params["lm_head"]
    if not isinstance(head, dict):
        head = jquant(head, axis=-1)
    np.testing.assert_array_equal(tw["head_q"].numpy(),
                                  np.asarray(head["q"]))
    np.testing.assert_array_equal(tw["head_s"].numpy(),
                                  np.asarray(head["s"]))


@pytest.mark.parametrize("b,seed", [(2, 2), (3, 4)])
def test_plain_frame_matches_pallas(setup, b, seed):
    h, c0 = _inputs(b, seed)
    taps = []
    got = _port_codes(setup, h, c0, taps)
    want = _jax_codes(setup, h, c0)
    assert got.shape == want.shape == (b, 16) and got.dtype == np.int32
    assert (got[:, 1:] >= 0).all() and (got[:, 1:] < 2048).all()
    assert _assert_codes_match(got, want, taps) >= 4 * b


def test_plain_frame_lane_isolation(setup):
    """B = 3 with lanes 0 and 2 identical and lane 1 different: the
    duplicated lanes give identical codes and logits, and lane 1's input
    changes nothing in them."""
    h, c0 = _inputs(3, 6)
    h[2], c0[2] = h[0], c0[0]
    taps = []
    got = _port_codes(setup, h, c0, taps)
    np.testing.assert_array_equal(got[0], got[2])
    for lg in taps:
        np.testing.assert_array_equal(lg[0].numpy(), lg[2].numpy())
    h2, c02 = h.copy(), c0.copy()
    h2[1], c02[1] = -h[1], (c0[1] + 1) % 2048
    taps2 = []
    got2 = _port_codes(setup, h2, c02, taps2)
    np.testing.assert_array_equal(got2[[0, 2]], got[[0, 2]])
    assert not np.array_equal(got2[1], got[1])


def test_supported_gate():
    assert tpf.supported(TPC(), 1) and tpf.supported(TPC(), 32)
    assert tpf.unsupported(TPC(), 33) == \
        "predictor_frame: batch 33 outside [1, 32]"
    assert "head_dim" in tpf.unsupported(TPC.tiny(), 1)


def test_wrapper_routes_cpu_to_plain_and_rejects_other_devices(setup):
    _, tcfg, _, tparams, tables = setup
    w = tpf.prep_predictor_weights(tcfg, tparams)
    h, c0 = _inputs(1, 0)
    before = tpf.predict_frame_fused.launches
    got = tpf.predict_frame_fused(tcfg, w, torch.from_numpy(h),
                                  torch.from_numpy(c0),
                                  torch.from_numpy(tables.copy()))
    assert tpf.predict_frame_fused.launches == before
    np.testing.assert_array_equal(got.numpy(), _port_codes(setup, h, c0))
    meta = torch.zeros(1, 128, device="meta")
    with pytest.raises(ValueError):
        tpf.predict_frame_fused(tcfg, w, meta, meta, meta)
