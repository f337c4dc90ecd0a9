"""The port's quantized weights and their matmuls (qwen3_tts_tpu_torch/ops/
quant.py, kernels/int4_matmul.py, kernels/flash_decode.flash_gqa_decode)
against the JAX package's ops/quant.py and its Pallas kernels
(kernels/int4_matmul.matmul_int4, kernels/flash_decode.flash_gqa_decode)
run in interpret mode, on the same seeded numpy inputs:

- quantize_weight / quantize_head / quantize_decoder_layers /
  quantize_weight_int4: the same integers and f32 scales (int4 through the
  io/from_jax layout adapter);
- matmul on int8 weights within one bf16 ulp of JAX's;
- matmul_a8: the int8 x int8 product exact in int32, the output within
  one bf16 ulp of JAX's;
- matmul_int4's plain version within 1e-4 * max|y| of the Pallas kernel
  (its body, `_kernel`, in interpret mode on the JAX function's own grid
  and blocks; x is handed to it as f32 holding the bf16 values, because
  XLA on the CPU has no bf16 x bf16 -> f32 dot, which the JAX function's
  bf16 x would need; the products and f32 sums are the same);
- flash_gqa_decode's plain version within one bf16 ulp of the Pallas
  kernel, at a scalar and at a per-lane write_idx.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from qwen3_tts_tpu.kernels.flash_decode import flash_gqa_decode as j_decode
from qwen3_tts_tpu.kernels import int4_matmul as JI
from qwen3_tts_tpu.ops import quant as JQ
from qwen3_tts_tpu_torch.io.from_jax import int4_from_jax, tree_to_torch
from qwen3_tts_tpu_torch.kernels import flash_decode as TD
from qwen3_tts_tpu_torch.kernels import int4_matmul as TI
from qwen3_tts_tpu_torch.ops import quant as TQ

torch.set_num_threads(1)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(a):
    """One bf16 ulp at each |a| (2^(e - 7))."""
    a = np.abs(np.asarray(a, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(a, 1e-30))) - 7)


def _within_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert (np.abs(got - want) <= _bf16_ulp(want)).all(), \
        np.abs(got - want).max()


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 256, 384)).astype(np.float32) * 0.05
    head = rng.standard_normal((500, 256)).astype(np.float32) * 0.05
    return w, head


def test_int8_quantizers_equal_jax(weights):
    w, head = weights
    for got, want in ((TQ.quantize_weight(torch.from_numpy(w)),
                       JQ.quantize_weight(jnp.asarray(w))),
                      (TQ.quantize_head(torch.from_numpy(head)),
                       JQ.quantize_head(jnp.asarray(head)))):
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    layers = {"ln1": np.ones((3, 256), np.float32), "wqkv": w, "wo": w,
              "w_gate_up": w, "w_down": w}
    got = TQ.quantize_decoder_layers({k: torch.from_numpy(v)
                                      for k, v in layers.items()})
    want = jax.tree_util.tree_map(
        np.asarray, JQ.quantize_decoder_layers(
            {k: jnp.asarray(v) for k, v in layers.items()}))
    assert TQ.is_quantized(got["wo"]) and not TQ.is_int4(got["wo"])
    for name in ("wqkv", "w_down"):
        for k in ("q", "s"):
            np.testing.assert_array_equal(got[name][k].numpy(),
                                          want[name][k])
    assert torch.equal(got["ln1"], torch.from_numpy(layers["ln1"]))


@pytest.mark.parametrize("group", [64, 128])
def test_int4_quantizer_equals_jax_through_adapter(weights, group):
    w = weights[0]
    got = TQ.quantize_weight_int4(torch.from_numpy(w), group=group)
    want = JQ.quantize_weight_int4(jnp.asarray(w), group=group)
    conv = int4_from_jax(jax.tree_util.tree_map(np.asarray, want))
    assert TQ.is_int4(got) and TQ.is_quantized(got)
    assert got["q4"].shape == (3, 384, 128) and got["s"].shape == (
        3, 384, 256 // group)
    assert torch.equal(got["q4"], conv["q4"])
    assert torch.equal(got["s"], conv["s"])
    np.testing.assert_array_equal(
        TQ.unpack_int4(got["q4"]).numpy(),
        np.asarray(JQ._unpack_int4({"q4": want["q4"],
                                    "s": jnp.ones_like(want["s"])},
                                   jnp.float32)).astype(np.int8))


def test_matmul_int8_within_one_bf16_ulp(weights):
    w = weights[0][0]
    x = np.random.default_rng(1).standard_normal((2, 5, 256)) * 0.5
    xb = jnp.asarray(x, jnp.bfloat16)
    jw = JQ.quantize_weight(jnp.asarray(w))
    want = JQ.matmul(xb, jw)
    got = TQ.matmul(torch.from_numpy(_np(xb).copy()).bfloat16(),
                    tree_to_torch(jax.tree_util.tree_map(np.asarray, jw)))
    assert got.dtype == torch.bfloat16
    _within_ulp(got.float().numpy(), _np(want))
    plain = TQ.matmul(torch.from_numpy(x).float(), torch.from_numpy(w))
    np.testing.assert_allclose(plain.numpy(), x @ w, rtol=1e-4, atol=1e-5)


def test_matmul_a8_exact_product_and_output(weights):
    w = weights[0][1]
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (40, 256)).astype(np.int8)
    b = rng.integers(-127, 128, (256, 384)).astype(np.int8)
    np.testing.assert_array_equal(
        TQ._int8_mm(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        a.astype(np.int64) @ b.astype(np.int64))
    for dtype in (jnp.bfloat16, jnp.float32):
        x = jnp.asarray(rng.standard_normal((2, 33, 256)), dtype)
        jw = JQ.quantize_weight(jnp.asarray(w))
        want = JQ.matmul_a8(x, jw)
        tx = torch.from_numpy(_np(x).copy()).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        got = TQ.matmul_a8(tx, tree_to_torch(
            jax.tree_util.tree_map(np.asarray, jw)))
        assert got.dtype == tx.dtype and got.shape == (2, 33, 384)
        _within_ulp(got.float().numpy(), _np(want))
    # plain and int4 weights take matmul, as in JAX
    xt = torch.ones(3, 256)
    wt = torch.from_numpy(w)
    assert torch.equal(TQ.matmul_a8(xt, wt), TQ.matmul(xt, wt))


def _pallas_int4(x, w4):
    """JAX matmul_int4's pallas_call (int4_matmul.py:78-104) in interpret
    mode, with x [M, K] (bf16 values) in f32 (module docstring)."""
    q4, s = w4["q4"], w4["s"]
    k_half, n = q4.shape
    groups = s.shape[0]
    m = x.shape[0]
    m_pad = max(8, -(-m // 8) * 8)
    xm = jnp.pad(jnp.asarray(x, jnp.float32), ((0, m_pad - m), (0, 0)))
    bn = JI._block_n(n)
    out = pl.pallas_call(
        functools.partial(JI._kernel, groups=groups),
        grid=(n // bn,),
        in_specs=[pl.BlockSpec((m_pad, k_half), lambda j: (0, 0)),
                  pl.BlockSpec((m_pad, k_half), lambda j: (0, 0)),
                  pl.BlockSpec((k_half, bn), lambda j: (0, j)),
                  pl.BlockSpec((groups, bn), lambda j: (0, j))],
        out_specs=pl.BlockSpec((m_pad, bn), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((m_pad, n), jnp.float32),
        interpret=True,
    )(xm[:, 0::2], xm[:, 1::2], q4, s)
    return np.asarray(out[:m])


@pytest.mark.parametrize("m", [1, 8, 33])
def test_matmul_int4_plain_matches_pallas(weights, m):
    w = weights[0][2]
    x = jnp.asarray(np.random.default_rng(3).standard_normal((m, 256)),
                    jnp.bfloat16)
    jw = JQ.quantize_weight_int4(jnp.asarray(w), group=128)
    want = _pallas_int4(_np(x), jw)
    tw = int4_from_jax(jax.tree_util.tree_map(np.asarray, jw))
    before = TI.matmul_int4.launches
    tx = torch.from_numpy(_np(x).copy()).bfloat16()
    got = TI.matmul_int4(tx, tw)
    assert TI.matmul_int4.launches == before     # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (m, 384)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err
    # ops.quant.matmul routes int4 weights here, in x's dtype
    y = TQ.matmul(tx, tw)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, got.to(torch.bfloat16))


def test_matmul_int4_gate():
    w = TQ.quantize_weight_int4(torch.randn(256, 64), group=64)
    assert TI.unsupported(torch.zeros(1, 256), w) is None
    assert "columns" in TI.unsupported(torch.zeros(1, 128), w)
    w16 = TQ.quantize_weight_int4(torch.randn(64, 16), group=16)
    assert "group" in TI.unsupported(torch.zeros(1, 64), w16)
    with pytest.raises(ValueError):
        TI.matmul_int4(torch.zeros(1, 256, device="meta"), w)


@pytest.mark.parametrize("m,n,k,want", [
    (1, 2048, 2048, (0, 0)),            # decode: the CUDA-core kernel
    (TI.TILE_MIN_M - 1, 2048, 2048, (0, 0)),
    (TI.TILE_MIN_M, 2048, 2048, (1, 8)),     # 32 output tiles: K in 8
    (32, 4096, 2048, (1, 6)),           # the prompt bucket 32
    (32, 12288, 2048, (1, 2)),          # 192 tiles: K in 2
    (33, 2048, 6144, (2, 12)),
    (128, 12288, 2048, (4, 1)),         # 192 tiles fill the card
    (129, 2048, 2048, (4, 4)),          # two row tiles of 128
    (16, 2048, 64, (1, 1)),             # one K step: nothing to split
])
def test_matmul_int4_dispatch(m, n, k, want):
    """plan: which kernel takes which M (the small-M kernel below
    TILE_MIN_M, then the tensor-core tile kernel at BM = 32 * mi rows) and
    how far K is split so that the CTAs fill an H100's 132 SMs."""
    assert TI.plan(m, n, k, 132) == want
    assert TI.tile_plan(m, n, k, 132)[0] == (1 if m <= 32 else
                                             2 if m <= 64 else 4)
    # a card of fewer SMs splits K no further
    assert TI.tile_plan(m, n, k, 66)[1] <= TI.tile_plan(m, n, k, 132)[1]


def test_matmul_int4_gates_by_kernel():
    """K above MAX_K is refused only where the small-M kernel, which keeps
    x's rows in shared memory, would take it; unsupported() names it."""
    k = TI.MAX_K + 128
    w = {"q4": torch.zeros(64, k // 2, dtype=torch.uint8),
         "s": torch.ones(64, k // 128)}
    assert "above" in TI.unsupported(torch.zeros(1, k), w)
    assert "above" in TI.unsupported(torch.zeros(TI.TILE_MIN_M - 1, k), w)
    assert TI.unsupported(torch.zeros(TI.TILE_MIN_M, k), w) is None
    assert TI.unsupported(torch.zeros(2, 3, k), w) is None  # 6 rows: tile
    assert TI.unsupported(torch.zeros(1, TI.MAX_K), {
        "q4": torch.zeros(64, TI.MAX_K // 2, dtype=torch.uint8),
        "s": torch.ones(64, TI.MAX_K // 128)}) is None
    assert "K=100" in TI.unsupported(
        torch.zeros(1, 100), {"q4": torch.zeros(8, 50, dtype=torch.uint8),
                              "s": torch.ones(8, 1)})
    # a CPU tensor takes the plain version whatever the gate
    counts = ("launches", "tile_launches", "splitk_launches")
    before = [getattr(TI.matmul_int4, c) for c in counts]
    y = TI.matmul_int4(torch.zeros(1, k), w)
    assert y.shape == (1, 64)
    assert [getattr(TI.matmul_int4, c) for c in counts] == before


@pytest.mark.parametrize("b,hq,hkv,dh,cap,prompt_cap,per_lane", [
    (1, 4, 2, 64, 640, 96, False),
    (2, 8, 4, 128, 1024, 512, False),
    (3, 8, 2, 128, 1024, 128, True),
])
def test_flash_gqa_decode_plain_matches_pallas(b, hq, hkv, dh, cap,
                                               prompt_cap, per_lane):
    rng = np.random.default_rng(b)
    q = jnp.asarray(rng.standard_normal((b, hq, dh)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((b, hkv, cap, dh)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, hkv, cap, dh)), jnp.bfloat16)
    lengths = rng.integers(4, prompt_cap, b).astype(np.int32)
    if per_lane:
        wi = (prompt_cap + np.array([0, 17, 300])[:b]).astype(np.int32)
        jwi, twi = jnp.asarray(wi), torch.from_numpy(wi)
    else:
        jwi, twi = jnp.int32(prompt_cap + 13), prompt_cap + 13
    want = _np(j_decode(q, k, v, jnp.asarray(lengths), jwi, prompt_cap,
                        interpret=True))
    t = lambda a: torch.from_numpy(_np(a).copy()).bfloat16()
    before = TD.flash_gqa_decode.launches
    got = TD.flash_gqa_decode(t(q), t(k), t(v), torch.from_numpy(lengths),
                              twi, prompt_cap)
    assert TD.flash_gqa_decode.launches == before
    assert got.shape == (b, hq, dh) and got.dtype == torch.bfloat16
    _within_ulp(got.float().numpy(), want)
    # the stacked entry on a one-layer stack is the same attention
    st = TD.flash_gqa_decode_stacked(
        t(q), t(k)[None], t(v)[None], torch.from_numpy(lengths),
        torch.as_tensor(twi, dtype=torch.int32).expand(b).contiguous(), 0,
        prompt_cap)
    assert torch.equal(st, got)
