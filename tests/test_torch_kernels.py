"""The port's attention kernel modules on the CPU: each plain version
against the JAX Pallas kernel run in interpret mode, as the JAX package's
own kernel tests run it (tests/test_flash_prefill.py,
tests/test_flash_decode.py), on the same seeded numpy inputs.

Tolerances: prefill atol/rtol 2e-2 (the Pallas kernel rounds p to bf16 for
P.V and returns bf16; the plain version works in f32 on the same bf16
inputs); decode 2e-3 (both f32 throughout, only summation order differs).
The CUDA kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.kernels import flash_decode as jd
from qwen3_tts_tpu.kernels import flash_prefill as jp
from qwen3_tts_tpu_torch.kernels import flash_decode as td
from qwen3_tts_tpu_torch.kernels import flash_prefill as tp
from qwen3_tts_tpu_torch.ops.attention import history_mask

QT = jp.QTILE


def _bf16(rng, shape, scale=0.3):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _t(x, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(x)).to(dtype)


def _i(x):
    return torch.tensor(x, dtype=torch.int32)


@pytest.mark.parametrize("case", ["fresh", "padded", "suffix", "generated"])
def test_prefill_plain_matches_pallas(case):
    b, s, h, hkv, dh, n_layers, cap = 2, QT, 4, 2, 128, 2, 4 * QT
    rng = np.random.default_rng(0)
    q = _bf16(rng, (b, s, h, dh))
    k = _bf16(rng, (n_layers, b, hkv, cap, dh))
    v = _bf16(rng, (n_layers, b, hkv, cap, dh))
    if case == "fresh":
        lengths, start, prompt_cap, window = [s, s], 0, s, s
    elif case == "padded":
        lengths, start, prompt_cap, window = [s, QT // 2], 0, s, s
    elif case == "suffix":
        lengths, start, prompt_cap, window = ([QT + s, QT + s // 2], QT,
                                              2 * QT + s, 4 * QT)
    else:
        lengths, start, prompt_cap, window = [QT // 2, 9], QT, QT, 4 * QT
    want = jp.flash_gqa_prefill_stacked(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(lengths, jnp.int32),
        jnp.int32(start), jnp.int32(1), prompt_cap, window, interpret=True)
    got = tp.flash_gqa_prefill_stacked(
        _t(q), _t(k), _t(v), _i(lengths), _i([start] * b), 1, prompt_cap,
        window)
    assert got.shape == (b, s, h, dh) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("cap,prompt_cap,cursors,lengths", [
    (512, 128, [128, 200], [100, 128]),
    (1024, 512, [512 + 13, 1023], [40, 511]),
])
def test_decode_plain_matches_pallas(cap, prompt_cap, cursors, lengths):
    b, h, hkv, dh, n_layers = 2, 8, 4, 128, 3
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((n_layers, b, hkv, cap, dh)).astype(np.float32)
    v = rng.standard_normal((n_layers, b, hkv, cap, dh)).astype(np.float32)
    want = jd.flash_gqa_decode_stacked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths, jnp.int32), jnp.asarray(cursors, jnp.int32),
        jnp.int32(2), prompt_cap, interpret=True)
    got = td.flash_gqa_decode_stacked(
        _t(q, torch.float32), _t(k, torch.float32), _t(v, torch.float32),
        _i(lengths), _i(cursors), 2, prompt_cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


def test_decode_plain_ignores_poisoned_slots():
    """Slots in [length, prompt_cap) and past the cursor never leak."""
    b, h, hkv, dh, cap, prompt_cap = 1, 4, 2, 64, 300, 128
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, b, hkv, cap, dh))
                         .astype(np.float32))
    v = k.clone() * 0.5
    lengths, cursor = _i([40]), _i([prompt_cap + 2])
    base = td.flash_gqa_decode_stacked(q, k, v, lengths, cursor, 0,
                                       prompt_cap)
    for t, val in ((k, 1e3), (v, 1e3)):
        t[:, :, :, 40:prompt_cap] = val
        t[:, :, :, prompt_cap + 3:] = -val
    poisoned = td.flash_gqa_decode_stacked(q, k, v, lengths, cursor, 0,
                                           prompt_cap)
    np.testing.assert_array_equal(base.numpy(), poisoned.numpy())


def test_prefill_plain_ignores_poisoned_slots():
    """Padding rows of a short lane and slots past the causal bound never
    leak into the real rows."""
    b, s, h, hkv, dh, cap = 1, 32, 4, 2, 16, 64
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((b, s, h, dh))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, b, hkv, cap, dh))
                         .astype(np.float32))
    v = k.clone()
    lengths, start = _i([20]), _i([0])
    base = tp.flash_gqa_prefill_stacked(q, k, v, lengths, start, 0, s, s)
    k[:, :, :, 20:] = 1e3
    v[:, :, :, 20:] = -1e3
    poisoned = tp.flash_gqa_prefill_stacked(q, k, v, lengths, start, 0, s, s)
    np.testing.assert_array_equal(base[:, :20].numpy(),
                                  poisoned[:, :20].numpy())


@pytest.mark.parametrize("lengths,prompt_cap,start,s", [
    ([5, 32], 32, [0, 0], 32),          # padded short prompt, fresh prefill
    ([20, 20], 64, [64, 64], 1),        # decode: slots [length, prompt_cap)
    ([7, 30], 32, [33, 40], 1),         # decode past the cursor is dead
    ([10, 12], 48, [16, 16], 8),        # suffix rows at a cursor
])
def test_kernel_masks_equal_history_mask(lengths, prompt_cap, start, s):
    """The kernels' validity rules (flash_decode.cu, flash_prefill.cu),
    written out on the host, equal ops.attention.history_mask."""
    cap = 96
    c = np.arange(cap)[None, None, :]
    st = np.asarray(start)[:, None, None]
    ln = np.asarray(lengths)[:, None, None]
    a = st + np.arange(s)[None, :, None]
    if s == 1:     # decode rule
        rule = (c <= st) & ((c < ln) | (c >= prompt_cap) | (c == st))
    else:          # prefill rule, window = max(prompt_cap, s)
        window = max(prompt_cap, s)
        rule = ((c < window) & (c <= a)
                & ((c < ln) | (c >= prompt_cap) | (c == a)))
    want = history_mask(_i(lengths), prompt_cap, _i(start), s, cap).numpy()
    if s > 1:
        want = want & (c < max(prompt_cap, s))
    np.testing.assert_array_equal(rule, want)


def test_wrappers_route_cpu_to_plain_and_reject_other_devices():
    q = torch.zeros(1, 4, 16)
    k = torch.zeros(1, 1, 2, 8, 16)
    before = (td.flash_gqa_decode_stacked.launches,
              tp.flash_gqa_prefill_stacked.launches)
    td.flash_gqa_decode_stacked(q, k, k, _i([3]), _i([3]), 0, 0)
    tp.flash_gqa_prefill_stacked(q[:, None], k, k, _i([3]), _i([0]), 0, 0, 1)
    assert (td.flash_gqa_decode_stacked.launches,
            tp.flash_gqa_prefill_stacked.launches) == before
    meta = q.to("meta")
    with pytest.raises(ValueError):
        td.flash_gqa_decode_stacked(meta, k.to("meta"), k.to("meta"),
                                    _i([3]), _i([3]), 0, 0)
    with pytest.raises(ValueError):
        tp.flash_gqa_prefill_stacked(meta[:, None], k.to("meta"),
                                     k.to("meta"), _i([3]), _i([0]), 0, 0, 1)
