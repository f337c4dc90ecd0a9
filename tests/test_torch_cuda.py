"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build the kernels from
qwen3_tts_tpu_torch/csrc); elsewhere they skip.  They import torch only, so
they run on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances.  Prefill: the kernel rounds p to bf16 for the P.V product
while the plain version works in f32 throughout, so outputs of O(1) agree
to a few bf16 ulps: atol/rtol 2e-2.  Decode: the kernel does all its
arithmetic in f32, as the plain version does, and rounds only its output
to bf16 (round to nearest).  It is therefore held against the plain
version's f32 result on the same (bf16-exact) inputs to half a bf16 ulp,
which is at most 2^-8 of the value, plus 1e-5 for f32 summation order:
rtol 2^-8, atol 1e-5.  A slot dropped or added at a long cursor, or scores
rounded to bf16, move the small outputs there by more than that.
"""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.kernels.flash_decode import (
    decode_attention_plain, flash_gqa_decode_stacked)
from qwen3_tts_tpu_torch.kernels.flash_prefill import (
    flash_gqa_prefill_stacked, prefill_attention_plain)

pytestmark = pytest.mark.cuda

DECODE_RTOL, DECODE_ATOL = 2.0 ** -8, 1e-5   # half a bf16 ulp; f32 order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc)")
    return torch.device("cuda")


def _cache(rng, n_layers, b, hkv, cap, dh, dev):
    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * 0.5).to(dev, torch.bfloat16)
    return t((n_layers, b, hkv, cap, dh)), t((n_layers, b, hkv, cap, dh)), t


def _i32(x, dev):
    return torch.tensor(x, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("s,window,dh,h,hkv,start,prompt_cap,lengths", [
    (128, 128, 128, 16, 8, 0, 128, [128, 37]),      # talker bucket 128
    (32, 32, 128, 16, 8, 0, 32, [21, 32]),          # talker bucket 32
    (33, 40, 128, 16, 8, 0, 33, [33, 5]),           # ragged tiles
    (96, 512, 128, 16, 8, 64, 256, [160, 100]),     # suffix at a cursor
    (64, 384, 128, 16, 8, 128, 128, [128, 70]),     # generated region
    (2, 2, 64, 16, 8, 0, 0, [0, 0]),                # predictor prefill
    (200, 256, 64, 8, 2, 0, 200, [200, 150]),       # G=4, dh 64
])
def test_prefill_kernel_matches_plain(dev, s, window, dh, h, hkv, start,
                                      prompt_cap, lengths):
    rng = np.random.default_rng(s + window)
    b, n_layers, cap = 2, 3, max(window, 17)
    k, v, t = _cache(rng, n_layers, b, hkv, cap, dh, dev)
    q = t((b, s, h, dh))
    lengths = _i32(lengths, dev)
    start = _i32([start] * b, dev)
    got = flash_gqa_prefill_stacked(q, k, v, lengths, start, 1, prompt_cap,
                                    window)
    torch.cuda.synchronize()
    want = prefill_attention_plain(q, k, v, lengths, start, 1, prompt_cap,
                                   window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_prefill_kernel_long_prompt(dev):
    rng = np.random.default_rng(7)
    b, s, h, hkv, dh = 1, 4096, 16, 8, 128
    k, v, t = _cache(rng, 1, b, hkv, s, dh, dev)
    q = t((b, s, h, dh))
    lengths = _i32([4000], dev)
    start = _i32([0], dev)
    got = flash_gqa_prefill_stacked(q, k, v, lengths, start, 0, s, s)
    want = prefill_attention_plain(q, k, v, lengths, start, 0, s, s)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("dh,h,hkv,cap,prompt_cap,cursors,lengths", [
    (128, 16, 8, 1024, 128, [128, 129], [100, 128]),
    (128, 16, 8, 1024, 32, [200, 1023], [32, 9]),
    (128, 16, 8, 777, 64, [64, 700], [60, 1]),      # C not a tile multiple
    (64, 16, 8, 17, 0, [2, 15], [0, 0]),            # predictor decode
])
def test_decode_kernel_matches_plain(dev, dh, h, hkv, cap, prompt_cap,
                                     cursors, lengths):
    rng = np.random.default_rng(cap + dh)
    b, n_layers = 2, 3
    k, v, t = _cache(rng, n_layers, b, hkv, cap, dh, dev)
    q = t((b, h, dh))
    lengths = _i32(lengths, dev)
    wi = _i32(cursors, dev)
    got = flash_gqa_decode_stacked(q, k, v, lengths, wi, 2, prompt_cap)
    torch.cuda.synchronize()
    want = decode_attention_plain(q.float(), k.float(), v.float(), lengths,
                                  wi, 2, prompt_cap)
    torch.testing.assert_close(got.float(), want, atol=DECODE_ATOL,
                               rtol=DECODE_RTOL)


def test_decode_kernel_ignores_dead_slots(dev):
    rng = np.random.default_rng(3)
    b, h, hkv, dh, cap, prompt_cap = 1, 16, 8, 128, 1024, 128
    k, v, t = _cache(rng, 2, b, hkv, cap, dh, dev)
    q = t((b, h, dh))
    lengths, wi = _i32([40], dev), _i32([prompt_cap + 2], dev)
    base = flash_gqa_decode_stacked(q, k, v, lengths, wi, 1, prompt_cap)
    k[:, :, :, 40:prompt_cap] = 1e3
    v[:, :, :, 40:prompt_cap] = 1e3
    k[:, :, :, prompt_cap + 3:] = -1e3
    v[:, :, :, prompt_cap + 3:] = float("nan")
    poisoned = flash_gqa_decode_stacked(q, k, v, lengths, wi, 1, prompt_cap)
    torch.testing.assert_close(base, poisoned, atol=0, rtol=0)


def test_kernels_reject_what_they_do_not_take(dev):
    q = torch.zeros(1, 16, 96, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 1, 8, 64, 96, dtype=torch.bfloat16, device=dev)
    i = _i32([3], dev)
    with pytest.raises(ValueError):
        flash_gqa_decode_stacked(q, k, k, i, i, 0, 0)       # head_dim 96
    q128 = torch.zeros(1, 16, 128, dtype=torch.float32, device=dev)
    k128 = torch.zeros(1, 1, 8, 64, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        flash_gqa_decode_stacked(q128, k128, k128, i, i, 0, 0)  # f32 q
