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

Talker step (w4a8) and predictor frame (int8), at full width: the talker
step's integer group dots are exact and summed in the plain version's
order, so it mostly agrees bit for bit; RMSNorm and softmax sums in
another order can flip an activation's bf16 rounding and then its int8
quantization, which later layers carry on.  Held as max |kernel - plain|
over max |plain|: one layer 1e-2, all 28 layers 1e-1; other cache slots
bit for bit.  The predictor's bf16 x int8 sums run in another order than
cuBLAS's, so its window logits drift by a few hundredths over 16 tokens x
6 layers: 5e-2 of max |logits| while codes agree, and a code may differ
only where the plain top-2 gap is below 0.1 (nothing compared after).
Duplicated lanes must agree bit for bit (lane isolation).
"""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.kernels.flash_decode import (
    decode_attention_plain, flash_gqa_decode_stacked)
from qwen3_tts_tpu_torch.kernels.flash_prefill import (
    flash_gqa_prefill_stacked, prefill_attention_plain)
from qwen3_tts_tpu_torch.kernels import predictor_frame as tpf
from qwen3_tts_tpu_torch.kernels import talker_step as tts

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


@pytest.fixture(scope="module")
def talker(dev_module):
    from qwen3_tts_tpu_torch.core.config import TalkerConfig
    from qwen3_tts_tpu_torch.models.transformer import init_decoder_params
    cfg = TalkerConfig()
    g = torch.Generator(device=dev_module).manual_seed(3)
    with torch.no_grad():
        w = tts.prep_layer_weights(cfg, init_decoder_params(cfg, g))
    return cfg, w


@pytest.fixture(scope="module")
def predictor(dev_module):
    from qwen3_tts_tpu_torch.core.config import PredictorConfig
    from qwen3_tts_tpu_torch.models.predictor import init_predictor_params
    cfg = PredictorConfig()
    g = torch.Generator(device=dev_module).manual_seed(4)
    with torch.no_grad():
        w = tpf.prep_predictor_weights(cfg, init_predictor_params(cfg, g))
    tables = (torch.randn(16, 2048, cfg.d_model, generator=g,
                          device=dev_module) * 0.3).to(torch.bfloat16)
    return cfg, w, tables


@pytest.fixture(scope="module")
def dev_module():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc)")
    return torch.device("cuda")


def _step_inputs(cfg, b, cap, pos, dev, seed):
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, cap, cfg.head_dim)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * 0.5).to(dev, torch.bfloat16)
    cos, sin = talker_lib._rope_tables(cfg, talker_lib._pos4(
        torch.full((b, 1), pos, device=dev)))
    return t(shape), t(shape), t((b, cfg.d_model)), cos[:, 0], sin[:, 0]


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.parametrize("depth,tol", [(1, 1e-2), (28, 1e-1)])
@pytest.mark.parametrize("b,prompt_cap,lengths,cursor", [
    (1, 32, [31], 40), (2, 128, [117, 60], 300), (4, 64, [64, 1, 33, 50], 64),
])
def test_talker_step_matches_plain(dev, talker, depth, tol, b, prompt_cap,
                                   lengths, cursor):
    import dataclasses
    cfg, w = talker
    cd = dataclasses.replace(cfg, n_layers=depth)
    wd = {k: v[:depth] for k, v in w.items()}
    k, v, x, cos, sin = _step_inputs(cd, b, 1024, cursor, dev, cursor + b)
    lens = _i32(lengths, dev)
    wi = _i32([cursor] * b, dev)
    kk, vk, kp, vp = k.clone(), v.clone(), k.clone(), v.clone()
    got = tts.talker_step_fused(cd, wd, x, cos, sin, kk, vk, lens, wi,
                                prompt_cap)
    torch.cuda.synchronize()
    want = tts.talker_step_plain(cd, wd, x, cos, sin, kp, vp, lens, wi,
                                 prompt_cap)
    assert _rel(got, want) <= tol
    for a, p, orig in ((kk, kp, k), (vk, vp, v)):
        assert _rel(a[:, :, :, cursor], p[:, :, :, cursor]) <= tol
        keep = torch.arange(1024, device=dev) != cursor
        assert torch.equal(a[:, :, :, keep], orig[:, :, :, keep])


def test_talker_step_lane_isolation(dev, talker):
    """Lanes 0 and 2 hold the same inputs: equal outputs bit for bit."""
    cfg, w = talker
    k, v, x, cos, sin = _step_inputs(cfg, 3, 512, 200, dev, 9)
    for t in (k, v):
        t[:, 2] = t[:, 0]
    x[2] = x[0]
    got = tts.talker_step_fused(cfg, w, x, cos, sin, k, v,
                                _i32([100, 7, 100], dev),
                                _i32([200] * 3, dev), 128)
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[2]) and not torch.equal(got[0], got[1])
    assert torch.equal(k[:, 0], k[:, 2]) and torch.equal(v[:, 0], v[:, 2])


def _codes_agree(got, want, tk, tp):
    """Per lane: codes equal token after token; the first difference only
    at a plain top-2 gap <= 0.1; logits within 5e-2 of max |plain| until
    then.  Returns the number of codes compared equal."""
    equal = 0
    assert torch.equal(got[:, 0], want[:, 0])
    for lane in range(got.shape[0]):
        for t in range(1, 16):
            ref = tp[t - 1][lane]
            assert ((tk[t - 1][lane] - ref).abs().max()
                    <= 5e-2 * ref.abs().max())
            if got[lane, t] != want[lane, t]:
                top2 = ref.topk(2).values
                assert top2[0] - top2[1] <= 0.1
                break
            equal += 1
    return equal


@pytest.mark.parametrize("b", [1, 3, 5])
def test_predictor_frame_matches_plain(dev, predictor, b):
    cfg, w, tables = predictor
    g = torch.Generator(device=dev).manual_seed(b)
    h = torch.randn(b, cfg.d_model, generator=g, device=dev)
    c0 = ((torch.arange(b, device=dev) * 977 + 5) % 2048).to(torch.int32)
    tk, tp = [], []
    got = tpf.predict_frame_fused(cfg, w, h, c0, tables, taps=tk)
    torch.cuda.synchronize()
    want = tpf.predict_frame_plain(cfg, w, h, c0, tables, taps=tp)
    assert got.shape == (b, 16) and got.dtype == torch.int32
    assert _codes_agree(got, want, tk, tp) >= 8 * b


def test_predictor_frame_lane_isolation(dev, predictor):
    """B = 5 runs as lane chunks of 4 + 1: lanes 1 and 4 (in different
    chunks) hold the same inputs and give the same codes and logits."""
    cfg, w, tables = predictor
    g = torch.Generator(device=dev).manual_seed(11)
    h = torch.randn(5, cfg.d_model, generator=g, device=dev)
    c0 = torch.tensor([1, 2, 3, 4, 2], dtype=torch.int32, device=dev)
    h[4] = h[1]
    tk = []
    got = tpf.predict_frame_fused(cfg, w, h, c0, tables, taps=tk)
    torch.cuda.synchronize()
    assert torch.equal(got[1], got[4])
    assert all(torch.equal(t[1], t[4]) for t in tk)


def test_step_kernels_reject_what_they_do_not_take(dev, talker, predictor):
    cfg, w = talker
    k, v, x, cos, sin = _step_inputs(cfg, 1, 64, 40, dev, 0)
    with pytest.raises(ValueError):          # f32 input
        tts.talker_step_fused(cfg, w, x.float(), cos, sin, k, v,
                              _i32([3], dev), _i32([40], dev), 32)
    x5 = x.expand(5, -1).contiguous()
    with pytest.raises(ValueError):          # batch 5
        tts.talker_step_fused(cfg, w, x5, cos, sin, k, v, _i32([3], dev),
                              _i32([40], dev), 32)
    pcfg, pw, tables = predictor
    with pytest.raises(ValueError):          # input of the wrong width
        tpf.predict_frame_fused(pcfg, pw, torch.zeros(1, 1000, device=dev),
                                _i32([3], dev), tables)
