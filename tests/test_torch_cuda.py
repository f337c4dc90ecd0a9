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

The talker step's int8, w8a8 and bf16 weight modes (two layers at full
width): one layer within 1e-2 of the plain talker in the kernel's orders
(chunk_step._talker_plain: the int8 and bf16 dots in the kernel's lane
order), every lane of B = 8 bit-equal to the one-lane kernel.
matmul_int4 (the talker's weight shapes, M = 1 and 128) within 1e-4 of
max |y| of its plain version: the same bf16 dequantized weights, f32 sums
in another order.  flash_gqa_decode (one layer's cache, scalar and
per-lane write_idx) at the decode bound above, and equal to the stacked
entry on that layer.

Chunk kernel (one cooperative launch per chunk of frames) against its
plain version, at a small width and at full width, one frame and four: the
same w4a8 integer dots and group order as the talker step, so the same
drift classes and tolerances: frame 0's code_0 exact and its window
logits within 1e-1 of max |plain| until a code differs; the first code
that differs must be explained by the measured difference of the logits
it was taken from (top-2 gap <= twice the max difference), and in frame 0
be a near tie (gap <= 0.1); later frames start from a state that already
differs by the step's drift; while all codes agree, logits, hidden and the
written k/v rows within 1e-1 of max |plain|; every other cache slot bit
for bit (chip_smoke.py states the same policy with its first measurements).
The batched body (B = 8 and 32 lanes, two layers at full width): every
lane bit-equal to its inputs alone copied into 8 lanes (one lane runs the
one-lane kernel, whose heads sum in another order); B = 4 refused.  The
sampler alone
(the kernel's block 0 code) against ops.sampling.sample_threshold on the
same uniforms: greedy exact, sampled equal on >= 99 % of draws (f32 sums
in another order).
"""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.kernels.flash_decode import (
    decode_attention_plain, flash_gqa_decode_stacked)
from qwen3_tts_tpu_torch.kernels.flash_prefill import (
    flash_gqa_prefill_stacked, prefill_attention_plain)
from qwen3_tts_tpu_torch.kernels import chunk_step as tcs
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
    (1024, 1024, 128, 16, 8, 0, 1024, [1024, 700]),  # long prompt, window C
    (100, 160, 128, 16, 2, 60, 100, [100, 40]),     # G=8, suffix
    (17, 17, 128, 8, 8, 0, 17, [17, 9]),            # G=1, ragged
    (16, 128, 128, 16, 8, 64, 128, [75, 80]),       # continued prefill
    (48, 256, 128, 16, 8, 192, 256, [235, 240]),    # continued, window 256
    (32, 128, 128, 16, 8, 95, 128, [122, 118]),     # continued, start 95
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


@pytest.mark.parametrize("b,s", [(8, 32), (8, 128), (32, 32), (32, 128)])
def test_prefill_kernel_lane_refill(dev, b, s):
    """The serving refill's shape: b prompts of one bucket S into a compact
    cache of capacity S, window S, ragged lengths."""
    rng = np.random.default_rng(b + s)
    k, v, t = _cache(rng, 3, b, 8, s, 128, dev)
    q = t((b, s, 16, 128))
    lengths = _i32([s - (13 * i) % s for i in range(b)], dev)
    start = _i32([0] * b, dev)
    got = flash_gqa_prefill_stacked(q, k, v, lengths, start, 2, s, s)
    torch.cuda.synchronize()
    want = prefill_attention_plain(q, k, v, lengths, start, 2, s, s)
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


@pytest.mark.parametrize("b", [1, 3, 5, 8, 32])
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
    """B = 5 in one launch: lanes 1 and 4 hold the same inputs and give the
    same codes and logits (each lane's sums run in an order fixed by the
    grid, not by B)."""
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
    with pytest.raises(ValueError, match="batch 33"):
        tpf.predict_frame_fused(pcfg, pw, torch.zeros(33, pcfg.d_model,
                                                      device=dev),
                                _i32([3] * 33, dev), tables)
    with pytest.raises(ValueError):          # K not whole 256-row groups
        tts.w4a8_gemv(x[:, :1000], w["wqkv_q"][0], w["wqkv_s"][0])


def _chunk_case(dev, full, seed, cap=1024, n_layers=None):
    """Weights, packs and carried state of one chunk test, made on the
    card from a seed: full width (n_layers of each model: all by default),
    or the CPU tests' small width."""
    import dataclasses
    from qwen3_tts_tpu_torch.core.config import PredictorConfig, TalkerConfig
    from qwen3_tts_tpu_torch.models import predictor as tpred
    from qwen3_tts_tpu_torch.models import talker as ttalk
    if full:
        tcfg, pcfg = TalkerConfig(), PredictorConfig()
        if n_layers is not None:
            tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
            pcfg = dataclasses.replace(pcfg, n_layers=n_layers)
    else:
        tcfg = TalkerConfig(d_model=256, n_layers=2, n_heads=2,
                            n_kv_heads=1, head_dim=128, d_ff=256)
        pcfg = PredictorConfig(d_model=256, n_layers=2, n_heads=4,
                               n_kv_heads=2, head_dim=64, d_ff=256)
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    with torch.no_grad():
        tp = ttalk.init_talker_params(tcfg, g)
        pp = tpred.init_predictor_params(pcfg, g)
        d, dp = tcfg.d_model, pcfg.d_model
        pack = {"proj_w": rnd(dp, d, scale=0.05), "proj_b": rnd(dp, scale=0.01),
                "tts_pad": rnd(d, scale=0.02),
                "codec_tables": rnd(16, 2160, d, scale=0.02).to(torch.bfloat16),
                "codec_tables_1024": rnd(16, 2048, dp, scale=0.02).to(
                    torch.bfloat16)}
        tw = tts.prep_layer_weights(tcfg, tp)
        pw = tcs.prep_predictor_w4(pcfg, pp)
        ex = tcs.prep_chunk_extras(tcfg, pcfg, tp, pp, pack)
    shape = (tcfg.n_layers, 1, tcfg.n_kv_heads, cap, tcfg.head_dim)
    state = dict(k=rnd(*shape, scale=0.5).to(torch.bfloat16),
                 v=rnd(*shape, scale=0.5).to(torch.bfloat16),
                 logits=rnd(1, 2160, scale=2.0), hidden=rnd(1, d, scale=0.5))
    return tcfg, pcfg, tw, pw, ex, state


def _run_chunk(fn, case, n_frames, prompt_cap, length, start, u, sampler,
               state=None, **kw):
    """One call from the case's carried state, or from `state` (logits,
    hidden, k, v); the caches are copied first."""
    from qwen3_tts_tpu_torch.models import talker as ttalk
    tcfg, pcfg, tw, pw, ex, st = case
    dev = st["k"].device
    lg, hd, k, v = ((st["logits"], st["hidden"], st["k"], st["v"])
                    if state is None else state)
    k, v = k.clone(), v.clone()
    p = start + torch.arange(n_frames, device=dev)[:, None]
    cos, sin = ttalk._rope_tables(tcfg, ttalk._pos4(p))
    codes, lg, hd = fn(tcfg, pcfg, tw, pw, ex, lg, hd, k, v,
                       _i32([length], dev), _i32([start], dev),
                       cos.float().contiguous(), sin.float().contiguous(), u,
                       sampler, prompt_cap, **kw)
    torch.cuda.synchronize()
    return codes, lg, hd, k, v


def _zeros_u(n, dev):
    return torch.zeros(n, 1, device=dev)


def _all_but(rows, cap=1024):
    keep = torch.ones(cap, dtype=torch.bool)
    keep[rows] = False
    return keep


@pytest.mark.parametrize("full", [False, True])
def test_chunk_kernel_matches_plain(dev, full):
    """Every frame of a 4-frame launch against the plain version run from
    the kernel's own state after the frame before (the outputs and cache
    of the shorter launch, which the longer one repeats bit for bit), on
    the kernel's codes: code_0 exact, a later code differing from the plain
    pick only at a near tie (top-2 gap <= 0.1) that the logits' measured
    difference explains, layer 0's written k/v row within 1e-2 of max
    |plain|, the window logits, carried logits, hidden state and written
    k/v rows within max(1e-1, 2 s), s being how far the plain version moves
    from itself with its prefix in tiles of the kernel's split
    (chunk_step.SPLIT; chip_smoke.py says why), other slots untouched."""
    case = _chunk_case(dev, full, seed=5)
    for prompt_cap, length, start in ((32, 31, 32), (128, 117, 159),
                                      (128, 90, 1020)):
        _hold_chunk_to_plain(dev, case, prompt_cap, length, start)


def _hold_chunk_to_plain(dev, case, prompt_cap, length, start):
    """test_chunk_kernel_matches_plain's policy at one cursor."""
    greedy = (0.0, 40, 0.9)
    tk = []
    before = tcs.gen_chunk_fused.launches
    runs = [_run_chunk(tcs.gen_chunk_fused, case, n, prompt_cap, length,
                       start, _zeros_u(n, dev), greedy,
                       taps=tk if n == 4 else None)
            for n in range(1, 5)]
    assert tcs.gen_chunk_fused.launches == before + 4
    codes = runs[-1][0]
    assert codes.shape == (1, 4, 16) and codes.dtype == torch.int32
    assert len(tk) == 60
    for f in range(1, 4):
        keep = _all_but(start + f).to(dev)
        assert torch.equal(runs[f][0][:, :f], runs[f - 1][0])
        for a, b in zip(runs[f][3:], runs[f - 1][3:]):
            assert torch.equal(a[:, :, :, keep], b[:, :, :, keep])
    keep = _all_but(slice(start, start + 4)).to(dev)
    for a, orig in zip(runs[-1][3:], (case[5]["k"], case[5]["v"])):
        assert torch.equal(a[:, :, :, keep], orig[:, :, :, keep])
    for f in range(4):
        state = None if f == 0 else runs[f - 1][1:]
        tp, t128 = [], []
        want = _run_chunk(tcs.gen_chunk_plain, case, 1, prompt_cap,
                          length, start + f, _zeros_u(1, dev), greedy,
                          state=state, taps=tp,
                          force_codes=codes[:, f:f + 1])
        alt = _run_chunk(tcs.gen_chunk_plain, case, 1, prompt_cap,
                         length, start + f, _zeros_u(1, dev), greedy,
                         state=state, taps=t128,
                         force_codes=codes[:, f:f + 1], prefix_tile=tcs.SPLIT)
        got, kt = runs[f], tk[f * 15:(f + 1) * 15]
        assert all(bool(torch.isfinite(x).all()) for x in got[1:3])
        assert want[0][0, 0, 0] == codes[0, f, 0], f
        for t in range(1, 16):
            if want[0][0, 0, t] != codes[0, f, t]:
                top2 = tp[t - 1][0].topk(2).values
                gap = (top2[0] - top2[1]).item()
                seen = (kt[t - 1][0] - tp[t - 1][0]).abs().max().item()
                assert gap <= 0.1 and gap <= 2 * seen, (f, t, gap, seen)
        row = start + f
        tol = max(1e-1, 2 * max(_chunk_errs(alt, want, t128, tp, row)))
        assert max(_chunk_errs(got, want, kt, tp, row)) <= tol, f
        for a, b in zip(got[3:], want[3:]):
            assert _rel(a[0, :, :, row], b[0, :, :, row]) <= 1e-2, f


def _chunk_errs(a, b, ta, tb, row):
    """rel err of run a against run b: window logits, logits, hidden, the
    k/v row written at `row` in every layer."""
    return (max(_rel(x, y) for x, y in zip(ta, tb)), _rel(a[1], b[1]),
            _rel(a[2], b[2]),
            max(_rel(x[:, :, :, row], y[:, :, :, row])
                for x, y in zip(a[3:], b[3:])))


def test_chunk_kernel_kept_scratch_and_no_taps_repeat_a_launch(dev):
    """A scratch kept over launches (its barrier counters as the last
    launch left them: zero) and a launch without taps give what a fresh
    launch gives."""
    case = _chunk_case(dev, False, seed=9)
    args = (case, 4, 32, 31, 32, _zeros_u(4, dev), (0.0, 40, 0.9))
    ref = _run_chunk(tcs.gen_chunk_fused, *args, taps=[])
    scratch = tcs.chunk_scratch(case[0], case[1], dev, 1, 1024)
    for _ in range(3):
        got = _run_chunk(tcs.gen_chunk_fused, *args, scratch=scratch)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert scratch["barrier"].tolist() == [0, 0]
    assert not bool(scratch["arrive"].any())
    with pytest.raises(ValueError, match="scratch"):
        _run_chunk(tcs.gen_chunk_fused, *args,
                   scratch=dict(scratch, px=scratch["px"][:8]))


def test_chunk_kernel_sampled_codes_in_range_and_phase_clocks(dev):
    """Full width and depth: 542 phases per frame (no predictor attention
    phase of its own), each with a clock that advanced."""
    case = _chunk_case(dev, True, seed=6)
    u = torch.tensor([[0.3], [0.7], [0.1], [0.9]], device=dev)
    n_phases = len(tcs.phase_labels(case[0], case[1], 4))
    assert n_phases == 4 * 542
    clocks = torch.zeros(n_phases + 1, dtype=torch.int64, device=dev)
    codes = _run_chunk(tcs.gen_chunk_fused, case, 4, 32, 31, 32, u,
                       (0.7, 40, 0.9), clocks=clocks)[0]
    assert bool((codes[..., 0] < 2160).all()) and bool((codes >= 0).all())
    assert bool((codes[..., 1:] < 2048).all())
    assert bool((clocks.diff() > 0).all())          # one clock per phase


def test_sampler_kernel_matches_plain(dev):
    from qwen3_tts_tpu_torch.ops.sampling import sample_threshold
    rng = np.random.default_rng(8)
    lg = (rng.standard_normal((64, 2160)) * 2).astype(np.float32)
    lg[1, [7, 900, 2000]] = lg[1].max() + 1.0          # a three-way tie
    lgt = torch.from_numpy(lg).to(dev)
    zeros = torch.zeros(64, device=dev)
    got = tcs.sample_fused(lgt, zeros, 0.0, 40, 0.9)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sample_threshold(lgt.cpu(), zeros.cpu(),
                                                   0.0, 40, 0.9))
    n = 4000
    row = torch.from_numpy(np.tile(lg[0], (n, 1))).to(dev)
    us = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    got = tcs.sample_fused(row, us, 0.7, 40, 0.9).cpu()
    want = sample_threshold(row.cpu(), us.cpu(), 0.7, 40, 0.9)
    assert (got == want).float().mean().item() >= 0.99


def test_chunk_kernel_rejects_what_it_does_not_take(dev):
    case = _chunk_case(dev, False, seed=7)
    tcfg, pcfg, tw, pw, ex, st = case
    with pytest.raises(ValueError):          # f32 cache
        tcs.gen_chunk_fused(tcfg, pcfg, tw, pw, ex, st["logits"],
                            st["hidden"], st["k"].float(), st["v"].float(),
                            _i32([3], dev), _i32([40], dev),
                            torch.zeros(1, 1, 128, device=dev),
                            torch.zeros(1, 1, 128, device=dev),
                            _zeros_u(1, dev), (0.0, 40, 0.9), 32)
    with pytest.raises(ValueError):          # nine frames
        _run_chunk(tcs.gen_chunk_fused, case, 9, 32, 31, 32,
                   _zeros_u(9, dev), (0.0, 40, 0.9))


@pytest.mark.parametrize("b", [8, 32])
def test_chunk_kernel_lanes_match_the_one_lane_kernel(dev, b):
    """The batched body (full width, two layers each, B lanes with ragged
    prompt lengths and positions, one cursor, sampled): every lane
    bit-equal to that lane's inputs and uniforms alone, copied into all 8
    lanes of a batched launch (codes, logits, hidden, its cache block): no
    sum mixes lanes and no order depends on B.  B = 1 runs the one-lane
    kernel, whose heads sum in another order; it is held to the plain
    version (test_chunk_kernel_matches_plain).  The slots being written
    poisoned first, every other slot untouched; one launch counted."""
    from qwen3_tts_tpu_torch.models import talker as ttalk
    tcfg, pcfg, tw, pw, ex, _ = _chunk_case(dev, True, seed=10 + b,
                                            n_layers=2)
    g = torch.Generator(device=dev).manual_seed(b)
    cap, start, pcap, n = 1024, 600, 128, 4
    lens = _i32([pcap - 1 - (7 * i) % 64 for i in range(b)], dev)
    pos = lens + (start - pcap)
    shape = (tcfg.n_layers, b, tcfg.n_kv_heads, cap, tcfg.head_dim)
    k, v = ((torch.randn(shape, generator=g, device=dev) * 0.5).to(
        torch.bfloat16) for _ in range(2))
    k[:, :, :, start:start + n], v[:, :, :, start:start + n] = 1e3, -1e3
    lg = torch.randn(b, 2160, generator=g, device=dev) * 2.0
    hd = torch.randn(b, tcfg.d_model, generator=g, device=dev)
    u = torch.rand(n, b, generator=g, device=dev)

    def run(lg, hd, k, v, lens, pos, u):
        k, v = k.clone(), v.clone()
        p = pos.long()[None, :] + torch.arange(n, device=dev)[:, None]
        cos, sin = ttalk._rope_tables(tcfg, ttalk._pos4(p))
        out = tcs.gen_chunk_fused(
            tcfg, pcfg, tw, pw, ex, lg, hd, k, v, lens,
            torch.full_like(lens, start), cos.float().contiguous(),
            sin.float().contiguous(), u.contiguous(), (0.7, 40, 0.9), pcap)
        torch.cuda.synchronize()
        return (*out, k, v)

    before = tcs.gen_chunk_fused.launches
    many = run(lg, hd, k, v, lens, pos, u)
    assert tcs.gen_chunk_fused.launches == before + 1
    assert many[0].shape == (b, n, 16) and many[1].shape == (b, 2160)
    keep = _all_but(slice(start, start + n)).to(dev)
    for got, orig in zip(many[3:], (k, v)):
        assert torch.equal(got[:, :, :, keep], orig[:, :, :, keep])
    for i in range(b):
        def alone(t, dim=0):
            idx = [slice(None)] * t.dim()
            idx[dim] = slice(i, i + 1)
            shape = [-1] * t.dim()
            shape[dim] = 8
            return t[tuple(idx)].expand(*shape).contiguous()
        one = run(alone(lg), alone(hd), alone(k, 1), alone(v, 1),
                  alone(lens), alone(pos), alone(u, 1))
        assert torch.equal(one[0][0], many[0][i]), i
        assert torch.equal(one[1][0], many[1][i]), i
        assert torch.equal(one[2][0], many[2][i]), i
        assert torch.equal(one[3][:, 0], many[3][:, i]), i
        assert torch.equal(one[4][:, 0], many[4][:, i]), i


def test_chunk_kernel_layer_taps_hold_layer_by_layer(dev):
    """The batched form's layer_taps (B = 8, two layers each, sampled):
    every talker layer of the plain version in the kernel's softmax order,
    run from the kernel's residual entering it and the kernel's cache,
    within 2e-2 of max of the kernel's next residual and written k/v row
    (this file's layer-by-layer bound of the talker step); the kernel's
    layer-0 input is the feedback of its codes, and the final norm of its
    last residual its hidden.  The same holds for a one-lane launch (the
    one-lane kernel) on lane 0's inputs."""
    from qwen3_tts_tpu_torch.models import talker as ttalk
    tcfg, pcfg, tw, pw, ex, st = _chunk_case(dev, True, seed=44, n_layers=2)
    g = torch.Generator(device=dev).manual_seed(45)
    b, cap, start, pcap, n = 8, 1024, 300, 128, 4
    lens = _i32([pcap - 1 - (9 * i) % 64 for i in range(b)], dev)
    pos = lens + (start - pcap)
    shape = (tcfg.n_layers, b, tcfg.n_kv_heads, cap, tcfg.head_dim)
    k, v = ((torch.randn(shape, generator=g, device=dev) * 0.5).to(
        torch.bfloat16) for _ in range(2))
    p = pos.long()[None, :] + torch.arange(n, device=dev)[:, None]
    cos, sin = (t.float().contiguous() for t in ttalk._rope_tables(
        tcfg, ttalk._pos4(p)))
    xt = []
    lg0 = torch.randn(b, 2160, generator=g, device=dev) * 2.0
    hd0 = torch.randn(b, tcfg.d_model, generator=g, device=dev)
    u = torch.rand(n, b, generator=g, device=dev)
    k0, v0 = k[:, :1].clone(), v[:, :1].clone()
    codes, lg, hd = tcs.gen_chunk_fused(
        tcfg, pcfg, tw, pw, ex, lg0, hd0, k, v, lens,
        torch.full_like(lens, start), cos, sin, u, (0.7, 40, 0.9), pcap,
        layer_taps=xt)
    torch.cuda.synchronize()
    assert len(xt) == n and xt[0].shape == (b, tcfg.n_layers + 1,
                                            tcfg.d_model)
    rel = lambda a, b_: ((a.float() - b_.float()).abs().max()
                         / b_.float().abs().max()).item()

    def hold(xt, codes, hd, k, v, lens, cos, sin):
        for f in range(n):
            fb = tcs._feedback(ex["ctab_fb"], codes[:, f], ex["tts_pad"])
            assert rel(xt[f][:, 0], fb) <= 1e-2, f
            kc, vc = k.clone(), v.clone()
            for layer in range(tcfg.n_layers):
                y = tcs._talker_layer_plain(
                    tcfg, tw, layer, xt[f][:, layer], cos[f], sin[f], kc, vc,
                    lens, start, f, pcap, 128)
                for i in range(len(lens)):
                    assert rel(xt[f][i, layer + 1], y[i]) <= 2e-2, (
                        f, layer, i)
                    for got, want in ((k, kc), (v, vc)):
                        assert rel(got[layer, i, :, start + f],
                                   want[layer, i, :, start + f]) <= 2e-2
        hid = tcs._rms(xt[-1][:, -1], ex["tfn"], tcfg.rms_eps)
        assert rel(hd, hid) <= 1e-4

    hold(xt, codes, hd, k, v, lens, cos, sin)
    xo = []
    cos1, sin1 = cos[:, :1].contiguous(), sin[:, :1].contiguous()
    c1, _, h1 = tcs.gen_chunk_fused(
        tcfg, pcfg, tw, pw, ex, lg0[:1].clone(), hd0[:1].clone(), k0, v0,
        lens[:1].clone(), _i32([start], dev), cos1, sin1,
        u[:, :1].contiguous(), (0.7, 40, 0.9), pcap, layer_taps=xo)
    torch.cuda.synchronize()
    assert len(xo) == n and xo[0].shape == (1, tcfg.n_layers + 1,
                                            tcfg.d_model)
    hold(xo, c1, h1, k0, v0, lens[:1], cos1, sin1)


@pytest.mark.parametrize("start", [tcs.SPLIT - 1, tcs.SPLIT, tcs.SPLIT + 1,
                                   3 * tcs.SPLIT + 5])
def test_chunk_kernel_across_split_bounds(dev, start):
    """Cursors on both sides of a bound of the talker's prefix splits
    (chunk_step.SPLIT slots per work item).  B = 1 (the small width): each
    frame against the plain version, test_chunk_kernel_matches_plain's
    policy.  B = 8 (two layers at full width, ragged prompt lengths,
    sampled): lanes 0 and 7 bit-equal to the same lane copied into all 8
    lanes of a launch (the batched body: no sum mixes lanes), and every
    talker layer of lanes 0 and 7 from the kernel's own state
    (layer_taps) within 1e-2 of max of the plain layer in the kernel's
    sum orders (chunk_step.KERNEL_ORDERS), at least 99 % of the (frame,
    layer, lane) residuals exact, as chip_smoke.py holds them."""
    from qwen3_tts_tpu_torch.models import talker as ttalk
    small = _chunk_case(dev, False, seed=60 + start)
    pcap = min(32, start)
    _hold_chunk_to_plain(dev, small, pcap, pcap - 1, start)
    tcfg, pcfg, tw, pw, ex, _ = _chunk_case(dev, True, seed=61, n_layers=2)
    g = torch.Generator(device=dev).manual_seed(start)
    b, cap, n = 8, 1024, 4
    lens = _i32([pcap - (5 * i) % pcap for i in range(b)], dev)
    pos = lens + (start - pcap)
    shape = (tcfg.n_layers, b, tcfg.n_kv_heads, cap, tcfg.head_dim)
    k, v = ((torch.randn(shape, generator=g, device=dev) * 0.5).to(
        torch.bfloat16) for _ in range(2))
    lg = torch.randn(b, 2160, generator=g, device=dev) * 2.0
    hd = torch.randn(b, tcfg.d_model, generator=g, device=dev)
    u = torch.rand(n, b, generator=g, device=dev)
    p = pos.long()[None, :] + torch.arange(n, device=dev)[:, None]
    cos, sin = (t.float().contiguous() for t in ttalk._rope_tables(
        tcfg, ttalk._pos4(p)))

    def run(i=None, xt=None):
        # every lane, or lane i in all of them
        sel = (torch.arange(b, device=dev) if i is None
               else torch.full((b,), i, device=dev))
        kk, vv = k[:, sel].clone(), v[:, sel].clone()
        out = tcs.gen_chunk_fused(
            tcfg, pcfg, tw, pw, ex, lg[sel].clone(), hd[sel].clone(), kk, vv,
            lens[sel].clone(), _i32([start] * b, dev),
            cos[:, sel].contiguous(), sin[:, sel].contiguous(),
            u[:, sel].contiguous(), (0.7, 40, 0.9), pcap, layer_taps=xt)
        torch.cuda.synchronize()
        return (*out, kk, vv)

    xt = []
    many = run(xt=xt)
    for i in (0, b - 1):
        one = run(i)
        for x, y in zip(one[:3], many[:3]):
            assert torch.equal(x[0], y[i]), i
        for x, y in zip(one[3:], many[3:]):
            assert torch.equal(x[:, 0], y[:, i]), i
    rel = lambda a, b_: ((a.float() - b_.float()).abs().max()
                         / b_.float().abs().max()).item()
    rows = torch.tensor([0, b - 1], device=dev)
    exact, pairs = 0, 0
    for f in range(n):
        # the kernel's cache: frame f reads slots up to start + f, which the
        # plain layer writes again
        kc, vc = many[3][:, rows].clone(), many[4][:, rows].clone()
        for layer in range(tcfg.n_layers):
            y = tcs._talker_layer_plain(
                tcfg, tw, layer, xt[f][rows, layer], cos[f][rows],
                sin[f][rows], kc, vc, lens[rows], start, f, pcap, 128,
                orders=tcs.KERNEL_ORDERS)
            for j in range(2):
                e = rel(xt[f][rows[j], layer + 1], y[j])
                assert e <= 1e-2, (f, layer, j, e)
                exact += e == 0.0
                pairs += 1
    assert exact >= 0.99 * pairs, (exact, pairs)


def test_chunk_kernel_refuses_a_batch_outside_its_gate(dev):
    """A CUDA input at B = 4 (the wave then takes the step schedule by
    gen_frames' gate) raises before any launch."""
    tcfg, pcfg, tw, pw, ex, st = _chunk_case(dev, False, seed=7)
    b = 4
    before = tcs.gen_chunk_fused.launches
    shape = (tcfg.n_layers, b, tcfg.n_kv_heads, 1024, tcfg.head_dim)
    k = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="batch 4 not in"):
        tcs.gen_chunk_fused(
            tcfg, pcfg, tw, pw, ex, st["logits"].expand(b, -1).contiguous(),
            st["hidden"].expand(b, -1).contiguous(), k, k.clone(),
            _i32([31] * b, dev), _i32([32] * b, dev),
            torch.zeros(4, b, 128, device=dev),
            torch.zeros(4, b, 128, device=dev), torch.zeros(4, b, device=dev),
            (0.0, 40, 0.9), 32)
    assert tcs.gen_chunk_fused.launches == before


# ---------------------------------------- continuous batching: per-lane caches
# flash_gqa_decode_append: bit-equal to its plain version in the kernel's
# sum orders (decode_append_kernel_order: 64-slot splits combined in split
# order, the current token merged last; expf on both sides), within the
# decode bound of the torch-order plain version's f32 result at cursors in
# [0, C) (at a cursor >= C that version drops the token, which the kernel
# still attends); the written row bit-exact, every other slot untouched, a
# poisoned stale row at the slot being written never read; a second launch
# gives the same (the split counters came back to 0).
# inject_prompt_lanes / append_kv_lanes: copies, so bit-exact.
@pytest.mark.parametrize("cursors,h,hkv,dh", [
    ([0, 511, 512, 1023], 16, 8, 128),             # the talker's heads
    ([0, 63, 64, 65, 1023, 1030], 16, 8, 128),     # split bounds, >= C
    ([32, 47, 64, 200, 511, 600, 900, 1023], 16, 8, 128),   # B = 8
    ([0, 63, 64, 65, 1023], 8, 8, 64),             # G = 1, head dim 64
    ([5, 64, 130, 1023], 16, 2, 128),              # G = 8
])
def test_decode_append_kernel_matches_plain(dev, cursors, h, hkv, dh):
    from qwen3_tts_tpu_torch.kernels.flash_decode import (
        decode_append_kernel_order, decode_append_plain,
        flash_gqa_decode_append)
    rng = np.random.default_rng(21 + len(cursors) + h + dh)
    b, cap, prompt_cap = len(cursors), 1024, 128
    k, v, t = _cache(rng, 2, b, hkv, cap, dh, dev)
    q, kn, vn = t((b, h, dh)), t((b, hkv, dh)), t((b, hkv, dh))
    lengths = _i32([(0, 100, 128, 37)[i % 4] for i in range(b)], dev)
    wi = _i32(cursors, dev)
    for i, c in enumerate(cursors):
        if c < cap:
            k[1, i, :, c] = 1e3
            v[1, i, :, c] = float("nan")
    kk, vk = k.clone(), v.clone()
    ko, vo, kp, vp = k.clone(), v.clone(), k.clone(), v.clone()
    got = flash_gqa_decode_append(q, kk, vk, kn, vn, lengths, wi, 1,
                                  prompt_cap)
    again = flash_gqa_decode_append(q, k.clone(), v.clone(), kn, vn, lengths,
                                    wi, 1, prompt_cap)
    torch.cuda.synchronize()
    kord = decode_append_kernel_order(q, ko, vo, kn, vn, lengths, wi, 1,
                                      prompt_cap)
    want = decode_append_plain(q.float(), kp, vp, kn, vn, lengths, wi, 1,
                               prompt_cap)
    assert torch.equal(got, kord) and torch.equal(again, got)
    inside = [i for i, c in enumerate(cursors) if c < cap]
    torch.testing.assert_close(got[inside].float(), want[inside],
                               atol=DECODE_ATOL, rtol=DECODE_RTOL)
    assert torch.equal(kk, kp) and torch.equal(vk, vp)
    assert torch.equal(kk, ko) and torch.equal(vk, vo)


def test_inject_and_append_lanes_match_plain(dev):
    from qwen3_tts_tpu_torch.kernels.flash_decode import (
        append_kv_lanes, append_kv_lanes_plain, inject_prompt_lanes,
        inject_prompt_lanes_plain)
    rng = np.random.default_rng(22)
    n_layers, b, hkv, cap, dh, s = 3, 8, 8, 256, 128, 64
    k, v, t = _cache(rng, n_layers, b, hkv, cap, dh, dev)
    ks, vs = t((n_layers, 3, hkv, s, dh)), t((n_layers, 3, hkv, s, dh))
    ks[:, 2], vs[:, 2] = ks[:, 0], vs[:, 0]
    lanes = _i32([5, 1, 5], dev)                   # lane 5 twice, same rows
    got = [x.clone() for x in (k, v)]
    want = [x.clone() for x in (k, v)]
    inject_prompt_lanes(*got, ks, vs, lanes)
    torch.cuda.synchronize()
    inject_prompt_lanes_plain(*want, ks, vs, lanes)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    kt, vt = t((n_layers, b, hkv, dh)), t((n_layers, b, hkv, dh))
    starts = _i32([0, 7, 8, 63, 64, 255, 128, 1], dev)
    append_kv_lanes(*got, kt, vt, starts)
    torch.cuda.synchronize()
    append_kv_lanes_plain(*want, kt, vt, starts)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert torch.equal(got[0][:, 3, :, 63], kt[:, 3])


def test_talker_step_batched_per_lane_matches_plain(dev, talker):
    """B = 8 and 32, ragged per-lane cursors, two layers at full width:
    each lane bit-equal to the one-lane kernel on its inputs; each layer,
    from the kernel's own hidden state at the layer before, within 2e-2 of
    the plain version in the kernel's orders
    (chunk_step._talker_plain(orders=KERNEL_ORDERS): 64-slot prefix splits
    combined in split order) run on that lane
    alone (on the card the plain version orders its sums by shape, so a
    batched plain call is not lane for lane the B = 1 one), at least half
    of the (layer, lane) pairs bit-equal (an f32 sum in another order
    flips a bf16 rounding now and then, and the next int8 quantization
    moves one element by a step: 1.15e-2 of max in one layer on one
    H100); the rows the per-lane mode appends likewise; every other slot
    untouched."""
    import dataclasses
    from qwen3_tts_tpu_torch.kernels import chunk_step as tcs
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    cfg, w = talker
    cd = dataclasses.replace(cfg, n_layers=2)
    wd = {name: x[:2] for name, x in w.items()}
    for b in (8, 32):
        k, v, x, _, _ = _step_inputs(cd, b, 1024, 0, dev, b)
        cursors = [128 + (37 * i) % 896 for i in range(b)]
        pos = torch.tensor(cursors, device=dev)
        cos, sin = talker_lib._rope_tables(cd, talker_lib._pos4(pos[:, None]))
        cos, sin = cos[:, 0].contiguous(), sin[:, 0].contiguous()
        lens, wi = _i32([(60 + 13 * i) % 128 for i in range(b)], dev), \
            _i32(cursors, dev)
        kk, vk = k.clone(), v.clone()
        got = tts.talker_step_fused(cd, wd, x, cos, sin, kk, vk, lens, wi,
                                    128, uniform_cursor=False)
        torch.cuda.synchronize()
        for i, c in enumerate(cursors):
            # copies: the kernel takes 16-byte aligned tensors
            lane = tuple(t[i:i + 1].clone() for t in (x, cos, sin))
            li, wl = lens[i:i + 1].clone(), wi[i:i + 1].clone()
            mine = [t[:, i:i + 1].clone() for t in (k, v)]
            one = tts.talker_step_fused(cd, wd, *lane, *mine, li, wl, 128)
            assert torch.equal(got[i], one[0]), i
            for a, m in zip((kk, vk), mine):
                assert torch.equal(a[:, i, :, c], m[:, 0, :, c]), i
        # layer by layer, from the kernel's own state at the layer before
        c1 = dataclasses.replace(cfg, n_layers=1)
        h1 = tts.talker_step_fused(c1, {name: t[:1] for name, t in w.items()},
                                   x, cos, sin, k[:1].clone(), v[:1].clone(),
                                   lens, wi, 128, uniform_cursor=False)
        outs, es = (x, h1, got), []
        for layer in range(2):
            w1 = {name: t[layer:layer + 1] for name, t in w.items()}
            for i, c in enumerate(cursors):
                lane = tuple(t[i:i + 1].clone() for t in (outs[layer], cos,
                                                          sin))
                tiled = [t[layer:layer + 1, i:i + 1].clone() for t in (k, v)]
                alt = tcs._talker_plain(c1, w1, *lane, *tiled,
                                        lens[i:i + 1].clone(), c, 0, 128, 128,
                                        orders=tcs.KERNEL_ORDERS)
                es.append(max(_rel(outs[layer + 1][i:i + 1], alt),
                              *(_rel(a[layer, i, :, c], p[0, 0, :, c])
                                for a, p in zip((kk, vk), tiled))))
        assert max(es) <= 2e-2, es
        assert 2 * sum(e == 0 for e in es) >= len(es), es
        lanes = torch.arange(b, device=dev)
        for a, orig in ((kk, k), (vk, v)):
            a[:, lanes, :, wi.long()] = 0
            orig = orig.clone()
            orig[:, lanes, :, wi.long()] = 0
            assert torch.equal(a, orig)


def test_talker_step_batched_across_split_bounds(dev, talker):
    """B = 8 in bucket 32 at per-lane cursors on both sides of the
    attention's 64-slot split bounds (47, 48, 63, 64, 65, 1023), two layers
    at full width: each lane bit-equal to the one-lane kernel; each layer,
    from the kernel's own state, within 1e-2 of the plain layer in the
    kernel's orders on that lane alone, at least half of the pairs exact."""
    import dataclasses
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    cfg, w = talker
    cd = dataclasses.replace(cfg, n_layers=2)
    wd = {name: x[:2] for name, x in w.items()}
    cursors = [47, 48, 63, 64, 65, 1023, 33, 500]
    b = len(cursors)
    k, v, x, _, _ = _step_inputs(cd, b, 1024, 0, dev, 77)
    pos = torch.tensor(cursors, device=dev)
    cos, sin = talker_lib._rope_tables(cd, talker_lib._pos4(pos[:, None]))
    cos, sin = cos[:, 0].contiguous(), sin[:, 0].contiguous()
    lens, wi = _i32([31 - (7 * i) % 20 for i in range(b)], dev), \
        _i32(cursors, dev)
    kk, vk = k.clone(), v.clone()
    c1 = dataclasses.replace(cfg, n_layers=1)
    h1 = tts.talker_step_fused(c1, {name: t[:1] for name, t in w.items()},
                               x, cos, sin, k[:1].clone(), v[:1].clone(),
                               lens, wi, 32, uniform_cursor=False)
    got = tts.talker_step_fused(cd, wd, x, cos, sin, kk, vk, lens, wi, 32,
                                uniform_cursor=False)
    torch.cuda.synchronize()
    es = []
    for i, c in enumerate(cursors):
        lane = tuple(t[i:i + 1].clone() for t in (x, cos, sin))
        li, wl = lens[i:i + 1].clone(), wi[i:i + 1].clone()
        mine = [t[:, i:i + 1].clone() for t in (k, v)]
        one = tts.talker_step_fused(cd, wd, *lane, *mine, li, wl, 32)
        assert torch.equal(got[i], one[0]), i
        for a, m in zip((kk, vk), mine):
            assert torch.equal(a[:, i, :, c], m[:, 0, :, c]), i
        for layer, (xin, xout) in enumerate(((x, h1), (h1, got))):
            w1 = {name: t[layer:layer + 1] for name, t in w.items()}
            tiled = [t[layer:layer + 1, i:i + 1].clone() for t in (k, v)]
            args = tuple(t[i:i + 1].clone() for t in (xin, cos, sin))
            alt = tcs._talker_plain(c1, w1, *args, *tiled, li, c, 0, 32, 128,
                                    orders=tcs.KERNEL_ORDERS)
            es.append(max(_rel(xout[i:i + 1], alt),
                          *(_rel(a[layer, i, :, c], p[0, 0, :, c])
                            for a, p in zip((kk, vk), tiled))))
    assert max(es) <= 1e-2, es
    assert 2 * sum(e == 0 for e in es) >= len(es), es


@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("n,k", [(4096, 2048), (2048, 6144)])
def test_w4a8_gemv_on_tensor_cores_matches_qmm4_plain(dev, talker, b, n, k):
    """One GEMV phase of the talker step's w4a8 core alone (mma.sync s8,
    the rows as M, the group sums in f32 in the JAX order) against
    qmm4_plain on the same bf16 rows and packed weights: bit-equal (the
    group dots are exact integers; the f32 sums run in the same order)."""
    cfg, w = talker
    name = "wqkv" if k == cfg.d_model else "dn"
    wq, ws = w[name + "_q"][0], w[name + "_s"][0]
    assert tuple(wq.shape) == (n, k // 2)
    g = torch.Generator(device=dev).manual_seed(b + n)
    x = (torch.randn(b, k, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    before = tts.w4a8_gemv.launches
    got = tts.w4a8_gemv(x, wq, ws)
    torch.cuda.synchronize()
    assert tts.w4a8_gemv.launches == before + 1
    assert torch.equal(got, tts.qmm4_plain(x, wq, ws))


@pytest.mark.parametrize("n", [8, 32])
def test_talker_step_batched_lanes_equal_single_lane(dev, talker, n):
    """n identical lanes through the batched kernel (one row tile, then
    four): bit-equal to each other and to the one-lane kernel (each lane's
    arithmetic is B = 1's)."""
    import dataclasses
    cfg, w = talker
    cd = dataclasses.replace(cfg, n_layers=2)
    wd = {name: x[:2] for name, x in w.items()}
    k1, v1, x1, cos1, sin1 = _step_inputs(cd, 1, 512, 200, dev, 5)
    rep = lambda t_: t_.expand(t_.shape[0], n, *t_.shape[2:]).contiguous()
    kn, vn = rep(k1), rep(v1)
    xn = x1.expand(n, -1).contiguous()
    cosn, sinn = cos1.expand(n, -1).contiguous(), sin1.expand(n, -1).contiguous()
    one = tts.talker_step_fused(cd, wd, x1, cos1, sin1, k1, v1,
                                _i32([90], dev), _i32([200], dev), 128)
    many = tts.talker_step_fused(cd, wd, xn, cosn, sinn, kn, vn,
                                 _i32([90] * n, dev), _i32([200] * n, dev),
                                 128, uniform_cursor=False)
    torch.cuda.synchronize()
    for i in range(n):
        assert torch.equal(many[i], one[0])
        assert torch.equal(kn[:, i], k1[:, 0]) and torch.equal(vn[:, i],
                                                               v1[:, 0])


# ------------------------------------------------ weight formats (PR 6)
@pytest.fixture(scope="module")
def talker_params2(dev_module):
    import dataclasses
    from qwen3_tts_tpu_torch.core.config import TalkerConfig
    from qwen3_tts_tpu_torch.models.transformer import init_decoder_params
    cfg = dataclasses.replace(TalkerConfig(), n_layers=2)
    g = torch.Generator(device=dev_module).manual_seed(9)
    with torch.no_grad():
        return cfg, init_decoder_params(cfg, g)


@pytest.mark.parametrize("mode", ["int8", "w8a8", "bf16"])
def test_talker_step_modes_match_plain(dev, talker_params2, mode):
    import dataclasses
    cfg, params = talker_params2
    w = tts.prep_layer_weights(cfg, params, mode)
    c1 = dataclasses.replace(cfg, n_layers=1)
    w1 = {k: t[:1] for k, t in w.items()}
    b, cursor = 8, 300
    k, v, x, cos, sin = _step_inputs(c1, b, 1024, cursor, dev, 21)
    lens = _i32([31 + 11 * i for i in range(b)], dev)
    wi = _i32([cursor] * b, dev)
    kk, vk = k.clone(), v.clone()
    got = tts.talker_step_fused(c1, w1, x, cos.contiguous(),
                                sin.contiguous(), kk, vk, lens, wi, 128,
                                mode=mode)
    torch.cuda.synchronize()
    for i in range(b):
        args = [t[i:i + 1].clone() for t in (x, cos, sin)]
        mine = [k[:, i:i + 1].clone(), v[:, i:i + 1].clone()]
        tiled = [k[:, i:i + 1].clone(), v[:, i:i + 1].clone()]
        li, wl = lens[i:i + 1].clone(), wi[i:i + 1].clone()
        one = tts.talker_step_fused(c1, w1, *args, *mine, li, wl, 128,
                                    mode=mode)
        assert torch.equal(one[0], got[i]), (mode, i)
        alt = tcs._talker_plain(c1, w1, *args, *tiled, li, cursor, 0, 128,
                                128, mode=mode, orders=tcs.KERNEL_ORDERS)
        assert _rel(got[i:i + 1], alt) <= 1e-2, (mode, i)
        for a, p in zip((kk, vk), tiled):
            assert _rel(a[:, i, :, cursor], p[:, 0, :, cursor]) <= 1e-2
    with pytest.raises(ValueError, match=mode):
        tts.talker_step_fused(c1, tts.prep_layer_weights(c1, params, "w4a8"),
                              x, cos.contiguous(), sin.contiguous(), kk, vk,
                              lens, wi, 128, mode=mode)


@pytest.mark.parametrize("k,n", [(2048, 4096), (2048, 2048), (2048, 12288),
                                 (6144, 2048), (2048, 1000)])
def test_matmul_int4_matches_plain(dev, k, n):
    """Both kernels within 1e-4 of max |y|: M on both sides of TILE_MIN_M
    (the small-M kernel's three row instances, the tile kernel's three
    row tiles), ragged M (3, 17, 129), x with two leading dims, and a
    ragged edge N tile (N = 1000); each call counts the kernels it
    launched (the tile kernel, the split-K sum)."""
    from qwen3_tts_tpu_torch.kernels import int4_matmul as ti
    from qwen3_tts_tpu_torch.ops.quant import quantize_weight_int4
    g = torch.Generator(device=dev).manual_seed(k + n)
    w = quantize_weight_int4(torch.randn(k, n, generator=g, device=dev)
                             * k ** -0.5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for lead in [(m,) for m in (1, 2, 3, 4, 8, 16, 17, 32, 64, 128, 129)
                 ] + [(2, 3)]:
        x = (torch.randn(*lead, k, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)
        m = x.numel() // k
        want = ti.matmul_int4_plain(x, w)
        counts = ("launches", "tile_launches", "splitk_launches")
        before = [getattr(ti.matmul_int4, c) for c in counts]
        got = ti.matmul_int4(x, w)
        torch.cuda.synchronize()
        assert got.shape == (*lead, n) and got.dtype == torch.float32
        assert _rel(got, want) <= 1e-4, m
        mi, splits = ti.plan(m, n, k, sms)
        assert [getattr(ti.matmul_int4, c) - b for c, b in
                zip(counts, before)] == [1, mi > 0, splits > 1], m
        assert (mi > 0) == (m >= ti.TILE_MIN_M)
    with pytest.raises(ValueError):
        ti.matmul_int4(torch.zeros(1, k + 32, device=dev,
                                   dtype=torch.bfloat16), w)
    big = quantize_weight_int4(torch.randn(ti.MAX_K + 128, 64, device=dev))
    with pytest.raises(ValueError, match="above"):
        ti.matmul_int4(torch.zeros(1, ti.MAX_K + 128, device=dev,
                                   dtype=torch.bfloat16), big)
    # the tile kernel streams K: past MAX_K from TILE_MIN_M rows on
    x = (torch.randn(ti.TILE_MIN_M, ti.MAX_K + 128, generator=g,
                     device=dev) * 0.5).to(torch.bfloat16)
    assert _rel(ti.matmul_int4(x, big), ti.matmul_int4_plain(x, big)) <= 1e-4


@pytest.mark.parametrize("dh,h,hkv", [(128, 16, 8), (128, 8, 8), (64, 16, 2),
                                      (64, 32, 4)])
def test_flash_gqa_decode_matches_plain_and_stacked(dev, dh, h, hkv):
    """The split-prefix kernel within half a bf16 ulp of the plain version
    (and of its split model, decode_split_plain) at cursors across the
    64-slot chunk boundaries, B = 1, 4 and 32, G = 1, 2 and 8; the stacked
    entry gives the same bits."""
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    rng = np.random.default_rng(5 + dh + h)
    s = fd.SPLIT
    cases = [([48], [31], 32), ([1023], [90], 128), ([0], [1], 0),
             ([s - 1], [20], 32), ([s], [20], 32), ([s + 1], [20], 32),
             ([128, 159, 600, 1023], [31, 100, 117, 90], 128),
             ([0, 1, s - 1, s, s + 1, 2 * s, 2 * s + 1, 1023] * 4,
              [1, 2, 20, 30, 10, 25, 5, 60] * 4, 32)]
    for cursors, lengths, prompt_cap in cases:
        b = len(cursors)
        k_all, v_all, t = _cache(rng, 2, b, hkv, 1024, dh, dev)
        q = t((b, h, dh))
        lens, wi = _i32(lengths, dev), _i32(cursors, dev)
        got = fd.flash_gqa_decode(q, k_all[1], v_all[1], lens, wi,
                                  prompt_cap)
        torch.cuda.synchronize()
        want = fd.decode_layer_plain(q.float(), k_all[1].float(),
                                     v_all[1].float(), lens, wi, prompt_cap)
        split = fd.decode_split_plain(q.float(), k_all[1].float(),
                                      v_all[1].float(), lens, wi, prompt_cap)
        for ref in (want, split):
            diff = (got.float() - ref).abs()
            assert bool((diff <= DECODE_ATOL + DECODE_RTOL * ref.abs()
                         ).all()), (cursors[:8], diff.max().item())
        n0 = fd.flash_gqa_decode.combine_launches
        st = fd.flash_gqa_decode_stacked(q, k_all, v_all, lens, wi, 1,
                                         prompt_cap)
        assert torch.equal(st, got)
        assert fd.flash_gqa_decode.combine_launches == n0 + 1  # 16 chunks
        if b == 1:       # a scalar write_idx is every lane's cursor
            assert torch.equal(fd.flash_gqa_decode(
                q, k_all[1], v_all[1], lens, cursors[0], prompt_cap), got)
    # one chunk spans a cache of SPLIT slots: no combine launch
    k_all, v_all, t = _cache(rng, 1, 2, hkv, s, dh, dev)
    q = t((2, h, dh))
    lens, wi = _i32([20, 5], dev), _i32([s - 1, 30], dev)
    n0 = fd.flash_gqa_decode.combine_launches
    got = fd.flash_gqa_decode(q, k_all[0], v_all[0], lens, wi, 32)
    want = fd.decode_layer_plain(q.float(), k_all[0].float(),
                                 v_all[0].float(), lens, wi, 32)
    assert bool(((got.float() - want).abs()
                 <= DECODE_ATOL + DECODE_RTOL * want.abs()).all())
    assert fd.flash_gqa_decode.combine_launches == n0


# Voice cloning's modules on the card against the CPU, the same weights
# (full EngineConfig() widths, seeded) and a 2 s reference: f32 with TF32
# off (core.device.set_cuda_precision), cuFFT / cuDNN / cuBLAS summing in other
# orders than the CPU: codes equal, log-mel within 1e-3 (absolute, natural
# log), the unit-norm embedding within 1e-4 (chip_smoke.py's clone phase
# holds 10 s and 30 s references the same way).
@pytest.mark.parametrize("pooling", ["attentive", "xvector"])
def test_clone_encoders_match_cpu(dev, pooling):
    from qwen3_tts_tpu_torch.core.config import (EngineConfig,
                                                 SpeakerEncoderConfig)
    from qwen3_tts_tpu_torch.core.device import set_cuda_precision
    from qwen3_tts_tpu_torch.models.codec import encoder as enc
    from qwen3_tts_tpu_torch.models.codec import speaker as spk
    from qwen3_tts_tpu_torch.ops.mel import log_mel

    set_cuda_precision()
    cfg = EngineConfig()
    scfg = SpeakerEncoderConfig(pooling=pooling)
    g = torch.Generator().manual_seed(13)
    ep = enc.init_encoder_params(cfg.codec_encoder, g)
    sp = spk.init_speaker_params(scfg, g)

    def on(tree, d):
        if isinstance(tree, dict):
            return {k: on(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [on(v, d) for v in tree]
        return tree.to(d)

    t = np.arange(48000 + 123) / 24000.0
    wav = torch.from_numpy((0.3 * np.sin(2 * np.pi * 150 * t)
                            + 0.05 * np.random.default_rng(1).standard_normal(
                                t.shape)).astype(np.float32))
    with torch.no_grad():
        want = (enc.encode(cfg.codec_encoder, ep, wav[None]), log_mel(wav),
                spk.speaker_embed(scfg, sp, wav))
        x = wav.to(dev)
        got = (enc.encode(cfg.codec_encoder, on(ep, dev), x[None]),
               log_mel(x), spk.speaker_embed(scfg, on(sp, dev), x))
    assert got[0].shape == (1, 24, 16)
    assert torch.equal(got[0].cpu(), want[0])
    assert (got[1].cpu() - want[1]).abs().max().item() <= 1e-3
    assert (got[2].cpu() - want[2]).abs().max().item() <= 1e-4
    assert abs(got[2].norm().item() - 1.0) < 1e-4


@pytest.mark.parametrize("size", ["mini", "mid"])
def test_onnx_graphs_match_cpu(dev, size):
    """The ONNX codec graphs (tests/torch_onnx_fixtures.py) through
    io/onnx_exec on the card against the port on the CPU: the decoder
    whole, in two chunks and as decode_batch of 3 lanes within 1e-5 (f32
    with TF32 off: cuDNN's and cuBLAS's sums in other orders), the audio
    encoder's codes exactly, the speaker embedding within 1e-5."""
    import torch_onnx_fixtures as tfx
    from qwen3_tts_tpu_torch.core.device import set_cuda_precision
    from qwen3_tts_tpu_torch.io.onnx_exec import OnnxExecutor
    from qwen3_tts_tpu_torch.io.onnx_lite import read_onnx_graph
    from qwen3_tts_tpu_torch.models.codec.onnx_decoder import (
        OnnxAudioEncoder, OnnxSpeakerEncoder, OnnxStreamingDecoder)

    set_cuda_precision()
    dims = tfx.MINI if size == "mini" else tfx.Dims(
        DL=32, DA=64, DC=48, H=4, DH=16, K0=5, K1=5, K2=3, VOCAB=256,
        LAYERS=2, up_factors=(4, 5), up_channels=(48, 16, 1))
    data, _ = tfx.build_decoder(dims)
    on = {d: OnnxStreamingDecoder(OnnxExecutor(read_onnx_graph(data), d))
          for d in ("cpu", dev)}
    rng = np.random.default_rng(5)
    codes = rng.integers(0, dims.VOCAB, size=(3, 6, 16))
    for lane in range(3):
        want, _ = on["cpu"].decode(codes[lane], on["cpu"].create_state(),
                                   is_final=True)
        got, st = on[dev].decode(codes[lane, :4], on[dev].create_state())
        got2, st = on[dev].decode(codes[lane, 4:], st, is_final=True)
        assert st["past_key_0"].device.type == "cuda"
        np.testing.assert_allclose(np.concatenate([got, got2]), want,
                                   rtol=1e-5, atol=1e-5)
    wavs, _ = on[dev].decode_batch(codes, [on[dev].create_state()
                                           for _ in range(3)], is_final=True)
    for lane in range(3):
        want, _ = on["cpu"].decode(codes[lane], on["cpu"].create_state(),
                                   is_final=True)
        np.testing.assert_allclose(wavs[lane], want, rtol=1e-5, atol=1e-5)
    enc = tfx.EncDims(hop=2000, d=64) if size == "mid" else tfx.EncDims(
        hop=16, d=8)
    edata, _ = tfx.build_encoder(enc)
    sdata, _ = tfx.build_speaker()
    wav = (rng.standard_normal(enc.hop * 12 + 7) * 0.2).astype(np.float32)
    mels = rng.standard_normal((50, 128)).astype(np.float32)
    out = {}
    for d in ("cpu", dev):
        out[d] = (OnnxAudioEncoder(OnnxExecutor(read_onnx_graph(edata), d))
                  .encode(wav),
                  OnnxSpeakerEncoder(OnnxExecutor(read_onnx_graph(sdata), d))
                  .encode_mels(mels))
    np.testing.assert_array_equal(out[dev][0], out["cpu"][0])
    np.testing.assert_array_equal(out[dev][0], tfx.encoder_reference(enc,
                                                                     wav))
    np.testing.assert_allclose(out[dev][1], out["cpu"][1], atol=1e-5)


def _onnx_bit_equal(got, want, what):
    assert list(got) == list(want), what
    for k in want:
        if isinstance(want[k], torch.Tensor):
            diff = (got[k].float() - want[k].float()).abs().max().item() \
                if got[k].shape == want[k].shape else float("inf")
            assert got[k].dtype == want[k].dtype and torch.equal(
                got[k], want[k]), f"{what} {k}: max |diff| {diff:.3e}"
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=what)


def test_onnx_jitted_replays_equal_run_on_the_full_decoder(dev, monkeypatch):
    """The published decoder's widths (tests/torch_onnx_fixtures.py FULL):
    OnnxExecutor.jitted against run bit for bit over two streams (chunks
    of 1, 4 and 3 frames: the first plans each signature, the second
    captures and replays its CUDA graph) and an 8-lane decode_batch
    (planned, captured, replayed; against vmap of run), with the bound
    (MAX_SIGNATURES, set to 4) crossed once: the least recently used
    signature goes, and its graph's bytes with it."""
    import torch_onnx_fixtures as tfx
    from qwen3_tts_tpu_torch.io import onnx_exec
    from qwen3_tts_tpu_torch.io.onnx_lite import read_onnx_graph
    from qwen3_tts_tpu_torch.models.codec.onnx_decoder import (
        OnnxStreamingDecoder, _next_name)

    monkeypatch.setattr(onnx_exec, "MAX_SIGNATURES", 4)
    data, _ = tfx.build_decoder(tfx.FULL)
    dec = OnnxStreamingDecoder(onnx_exec.OnnxExecutor(read_onnx_graph(data),
                                                      dev))
    ex, fn = dec.ex, dec.ex.jitted()
    rng = np.random.default_rng(8)
    codes = rng.integers(0, tfx.FULL.VOCAB, size=(8, 8, 16))

    def feeds(c, state, final=False):
        return {"audio_codes": dec._frames(c)[None],
                "is_last": dec._is_last[final], **state}

    for stream in range(2):
        state, lo = dec.create_state(), 0
        for n in (1, 4, 3):
            f = feeds(codes[0, lo:lo + n], state, lo + n == 8)
            got = fn(f)
            _onnx_bit_equal(got, ex.run(f), f"stream {stream} at {lo}")
            state = {k: got[_next_name(k)] for k in dec.state_names}
            lo += n
    assert (ex.stats["plans"], ex.stats["captures"],
            ex.stats["replays"]) == (3, 3, 3)

    def eager_vmap(f):
        host = {}

        def lane(lane_feeds):
            out = ex.run(lane_feeds)
            host.update((k, v) for k, v in out.items()
                        if not isinstance(v, torch.Tensor))
            return {k: v for k, v in out.items()
                    if isinstance(v, torch.Tensor)}

        out = torch.func.vmap(lane)(f)
        out.update(host)
        return {n: out[n] for n in ex.output_names}

    lanes = {"audio_codes": torch.stack([dec._frames(c[:4])[None]
                                         for c in codes]),
             "is_last": torch.stack([dec._is_last[i % 2 == 0]
                                     for i in range(8)])}
    lanes.update({k: torch.stack([v] * 8)
                  for k, v in dec.create_state().items()})
    for call in range(3):
        _onnx_bit_equal(fn.vmap(lanes), eager_vmap(lanes),
                        f"decode_batch call {call}")
    assert (ex.stats["plans"], ex.stats["captures"], ex.stats["graphs"],
            len(fn)) == (4, 4, 4, 4)
    held = ex.stats["graph_bytes"]
    oldest = fn._entries[next(iter(fn._entries))].nbytes
    f = feeds(codes[1, :2], dec.create_state())
    for call in range(2):                  # a fifth signature
        _onnx_bit_equal(fn(f), ex.run(f), f"fifth signature call {call}")
    newest = fn._entries[next(reversed(fn._entries))].nbytes
    assert (len(fn), ex.stats["graphs"], ex.stats["captures"]) == (4, 4, 5)
    assert ex.stats["graph_bytes"] == held - oldest + newest > 0
    _onnx_bit_equal(fn.vmap(lanes), eager_vmap(lanes), "decode_batch after")
    assert ex.stats["replays"] == 3 + 2 + 1 + 1


def test_onnx_failed_capture_names_the_graph(dev, monkeypatch):
    """A handler that synchronizes the device cannot be captured: the
    signature's second call raises OnnxCaptureError naming the graph's
    file and the signature, every later call of it too (no eager result
    in its place), and the executor's other work goes on."""
    import torch_onnx_fixtures as tfx
    from qwen3_tts_tpu_torch.io.onnx_exec import (OnnxCaptureError,
                                                  OnnxExecutor)
    from qwen3_tts_tpu_torch.io.onnx_lite import read_onnx_graph
    from qwen3_tts_tpu_torch.models.codec.onnx_decoder import (
        OnnxStreamingDecoder)

    data, _ = tfx.build_decoder(tfx.MINI)
    dec = OnnxStreamingDecoder(OnnxExecutor(read_onnx_graph(data), dev))
    dec.ex.source = "model/onnx/qwen3_tts_decoder.onnx"
    real = OnnxExecutor._op_Tanh

    def tanh_then_sync(self, node, ins, host):
        torch.cuda.synchronize()
        return real(self, node, ins, host)

    monkeypatch.setattr(OnnxExecutor, "_op_Tanh", tanh_then_sync)
    codes = np.random.default_rng(9).integers(0, tfx.VOCAB, size=(3, 16))
    want, _ = dec.decode(codes, dec.create_state())       # plans: eager
    for _ in range(2):
        with pytest.raises(OnnxCaptureError) as e:
            dec.decode(codes, dec.create_state())
        assert "model/onnx/qwen3_tts_decoder.onnx" in str(e.value)
        assert "audio_codes [1, 3, 16] int64" in str(e.value)
    assert dec.ex.stats["captures"] == dec.ex.stats["replays"] == 0
    monkeypatch.undo()
    got, _ = dec.decode(codes, dec.create_state())          # captures now
    np.testing.assert_array_equal(got, want)
    assert dec.ex.stats["captures"] == dec.ex.stats["replays"] == 1


# ------------------------------------- the verify contract, online and spec
@pytest.mark.parametrize("b", [4, 8])
def test_prefill_kernel_verify_contract(dev, b):
    """The speculative verify forward's attention: S = 4 rows a lane at the
    lane's own start (spread over [32, C - 4]), window = C, the stale rows
    past each lane's last row poisoned: equal to the clean cache's output
    bit for bit, and to the plain version within the prefill tolerance."""
    rng = np.random.default_rng(b)
    c, s = 256, 4
    k, v, t = _cache(rng, 2, b, 8, c, 128, dev)
    q = t((b, s, 16, 128))
    starts = sorted(int(x) for x in rng.integers(32, c - s + 1, b))
    starts[0], starts[-1] = 32, c - s
    lengths = _i32([32 - int(x) for x in rng.integers(0, 20, b)], dev)
    start = _i32(starts, dev)
    clean = flash_gqa_prefill_stacked(q, k, v, lengths, start, 1, 32, c)
    for lane, a in enumerate(starts):
        k[:, lane, :, a + s:] = 300.0
        v[:, lane, :, a + s:] = -300.0
    got = flash_gqa_prefill_stacked(q, k, v, lengths, start, 1, 32, c)
    torch.cuda.synchronize()
    assert torch.equal(got, clean)
    want = prefill_attention_plain(q, k, v, lengths, start, 1, 32, c)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def _small_engine(fused):
    """TtsEngine on the card at the kernels' widths with two layers a model
    (tests/test_torch_serving.py's config), seeded development weights."""
    from qwen3_tts_tpu_torch.core.config import (EngineConfig,
                                                 PredictorConfig,
                                                 TalkerConfig)
    from qwen3_tts_tpu_torch.engine import TtsEngine
    cfg = EngineConfig.tiny().replace(
        talker=TalkerConfig(d_model=2048, n_layers=2, n_heads=2,
                            n_kv_heads=1, head_dim=128, d_ff=256,
                            mrope_sections=(24, 20, 20, 0),
                            dtype="bfloat16"),
        predictor=PredictorConfig(d_model=1024, n_layers=2, n_heads=4,
                                  n_kv_heads=2, head_dim=64, d_ff=256,
                                  dtype="bfloat16"))
    return TtsEngine(config=cfg, device="cuda", speakers_dir="speakers",
                     fused=fused, chunk=False if fused else None)


def test_online_batcher_on_the_card(dev, monkeypatch):
    """OnlineBatcher at batch 8 on the step schedule: 12 greedy requests
    from 3 threads resolve with frames x spf finite samples, the step
    kernels and the lane kernels launch (the chunk kernel does not), the
    worker runs with grad off on the engine's device, and the requests
    one at a time twice give equal audio."""
    import threading
    from qwen3_tts_tpu_torch.core.config import SamplerConfig
    from qwen3_tts_tpu_torch.kernels import flash_decode as tfd
    from qwen3_tts_tpu_torch.serve.batch import BatchRequest
    from qwen3_tts_tpu_torch.serve.codec_path import LaneCodec
    from qwen3_tts_tpu_torch.serve.online import OnlineBatcher

    eng = _small_engine(fused=True)
    eng.set_max_steps(16)
    eng.set_sampler_config(SamplerConfig(temperature=0.0, seed=7))
    spf = eng.config.codec_decoder.samples_per_frame
    voice = eng.get_speaker("vivian")
    reqs = [BatchRequest(f"card {i}", voice, max_frames=(4, 8, 12)[i % 3])
            for i in range(12)]
    seen = []
    run_chunk = LaneCodec.run_chunk

    def spy(self, *a, **kw):
        seen.append((torch.is_grad_enabled(), torch.cuda.current_device()))
        return run_chunk(self, *a, **kw)

    monkeypatch.setattr(LaneCodec, "run_chunk", spy)
    fns = (tts.talker_step_fused, tpf.predict_frame_fused,
           tfd.append_kv_lanes, tfd.inject_prompt_lanes, tcs.gen_chunk_fused)
    before = [f.launches for f in fns]
    ob = OnlineBatcher(eng, batch_size=8, bucket=32, idle_poll_s=0.005)
    results = [None] * len(reqs)

    def client(c):
        for i in range(c, len(reqs), 3):
            results[i] = ob.submit(reqs[i]).result(timeout=300)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    ob.stop()
    moved = [f.launches - n for f, n in zip(fns, before)]
    assert all(m > 0 for m in moved[:4]) and moved[4] == 0, moved
    for r, q in zip(results, reqs):
        assert 0 < r.frames <= q.max_frames
        assert len(r.audio.samples) == r.frames * spf
        assert np.isfinite(r.audio.samples).all()
    assert seen and all(s == (False, eng.device.index or 0) for s in seen)
    runs = []
    for _ in range(2):
        ob = OnlineBatcher(eng, batch_size=8, bucket=32, idle_poll_s=0.005)
        runs.append([ob.submit(q).result(timeout=300) for q in reqs])
        ob.stop()
    for a, b in zip(*runs):
        assert a.frames == b.frames
        np.testing.assert_array_equal(a.audio.samples, b.audio.samples)


def test_spec_on_the_card(dev):
    """gen_frames_spec on an exact engine at 4 lanes and three cursors,
    drafts equal to the sequential frames: the verify forward's logits
    within 5e-2 of max |logit| of 4 sequential steps'; the target frames
    equal the exact predictor run on the verify forward's hidden (B * K
    rows) exactly; n_emit = min(n_acc + 1, K) with n_acc the leading
    frames equal to the draft; the cursors advance by n_emit.  Then the
    targets fed back as drafts, at most K times: every lane emits K frames,
    equal to the draft, and its cursor advances by K.  (The verify
    and the sequential steps sum in other orders, so a target frame may
    leave the sequential one at a near tie: chip_smoke.py's spec phase
    reports those.)"""
    import dataclasses
    from qwen3_tts_tpu_torch.models import predictor as predictor_lib
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    from qwen3_tts_tpu_torch.runtime import generate as tg
    from qwen3_tts_tpu_torch.runtime import spec

    eng = _small_engine(fused=False)
    gen = eng.generator
    pack = gen.assets_pack
    sampler = tg.SamplerParams(0.0, 40, 0.9)
    voice = eng.get_speaker("vivian")
    plans = [eng._build_voice_prompt(f"spec lane {i}", voice, None)
             for i in range(5)]

    def frames(st, n):
        return tg.gen_frames(eng.config, gen.talker_params,
                             gen.predictor_params, pack, st, sampler, n, 32,
                             uniform_cursor=False)

    def clone(st):
        g = torch.Generator(device=st.generator.device)
        g.set_state(st.generator.get_state())
        c = dataclasses.replace(st.cache, k=st.cache.k.clone(),
                                v=st.cache.v.clone(),
                                write_idx=st.cache.write_idx.clone())
        return dataclasses.replace(st, cache=c, logits=st.logits.clone(),
                                   hidden=st.hidden.clone(),
                                   pos=st.pos.clone(), done=st.done.clone(),
                                   generator=g)

    with torch.no_grad():
        embeds, lens = eng.prompt_to_device(plans[:4], 32)
        st = gen.start(embeds, torch.from_numpy(lens).to(dev),
                       torch.Generator(device=dev).manual_seed(0))
        st, _, _ = frames(st, 4)
        eb, lb = eng.prompt_to_device(plans[4:], 32)
        base = gen.refill_lanes(st, eb, [int(lb[0])], [2])
        cursors = [36, 36, 32, 36]
        assert base.cache.write_idx.tolist() == cursors
        seq, codes, logits = clone(base), [], []
        for _ in range(4):
            seq, c, _ = frames(seq, 1)
            codes.append(c[:, 0])
            logits.append(seq.logits.float())
        ref, ref_logits = torch.stack(codes, 1), torch.stack(logits, 1)
        fb = (tg._frame_emb_sum(pack["codec_tables"], ref.reshape(-1, 16))
              .reshape(4, 4, -1) + pack["tts_pad"].float())
        v = clone(base)
        ver, ver_hidden, _ = talker_lib.talker_verify_frames(
            eng.config.talker, gen.talker_params, fb, v.pos, v.cache, 32)
        scale = ref_logits.abs().max().item()
        assert (ver.float() - ref_logits).abs().max().item() <= 5e-2 * scale
        # the target frames the verify forward gives, computed apart
        pick = torch.cat([base.logits.float()[:, None],
                          ver.float()[:, :3]], 1)
        hid = torch.cat([base.hidden[:, None].to(ver_hidden.dtype),
                         ver_hidden[:, :3]], 1).reshape(16, -1)
        h1024 = hid.float() @ pack["proj_w"].float().t() \
            + pack["proj_b"].float()
        want = predictor_lib.predict_frame(
            eng.config.predictor, gen.predictor_params, h1024,
            pick.argmax(-1).reshape(-1).to(torch.int32),
            pack["codec_tables_1024"]).reshape(4, 4, 16)
        out, got, valid, n_emit = spec.gen_frames_spec(
            eng.config, gen.talker_params, gen.predictor_params, pack,
            clone(base), ref, sampler, 32)
    assert torch.equal(got, want)
    for lane in range(4):
        acc = 0
        while acc < 4 and torch.equal(got[lane, acc], ref[lane, acc]):
            acc += 1
        assert int(n_emit[lane]) == min(acc + 1, 4), lane
    assert out.cache.write_idx.tolist() == [
        c + int(n) for c, n in zip(cursors, n_emit.tolist())]
    assert (valid.sum(1) <= n_emit).all()
    assert out.step == base.step + 4
    # full acceptance: the call's own targets fed back as drafts (at most
    # K times) reach a draft every lane accepts whole
    draft = got
    with torch.no_grad():
        for _ in range(4):
            out, got, valid, n_emit = spec.gen_frames_spec(
                eng.config, gen.talker_params, gen.predictor_params, pack,
                clone(base), draft, sampler, 32)
            if torch.equal(got, draft):
                break
            draft = got
    assert n_emit.tolist() == [4] * 4
    assert torch.equal(got, draft)
    assert out.cache.write_idx.tolist() == [c + 4 for c in cursors]
    assert out.step == base.step + 4


def test_tp_prefill_one_rank_nccl_equals_exact(dev, tmp_path):
    """parallel/tp.tp_talker_prefill on a one-rank NCCL group (mesh 1 x 1:
    every projection all-reduced over one rank, the attention kernels at
    the full head counts) equals models/talker.talker_prefill bit for bit:
    logits, hidden and the cache."""
    import torch.distributed as dist
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    from qwen3_tts_tpu_torch.parallel import tp
    from qwen3_tts_tpu_torch.parallel.mesh import make_mesh

    eng = _small_engine(fused=False)
    voice = eng.get_speaker("vivian")
    plans = [eng._build_voice_prompt(f"tensor parallel lane {i}", voice,
                                     None) for i in range(4)]
    embeds, lens = eng.prompt_to_device(plans)
    lengths = torch.from_numpy(lens).to(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, device=dev)
        with torch.no_grad():
            lg, hd, k, v = tp.tp_talker_prefill(eng.config, mesh,
                                                eng.talker_params, embeds,
                                                lengths, 512)
            cache = talker_lib.init_talker_cache(eng.config.talker, 4, 512,
                                                 dev)
            want_lg, want_hd, cache = talker_lib.talker_prefill(
                eng.config.talker, eng.talker_params, embeds, lengths, cache)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert mesh.all_reduces == 4 * eng.config.talker.n_layers
    assert torch.equal(lg, want_lg) and torch.equal(hd, want_hd)
    assert torch.equal(k, cache.k) and torch.equal(v, cache.v)
