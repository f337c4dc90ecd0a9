#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qwen3_tts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (exit code 1 otherwise; 2 without CUDA):
  1. build: compile the CUDA kernels from qwen3_tts_tpu_torch/csrc (nvcc,
     sm_90a) and load them;
  2. kernels: each kernel against its plain PyTorch version at the shapes
     the main path gives it (talker: B=1, H=16, Hkv=8, Dh=128, L=28,
     C=1024, prefill S=32 and 128, decode at cursors past prompt_cap;
     predictor: Dh=64, C=17), max error against the stated tolerance, and
     both timed with CUDA events (layers rotated, so the 117 MB talker
     cache does not sit in L2);
  3. reference: a two-layer model at full width, same weights on the card
     and on the CPU (plain attention): prefill logits and the codec's
     waveform agree within the stated tolerance;
  4. engine: a full-width TtsEngine(device="cuda") (28-layer talker,
     6-layer predictor, 8-layer codec, bf16, random weights) serves
     preset-voice requests at prompt buckets 32 and 128, greedy and
     sampled, max_steps 32; the kernels' launch counters, reset just
     before, must all be > 0 after.
It prints one JSON line with the kernels' numbers, then the card's name and
power limit, then the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

MAX_STEPS = 32
GREEDY = dict(temperature=0.0, top_k=40, top_p=0.9)
SAMPLED = dict(temperature=0.7, top_k=40, top_p=0.9)
# (label, text, instruction, sampler, seed); the hashing tokenizer gives one
# id per character, and a preset-voice prompt is 11 rows + the text
REQUESTS = [
    ("greedy-b32", "Hello from the H100.", None, GREEDY, 1),
    ("greedy-b128", "A longer sentence that fills the next prompt bucket "
     "of the talker prefill, one row per character.", None, GREEDY, 2),
    ("sampled-b32", "Sampled speech here.", None, SAMPLED, 3),
    ("sampled-b128", "Speak calmly: the preset voice path runs on the card "
     "with its own attention kernels.", "Calm", SAMPLED, 4),
    ("greedy-b32-again", "Hello from the H100.", None, GREEDY, 1),
]
PREFILL_TOL = 2e-2   # bf16 K/V and bf16 p in P.V against f32 attention
# The decode kernel computes in f32, as its plain version does, and rounds
# only its output to bf16: against the plain version's f32 result on the
# same inputs it is off by at most half a bf16 ulp (2^-8 of the value),
# plus f32 summation order.
DECODE_RTOL, DECODE_ATOL = 2.0 ** -8, 1e-5
REF_REL_TOL = 5e-2   # bf16 model on two devices: relative to max |ref|


def cuda_ms(fn, iters: int = 28) -> float:
    import torch
    for _ in range(3):
        fn(0)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def check_kernels(dev, failures):
    """Kernel vs plain at the main path's shapes; returns per-kernel
    results {name: {max_abs_err, ms, plain_ms}}."""
    import torch
    from qwen3_tts_tpu_torch.kernels.flash_decode import (
        decode_attention_plain, flash_gqa_decode_stacked)
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked, prefill_attention_plain)

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    out = {}
    # talker: L=28, B=1, Hkv=8, C=1024, Dh=128; predictor: L=6, C=17, Dh=64
    talker_kv = (rnd(28, 1, 8, 1024, 128), rnd(28, 1, 8, 1024, 128))
    pred_kv = (rnd(6, 1, 8, 17, 64), rnd(6, 1, 8, 17, 64))

    errs = []
    for s, length in ((128, 117), (32, 31)):          # talker buckets
        q = rnd(1, s, 16, 128)
        args = (q, *talker_kv, i32(length), i32(0))
        got = flash_gqa_prefill_stacked(*args, 5, s, s)
        torch.cuda.synchronize()
        want = prefill_attention_plain(*args, 5, s, s)
        err = (got.float() - want.float()).abs().max().item()
        errs.append(err)
        print(f"[kernel] flash_gqa_prefill_stacked S={s} window={s} "
              f"length={length} Dh=128: max_abs_err={err:.3e} "
              f"tol={PREFILL_TOL}")
    q = rnd(1, 2, 16, 64)
    args = (q, *pred_kv, i32(0), i32(0))
    got = flash_gqa_prefill_stacked(*args, 3, 0, 2)
    want = prefill_attention_plain(*args, 3, 0, 2)
    err = (got.float() - want.float()).abs().max().item()
    errs.append(err)
    print(f"[kernel] flash_gqa_prefill_stacked S=2 window=2 Dh=64 "
          f"(predictor): max_abs_err={err:.3e} tol={PREFILL_TOL}")
    if max(errs) > PREFILL_TOL:
        failures.append("flash_gqa_prefill_stacked disagrees with plain")
    q128 = rnd(1, 128, 16, 128)
    lens, st = i32(117), i32(0)
    ms = plain = 0.0
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            ms += cuda_ms(lambda i: flash_gqa_prefill_stacked(
                q128, *talker_kv, lens, st, i % 28, 128, 128)) / 2
        else:
            plain += cuda_ms(lambda i: prefill_attention_plain(
                q128, *talker_kv, lens, st, i % 28, 128, 128)) / 2
    print(f"[kernel] flash_gqa_prefill_stacked S=128 per layer: "
          f"{ms:.4f} ms, plain {plain:.4f} ms")
    out["flash_gqa_prefill_stacked"] = dict(max_abs_err=max(errs), ms=ms,
                                            plain_ms=plain)

    errs = []
    tol = f"{DECODE_ATOL} + 2^-8*|plain f32|"

    def decode_vs_plain(q, kv, length, cursor, layer, prompt_cap):
        """Kernel against the plain version's f32 result on the same
        (bf16-exact) inputs; returns the max abs error, and records a
        failure where an element is off by more than the tolerance."""
        lw, wi = i32(length), i32(cursor)
        got = flash_gqa_decode_stacked(q, *kv, lw, wi, layer, prompt_cap)
        torch.cuda.synchronize()
        want = decode_attention_plain(
            q.float(), kv[0][layer:layer + 1].float(),
            kv[1][layer:layer + 1].float(), lw, wi, 0, prompt_cap)
        diff = (got.float() - want).abs()
        if not bool((diff <= DECODE_ATOL + DECODE_RTOL * want.abs()).all()):
            failures.append(f"flash_gqa_decode_stacked disagrees with plain "
                            f"at cursor {cursor}")
        errs.append(diff.max().item())
        return errs[-1]

    q = rnd(1, 16, 128)
    for prompt_cap, length, cursor in ((32, 31, 32), (32, 31, 47),
                                       (128, 117, 159), (128, 90, 1023)):
        err = decode_vs_plain(q, talker_kv, length, cursor, 7, prompt_cap)
        print(f"[kernel] flash_gqa_decode_stacked C=1024 prompt_cap="
              f"{prompt_cap} length={length} cursor={cursor} Dh=128: "
              f"max_abs_err={err:.3e} tol={tol}")
    qp = rnd(1, 16, 64)
    for cursor in (2, 9, 15):
        err = decode_vs_plain(qp, pred_kv, 0, cursor, 4, 0)
        print(f"[kernel] flash_gqa_decode_stacked C=17 cursor={cursor} "
              f"Dh=64 (predictor): max_abs_err={err:.3e} tol={tol}")
    lens, wi = i32(31), i32(48)     # bucket 32, 16 frames into a request
    ms = plain = 0.0
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            ms += cuda_ms(lambda i: flash_gqa_decode_stacked(
                q, *talker_kv, lens, wi, i % 28, 32)) / 2
        else:
            plain += cuda_ms(lambda i: decode_attention_plain(
                q, *talker_kv, lens, wi, i % 28, 32)) / 2
    print(f"[kernel] flash_gqa_decode_stacked C=1024 cursor=48 per layer: "
          f"{ms:.4f} ms, plain {plain:.4f} ms")
    out["flash_gqa_decode_stacked"] = dict(max_abs_err=max(errs), ms=ms,
                                           plain_ms=plain)
    return out


def check_reference(dev, failures):
    """Two-layer, full-width model: the card against the CPU's plain path
    on the same weights."""
    import dataclasses

    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import EngineConfig, TtsEngine

    base = EngineConfig()
    cfg = base.replace(
        talker=dataclasses.replace(base.talker, n_layers=2),
        predictor=dataclasses.replace(base.predictor, n_layers=2),
        codec_decoder=dataclasses.replace(base.codec_decoder, n_layers=2))
    cpu = TtsEngine(config=cfg, device="cpu", init_seed=5)

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [move(v) for v in tree]
        return tree.to(dev)

    assets = dataclasses.replace(
        cpu.assets, **{f: getattr(cpu.assets, f).to(dev) for f in (
            "text_table", "codec_tables", "codec_tables_1024", "proj_w",
            "proj_b", "tts_pad")})
    gpu = TtsEngine(config=cfg, device=dev, weights=dict(
        assets=assets, talker=move(cpu.talker_params),
        predictor=move(cpu.predictor_params),
        codec_decoder=move(cpu.codec_decoder_params)))
    voice = gpu.get_speaker("vivian")
    plan = gpu._build_voice_prompt(REQUESTS[0][1], voice, None)
    with torch.no_grad():
        logits = []
        for eng in (cpu, gpu):
            g = torch.Generator(device=eng.device).manual_seed(0)
            state, _ = eng._start_state(plan, g)
            logits.append(state.logits.float().cpu())
        ref = logits[0].abs().max().item()
        err = (logits[1] - logits[0]).abs().max().item()
        print(f"[reference] prefill logits, 2-layer full-width talker, card "
              f"vs CPU: max_abs_err={err:.3e} max|ref|={ref:.3e} "
              f"tol={REF_REL_TOL}*max|ref|")
        if not err <= REF_REL_TOL * ref:
            failures.append("card prefill logits disagree with the CPU")
        from qwen3_tts_tpu_torch.models.codec import decoder as cd
        codes = torch.from_numpy(np.random.default_rng(0).integers(
            0, 2048, (1, 8, 16))).to(torch.int32)
        wavs = []
        for eng in (cpu, gpu):
            st = cd.init_decoder_state(cfg.codec_decoder, 1, eng.device)
            w, _ = cd.decode_chunk(cfg.codec_decoder,
                                   eng.codec_decoder_params,
                                   codes.to(eng.device), st)
            wavs.append(w.float().cpu())
        ref = wavs[0].abs().max().item()
        err = (wavs[1] - wavs[0]).abs().max().item()
        print(f"[reference] codec decode of 8 frames, 2-layer full-width, "
              f"card vs CPU: max_abs_err={err:.3e} max|ref|={ref:.3e} "
              f"tol={REF_REL_TOL}*max|ref|")
        if not err <= REF_REL_TOL * ref:
            failures.append("card codec waveform disagrees with the CPU")


def drive_engine(dev, failures):
    """The main path at full width; returns the kernels' launch counts."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.kernels.flash_decode import (
        flash_gqa_decode_stacked)
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked)

    t0 = time.perf_counter()
    engine = TtsEngine(device=dev, speakers_dir="speakers")
    torch.cuda.synchronize()
    print(f"[engine] full-width TtsEngine on {dev}: init "
          f"{time.perf_counter() - t0:.2f} s, talker "
          f"{engine.config.talker.n_layers} layers d "
          f"{engine.config.talker.d_model}, dtype {engine.config.talker.dtype}")
    engine.set_max_steps(MAX_STEPS)
    voice = engine.get_speaker("vivian")
    spf = engine.config.codec_decoder.samples_per_frame
    codes_by_label = {}

    flash_gqa_prefill_stacked.launches = 0
    flash_gqa_decode_stacked.launches = 0
    for label, text, instruct, sampler, seed in REQUESTS:
        engine.set_sampler_config(SamplerConfig(seed=seed, **sampler))
        t0 = time.perf_counter()
        audio = engine.generate_with_voice(text, voice, instruct)
        wall_ms = (time.perf_counter() - t0) * 1000.0
        m = engine.last_metrics
        plan = engine._build_voice_prompt(text, voice, instruct)
        bucket = engine._bucket(plan.length)
        x = audio.samples
        frames = m.frames
        ok = (frames > 0 and len(x) == frames * spf
              and bool(np.isfinite(x).all()) and float(np.abs(x).max()) > 1e-4)
        decode_ms = m.total_ms - m.prefill_ms
        print(f"[engine] {label}: prompt_rows={plan.length} bucket={bucket} "
              f"frames={frames} samples={len(x)} (= frames x {spf}: "
              f"{len(x) == frames * spf}) finite={bool(np.isfinite(x).all())} "
              f"peak={float(np.abs(x).max()) if len(x) else 0.0:.4f} "
              f"eos={m.eos} prefill_ms={m.prefill_ms:.2f} "
              f"total_ms={m.total_ms:.2f} wall_ms={wall_ms:.2f} "
              f"ms/frame={m.total_ms / max(frames, 1):.2f} "
              f"decode ms/frame={decode_ms / max(frames, 1):.2f}")
        if not ok:
            failures.append(f"request {label} gave bad audio")
        codes_by_label[label] = engine.last_codes
    launches = {"flash_gqa_prefill_stacked": flash_gqa_prefill_stacked.launches,
                "flash_gqa_decode_stacked": flash_gqa_decode_stacked.launches}
    same = np.array_equal(codes_by_label["greedy-b32"],
                          codes_by_label["greedy-b32-again"])
    print(f"[engine] two greedy runs, same seed: codes equal={same}")
    if not same:
        failures.append("greedy runs with one seed gave different codes")
    print(f"[engine] launch counts over the requests: {launches}")
    for name, n in launches.items():
        if n <= 0:
            failures.append(f"main path never launched {name}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from qwen3_tts_tpu_torch.engine import set_cuda_precision
    from qwen3_tts_tpu_torch.kernels import build

    set_cuda_precision()
    print(f"[precision] allow_tf32: matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)
    failures = []

    cached = (build.BUILD_ROOT / build.source_hash()).exists()
    t0 = time.perf_counter()
    build.LIBRARY.get()
    print(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: {build.LIBRARY.path} "
          f"in {time.perf_counter() - t0:.2f} s"
          f"{' (library of these sources already built)' if cached else ''}")

    phases = (("kernels", check_kernels), ("reference", check_reference),
              ("engine", drive_engine))
    results = {}
    for name, fn in phases:
        try:
            results[name] = fn(dev, failures)
        except Exception as e:      # report every phase, then fail
            import traceback
            traceback.print_exc()
            failures.append(f"phase {name} raised {e!r}")
    torch.cuda.synchronize()

    kernels = []
    sources = {"flash_gqa_prefill_stacked": (
                   "qwen3_tts_tpu_torch/csrc/flash_prefill.cu",
                   "qwen3_tts_tpu/kernels/flash_prefill.py:137"),
               "flash_gqa_decode_stacked": (
                   "qwen3_tts_tpu_torch/csrc/flash_decode.cu",
                   "qwen3_tts_tpu/kernels/flash_decode.py:171")}
    for name, (src, replaces) in sources.items():
        k = (results.get("kernels") or {}).get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": (results.get("engine") or {}).get(name, 0),
                        "max_abs_err": k.get("max_abs_err"),
                        "ms": k.get("ms"), "plain_ms": k.get("plain_ms")})
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
