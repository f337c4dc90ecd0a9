"""Time `flash_gqa_decode_append` on the card, and run the exact serving
queue that launches it.

The kernel at full talker width (28 layers, C = 1024, H = 16, Hkv = 8,
Dh = 128; one layer per call, the layers in turn) at chip_smoke.py's three
shapes: B = 4 at cursors 36-52 in bucket 32 (the exact queue's), B = 4 at
cursors 128 / 159 / 600 / 1023 and B = 8 at per-lane cursors 32-1023.
Each with CUDA events around eager calls and as the device time of 20
calls captured in one CUDA graph.  Then (unless --no-serving) chip_smoke's
exact serving queue (`TtsEngine(fused=False)`, continuous batching at
batch 4, 6 greedy requests over buckets 32 and 128, weights from the
engine's seed) twice: frames/s, the wrapper's launches and digests of the
codes and the audio.  --attend plain / kernel-order runs the queue on
`decode_append_plain` (torch's orders, f32) / `decode_append_kernel_order`
instead of the kernel; --codes-out keeps the first run's codes (per
group [B, F, 16], -1 where a frame is not valid), and --compare A B
prints where two such files first differ.  Prints one JSON line.

The kernel comes from whichever `qwen3_tts_tpu_torch` is first on the
path, so the same script times another checkout of the package:

    python3 scripts/torch_decode_append_bench.py --label new
    PYTHONPATH=/path/to/other/checkout \\
        python3 scripts/torch_decode_append_bench.py --label parent
    python3 scripts/torch_decode_append_bench.py --compare a.npz b.npz
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import time

SHAPES = (   # (name, cursors, prompt lengths, prompt_cap)
    ("b4_36_52", (36, 40, 44, 52), (20, 25, 31, 28), 32),
    ("b4_128_1023", (128, 159, 600, 1023), (117, 90, 128, 31), 128),
    ("b8_32_1023", (32, 47, 64, 200, 511, 600, 900, 1023),
     (31, 20, 25, 31, 28, 17, 30, 9), 32))
TEXTS = ("On the card",                                  # bucket 32
         "A longer serving prompt that lands in the next bucket of the "
         "talker prefill.")                              # bucket 128


def cuda_ms(fn, iters=28, warmup=3):
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, n=20, reps=3):
    import torch
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * n)


def time_kernel(dev):
    import torch
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    n_layers, hkv, cap, dh, h = 28, 8, 1024, 128, 16
    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)

    out = {}
    for name, cursors, lens_, pc in SHAPES:
        b = len(cursors)
        k, v = rnd(n_layers, b, hkv, cap, dh), rnd(n_layers, b, hkv, cap, dh)
        q, kn, vn = rnd(b, h, dh), rnd(b, hkv, dh), rnd(b, hkv, dh)
        i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
        lens, wi = i32(lens_), i32(cursors)

        def call(i):
            return fd.flash_gqa_decode_append(q, k, v, kn, vn, lens, wi,
                                              i % n_layers, pc)
        events = [cuda_ms(call) for _ in range(2)]
        graphs = [graph_ms(call) for _ in range(2)]
        out[name] = dict(cursors=list(cursors), events_ms=events,
                         graph_ms=graphs)
        print(f"{name}: events {events} graph {graphs} ms", flush=True)
        del k, v
    return out


def run_exact_queue(dev, attend="kernel", codes_out=None):
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    from qwen3_tts_tpu_torch.models import transformer
    from qwen3_tts_tpu_torch.serve import codec_path
    from qwen3_tts_tpu_torch.serve.batch import BatchRequest
    from qwen3_tts_tpu_torch.serve.continuous import ContinuousBatcher

    if attend != "kernel":
        transformer.flash_gqa_decode_append = (
            fd.decode_append_plain if attend == "plain"
            else fd.decode_append_kernel_order)
    groups = []
    run_group = codec_path.LaneCodec.run_group

    def recorded(self, *args, **kw):
        out = run_group(self, *args, **kw)
        groups.append(np.where(out[2][..., None], out[1], -1))
        return out
    codec_path.LaneCodec.run_group = recorded
    engine = TtsEngine(device=dev, speakers_dir="speakers", fused=False)
    engine.set_sampler_config(SamplerConfig(seed=7, temperature=0.0,
                                            top_k=40, top_p=0.9))
    voice = engine.get_speaker("vivian")
    budgets = (4, 6, 8)
    queue = [(TEXTS[1 if i % 6 == 5 else 0] + f" {i}.", budgets[i % 3])
             for i in range(6)]
    runs = []
    for rep in range(2):
        groups.clear()
        reqs = [BatchRequest(t, voice, max_frames=m) for t, m in queue]
        batcher = ContinuousBatcher(engine, batch_size=4,
                                    max_frames_per_stream=max(budgets))
        fd.flash_gqa_decode_append.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = batcher.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        frames = sum(r.frames for r in results)
        digest = hashlib.sha256(b"".join(
            np.ascontiguousarray(r.audio.samples).tobytes()
            for r in results)).hexdigest()[:16]
        codes = hashlib.sha256(b"".join(
            np.ascontiguousarray(c, np.int32).tobytes()
            for c in groups)).hexdigest()[:16]
        runs.append(dict(attend=attend, frames=frames, wall_s=wall,
                         frames_per_s=frames / wall,
                         decode_append_launches=
                         fd.flash_gqa_decode_append.launches,
                         codes_sha256=codes, audio_sha256=digest))
        print(f"exact queue: {runs[-1]}", flush=True)
        if rep == 0 and codes_out:
            np.savez(codes_out, *groups)
    codec_path.LaneCodec.run_group = run_group
    return runs


def compare(a_path, b_path):
    """Where two --codes-out files first differ: (group, lane, frame,
    token), and how many codes differ in all."""
    import numpy as np
    a, b = np.load(a_path), np.load(b_path)
    first, n_diff, n = None, 0, 0
    for key in a.files:
        x, y = a[key], b[key]
        if x.shape != y.shape:
            return dict(first=f"{key}: shapes {x.shape} / {y.shape}")
        d = np.argwhere(x != y)
        n_diff += len(d)
        n += int((x >= 0).sum())
        if first is None and len(d):
            first = (key, *map(int, d[0]))
    return dict(groups=len(a.files), codes=n, differing=n_diff,
                first=first)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--no-serving", action="store_true")
    ap.add_argument("--no-kernel", action="store_true",
                    help="skip the kernel's times")
    ap.add_argument("--attend", default="kernel",
                    choices=("kernel", "plain", "kernel-order"))
    ap.add_argument("--codes-out", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(compare(*args.compare)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 2
    import qwen3_tts_tpu_torch
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    res = dict(label=args.label, package=qwen3_tts_tpu_torch.__file__,
               card=card.strip().splitlines()[0] if card.strip() else None)
    if not args.no_kernel:
        res["kernel"] = time_kernel(dev)
    if not args.no_serving:
        res["exact_queue"] = run_exact_queue(dev, args.attend,
                                             args.codes_out)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
