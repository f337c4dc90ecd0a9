#!/usr/bin/env python3
"""Where one preset-voice request's time goes in qwen3_tts_tpu_torch.

    python3 scripts/torch_profile_request.py [--frames 32] [--out DIR]

Runs a full-width TtsEngine(device="cuda") (random weights, greedy, one
warm-up request), then one request under torch.profiler with CPU and CUDA
activities.  Prints the request's ms/frame with and without the profiler,
the device-busy share (sum of kernel time over wall time), kernel launches
per frame, and the top operators by device and by host time; writes the
tables under --out (a chrome trace of one request is ~100 MB, so none is
written).  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TEXT = "Hello from the H100."


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--out", type=Path,
                    default=Path("qwen3_tts_tpu_torch/build/profile"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 2
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    engine = TtsEngine(device="cuda", speakers_dir="speakers")
    engine.set_max_steps(args.frames)
    engine.set_sampler_config(SamplerConfig(temperature=0.0, seed=1))
    voice = engine.get_speaker("vivian")

    def request():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate_with_voice(TEXT, voice)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1000.0

    request()                                  # warm-up (cuBLAS, kernels)
    plain_ms = [request() for _ in range(3)]
    frames = engine.last_metrics.frames
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        prof_ms = request()
    events = prof.key_averages()
    # kernel rows only: an operator's own row repeats its kernels' time
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    args.out.mkdir(parents=True, exist_ok=True)
    by_dev = events.table(sort_by="self_device_time_total", row_limit=25)
    by_cpu = events.table(sort_by="self_cpu_time_total", row_limit=25)
    (args.out / "torch_request_ops.txt").write_text(
        f"{card}\n\nby device time\n{by_dev}\n\nby host time\n{by_cpu}\n")
    print(by_dev)
    print(by_cpu)
    summary = {
        "card": card, "frames": frames,
        "request_ms": plain_ms,
        "ms_per_frame": [m / frames for m in plain_ms],
        "profiled_request_ms": prof_ms,
        "device_kernel_ms": device_us / 1000.0,
        "device_busy_share_profiled": device_us / 1000.0 / prof_ms,
        "device_busy_share_unprofiled": (device_us / 1000.0
                                         / (sum(plain_ms) / len(plain_ms))),
        "kernel_launches": n_kernels,
        "launches_per_frame": n_kernels / frames,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
