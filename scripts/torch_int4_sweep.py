#!/usr/bin/env python3
"""Time matmul_int4's two kernels over their launch choices, in CUDA graphs.

    python3 scripts/torch_int4_sweep.py [--stages 3,4,5,6] [--ms 32,128]
        [--crossover 2,3,4]

For the talker's four int4 weight shapes (chip_smoke.INT4_SHAPES) and each
M in --ms, builds csrc/int4_matmul.cu once per pipeline depth in --stages
(its STAGES constant substituted, one nvcc each, in parallel, under
qwen3_tts_tpu_torch/build/int4_sweep/) and times the tile kernel at every
mi (m16 tiles per warp) and K split around the wrapper's plan
(kernels/int4_matmul.tile_plan), each within INT4_TOL of the plain
version, beside torch.matmul on the dequantized bf16 weight: CUDA-graph
device time per call (chip_smoke.graph_ms), weight copies in turn so that
the weights do not sit in L2.  Prints the ten fastest choices per
(shape, M), marking the plan's.  At each M in --crossover (at most 4, the
small-M kernel's limit) it times the small-M kernel against the tile
kernel at its plan: the measurement behind TILE_MIN_M.  Both kernels are
called through their C entries.  Needs one NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def build_variants(stages):
    """{stages: ctypes library} of int4_matmul.cu at each depth."""
    from qwen3_tts_tpu_torch.kernels.build import (BUILD_ROOT, CSRC,
                                                    HEADERS, NVCC_FLAGS,
                                                    nvcc_path)
    src = (CSRC / "int4_matmul.cu").read_text()
    default = "constexpr int STAGES = 4;"
    if default not in src:
        raise SystemExit(f"int4_matmul.cu no longer says {default!r}")
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for st in stages:
        d = BUILD_ROOT / "int4_sweep" / f"stages{st}"
        d.mkdir(parents=True, exist_ok=True)
        for h in HEADERS:
            (d / h).write_text((CSRC / h).read_text())
        (d / "k.cu").write_text(src.replace(default,
                                            f"constexpr int STAGES = {st};"))
        procs[st] = (d, subprocess.Popen(
            [nvcc_path(), *flags, "-shared", "-o", str(d / "k.so"),
             str(d / "k.cu")]))
    libs = {}
    for st, (d, p) in procs.items():
        if p.wait() != 0:
            raise SystemExit(f"nvcc failed at STAGES = {st}")
        lib = ctypes.CDLL(str(d / "k.so"))
        lib.qtts_int4_matmul_tile.argtypes = ([ctypes.c_void_p] * 5
                                              + [ctypes.c_int] * 6
                                              + [ctypes.c_void_p])
        lib.qtts_int4_matmul_tile.restype = ctypes.c_int
        lib.qtts_int4_matmul.argtypes = ([ctypes.c_void_p] * 4
                                         + [ctypes.c_int] * 4
                                         + [ctypes.c_void_p])
        lib.qtts_int4_matmul.restype = ctypes.c_int
        libs[st] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", default="3,4,5,6")
    ap.add_argument("--ms", default="32,128")
    ap.add_argument("--crossover", default="2,3,4")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import INT4_SHAPES, INT4_TOL, graph_ms
    from qwen3_tts_tpu_torch.kernels import int4_matmul as ti
    from qwen3_tts_tpu_torch.ops.quant import quantize_weight_int4

    dev = torch.device("cuda", 0)
    libs = build_variants([int(v) for v in args.stages.split(",")])
    g = torch.Generator(device=dev).manual_seed(1)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def run(lib, x, w, mi, splits):
        """The tile kernel at (mi, splits); mi = 0: the small-M kernel."""
        q4, s = w["q4"], w["s"]
        m, k = x.shape
        n = q4.shape[0]
        y = torch.empty(m, n, dtype=torch.float32, device=dev)
        ws = (torch.empty(splits, m, n, dtype=torch.float32, device=dev)
              if splits > 1 else None)
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), q4.data_ptr(), s.data_ptr(), y.data_ptr())
        if mi == 0:
            rc = lib.qtts_int4_matmul(*args, m, n, k, k // s.shape[1],
                                      stream)
        else:
            rc = lib.qtts_int4_matmul_tile(
                *args, None if ws is None else ws.data_ptr(), m, n, k,
                k // s.shape[1], mi, splits, stream)
        if rc != 0:
            raise RuntimeError(f"int4 kernel (mi {mi}) failed: {rc}")
        return y

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[sweep] {smi}; CUDA-graph device ms per call")
    failed = False
    for k, n in INT4_SHAPES:
        w = quantize_weight_int4(torch.randn(k, n, generator=g, device=dev)
                                 * k ** -0.5)
        copies = [w] + [{a: t.clone() for a, t in w.items()} for _ in
                        range(max(0, math.ceil(64e6 / (k * n / 2)) - 1))]
        dense = ti._dequant_bf16(w)
        for m in (int(v) for v in args.ms.split(",")):
            x = (torch.randn(m, k, generator=g, device=dev) * 0.5).to(
                torch.bfloat16)
            want = ti.matmul_int4_plain(x, w)
            lib_ms = graph_ms(lambda i: torch.matmul(x, dense))
            plan = ti.tile_plan(m, n, k, sms)
            steps = math.ceil(k / ti.TILE_K)
            res = []
            for st, lib in libs.items():
                for mi in (1, 2, 4):
                    if 32 * mi > 2 * max(m, 32):
                        continue
                    for splits in sorted({1, 2, 3, 4, 6, 8, 12, 16,
                                          plan[1]}):
                        if splits > steps:
                            continue
                        got = run(lib, x, w, mi, splits)
                        err = ((got - want).abs().max()
                               / want.abs().max()).item()
                        failed |= not err <= INT4_TOL
                        t = graph_ms(lambda i: run(
                            lib, x, copies[i % len(copies)], mi, splits))
                        res.append((t, st, mi, splits))
            res.sort()
            rows = []
            for t, st, mi, sp in res[:10]:
                mark = " <- plan" if (st, mi, sp) == (4, *plan) else ""
                rows.append(f"stages {st} mi {mi} splits {sp} {t:.4f} "
                            f"({t / lib_ms:.2f}x){mark}")
            print(f"[sweep] K={k} N={n} M={m}: torch.matmul {lib_ms:.4f}; "
                  f"plan (mi, splits) = {plan} at STAGES 4; fastest: "
                  + "; ".join(rows), flush=True)
        lib = libs[4] if 4 in libs else next(iter(libs.values()))
        for m in (int(v) for v in args.crossover.split(",") if v):
            x = (torch.randn(m, k, generator=g, device=dev) * 0.5).to(
                torch.bfloat16)
            want = ti.matmul_int4_plain(x, w)
            plan = ti.tile_plan(m, n, k, sms)
            times = []
            for mi, splits in ((0, 0), plan):
                got = run(lib, x, w, mi, splits)
                err = ((got - want).abs().max() / want.abs().max()).item()
                failed |= not err <= INT4_TOL
                times.append(graph_ms(lambda i: run(
                    lib, x, copies[i % len(copies)], mi, splits)))
            print(f"[crossover] K={k} N={n} M={m}: small-M kernel "
                  f"{times[0]:.4f} ms, tile kernel {times[1]:.4f} ms "
                  f"(plan {plan}); the wrapper takes the "
                  f"{'tile' if m >= ti.TILE_MIN_M else 'small-M'} kernel",
                  flush=True)
        del copies
    if failed:
        print(f"error: a choice was beyond INT4_TOL = {INT4_TOL}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
