"""The benchmark of qwen3_tts_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  One cell of BENCHMARK.json: set-up (the
seed's weights made on the card, the engine, a warm-in of the cell's own
traffic), a window of `--seconds` of that traffic, then the correctness
check against the plain reference.  The last line of standard output is
one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device, with
--trace 1 breakdown, and last `check`: each number compared with its
limit, also printed as the last lines of standard error.

Exits 2 without a result where no CUDA card is present or fewer cards
than the cell asks for, and 3 where jax, jaxlib, flax or qwen3_tts_tpu
was imported by the end of the run.  Kernel builds and caches stay in the
checkout (qwen3_tts_tpu_torch/build/, .bench_cache/).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one busy host thread (the batcher's worker or the stream's caller): no
# pools of CPU threads spinning beside it
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the fp8 control on the same requests "
                         "(for setting limits; never in a benchmark run)")
    ap.add_argument("--dump", default=None,
                    help="write every request's times to this file, inside "
                         "the checkout (for studying spread; never in a "
                         "benchmark run)")
    args = ap.parse_args()

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 2
    from harness import runner
    out = runner.execute(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START,
                         control=bool(args.control),
                         dump=ROOT / args.dump if args.dump else None)
    found = runner.forbidden_modules()
    if found:
        print(f"no result: {found} imported in the benchmark's process",
              file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
