"""Time the step schedule's two kernels on the card: predict_frame_fused
(one frame, B = 1, 8, 32) and talker_step_fused in w4a8 (28 layers, C =
1024; B = 1, 8, 32 at cursor 48, and B = 8 at per-lane cursors up to
1023), each with CUDA events around eager calls (`cuda_ms`) and as the
device time of calls captured in one CUDA graph (`graph_ms`), and, where
the kernel records them, its phases' times by label (`us_per_phase`).  Full
`EngineConfig()` widths, weights from a seed.  Prints one JSON line.

The kernels come from whichever `qwen3_tts_tpu_torch` is first on the
path, so the same script times another checkout of the package:

    python3 scripts/torch_step_bench.py --out step_times.json
    PYTHONPATH=/path/to/other/checkout python3 scripts/torch_step_bench.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, n=10, reps=3):
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * n)


def times(fn, labels=None):
    """Events and graph times of fn(); with `labels` (the kernel's phases)
    also us per phase by label: block 0's clocks of one call (fn(clocks))
    scaled to the graph time."""
    import torch
    out = {"cuda_ms": cuda_ms(fn)}
    try:
        out["graph_ms"] = graph_ms(fn)
    except Exception as e:          # noqa: BLE001 - reported, not hidden
        out["graph_ms"] = None
        out["graph_error"] = f"{type(e).__name__}: {e}"[:200]
    if labels is not None and out["graph_ms"]:
        clocks = torch.zeros(len(labels) + 1, dtype=torch.int64,
                             device="cuda")
        fn(clocks)
        cyc = clocks.diff().double().cpu()
        per_cycle = out["graph_ms"] * 1e3 / cyc.sum().item()
        by = {}
        for lab, c in zip(labels, cyc.tolist()):
            n, t = by.get(lab, (0, 0.0))
            by[lab] = (n + 1, t + c * per_cycle)
        out["us_per_phase"] = {lab: round(t / n, 2)
                               for lab, (n, t) in by.items()}
        out["phases"] = len(labels)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--label", default="", help="a name for this checkout")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import qwen3_tts_tpu_torch
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.kernels import predictor_frame as tpf
    from qwen3_tts_tpu_torch.kernels import talker_step as tts
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    from qwen3_tts_tpu_torch.models.predictor import init_predictor_params
    from qwen3_tts_tpu_torch.models.transformer import init_decoder_params

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    res = {"label": args.label, "package": qwen3_tts_tpu_torch.__file__,
           "card": card[0] if card else torch.cuda.get_device_name(0)}
    cfg = EngineConfig()
    g = torch.Generator(device=dev).manual_seed(2)
    t0 = time.perf_counter()
    with torch.no_grad():
        pw = tpf.prep_predictor_weights(
            cfg.predictor, init_predictor_params(cfg.predictor, g))
    tables = (torch.randn(16, 2048, cfg.predictor.d_model, generator=g,
                          device=dev) * 0.3).to(torch.bfloat16)
    for b in (1, 8, 32):
        h = torch.randn(b, cfg.predictor.d_model, generator=g, device=dev)
        c0 = ((torch.arange(b, device=dev) * 977 + 5) % 2048).to(torch.int32)
        before = tpf.predict_frame_fused.launches
        labels = (tpf.phase_labels(cfg.predictor)
                  if hasattr(tpf, "phase_labels") else None)
        res[f"predict_frame_b{b}"] = times(
            lambda clocks=None: tpf.predict_frame_fused(
                cfg.predictor, pw, h, c0, tables,
                **({} if clocks is None else {"clocks": clocks})), labels)
        res[f"predict_frame_b{b}"]["grid"] = getattr(
            tpf.predict_frame_fused, "grid", None)
        assert tpf.predict_frame_fused.launches > before
    del pw
    tcfg = cfg.talker
    with torch.no_grad():
        tw = tts.prep_layer_weights(tcfg, init_decoder_params(tcfg, g))
    cap = 1024

    def rope(positions):
        p = torch.tensor(positions, device=dev)[:, None]
        cos, sin = talker_lib._rope_tables(tcfg, talker_lib._pos4(p))
        return cos[:, 0].contiguous(), sin[:, 0].contiguous()

    cases = [(1, [48], True), (8, [48] * 8, True), (32, [48] * 32, True),
             (8, [32 + (131 * i) % 992 for i in range(7)] + [1023], False)]
    for b, cursors, uniform in cases:
        kv = [(torch.randn(tcfg.n_layers, b, tcfg.n_kv_heads, cap,
                           tcfg.head_dim, generator=g, device=dev) * 0.5
               ).to(torch.bfloat16) for _ in range(2)]
        x = (torch.randn(b, tcfg.d_model, generator=g, device=dev) * 0.5
             ).to(torch.bfloat16)
        cos, sin = rope(cursors)
        lens = torch.full((b,), 31, dtype=torch.int32, device=dev)
        wi = torch.tensor(cursors, dtype=torch.int32, device=dev)
        key = f"talker_w4a8_b{b}" + ("" if uniform else "_per_lane")
        labels = (tts.phase_labels(tcfg) if hasattr(tts, "phase_labels")
                  else None)
        res[key] = times(lambda clocks=None: tts.talker_step_fused(
            tcfg, tw, x, cos, sin, *kv, lens, wi, 32,
            uniform_cursor=uniform,
            **({} if clocks is None else {"clocks": clocks})), labels)
        res[key]["cursors"] = f"{min(cursors)}-{max(cursors)}"
        del kv
    res["seconds"] = round(time.perf_counter() - t0, 1)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
