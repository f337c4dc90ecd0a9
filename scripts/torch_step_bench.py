"""Time the step schedule's two kernels on the card: predict_frame_fused
(one frame, B = 1, 8, 32) and talker_step_fused in w4a8 (28 layers, C =
1024; B = 1, 8, 32 at cursor 48, and B = 8 at per-lane cursors up to
1023), and the chunk kernel gen_chunk_fused (F = 4, C = 1024; B = 1 at
start 32, 8 at 1020, 16 at 159, 24 at 32, 32 at 600, greedy, ragged
prompt lengths: chip_smoke.py's cases) beside four frames of the step
schedule (predict_frame_fused + talker_step_fused) at the same B and
cursors; each chunk entry names the grid it ran on (blocks, warps a
block).  Each with
CUDA events around eager calls (`cuda_ms`) and as the device time of calls
captured in one CUDA graph (`graph_ms`), and, where the kernel records
them, its phases' times by label (`us_per_phase`).  Full `EngineConfig()`
widths, weights from a seed.  Prints one JSON line.

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


def split_marks(fn, labels):
    """Per phase label, block 0's SM kilocycles (`marks`) from the barrier
    before to its ring landing (after the rows' staging), to warp 0's
    tiles done, to the work done, to the barrier reached (after the next
    fill is issued) and to the barrier left: {label: [stage+ring, tiles,
    rest of the work, fill, barrier]}."""
    import torch
    n = len(labels)
    clocks = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    marks = torch.zeros(4 * n, dtype=torch.int64, device="cuda")
    fn(clocks, marks)
    torch.cuda.synchronize()
    c, m = clocks.tolist(), marks.view(n, 4).tolist()
    by = {}
    for i, lab in enumerate(labels):
        t0, t4 = c[i], c[i + 1]
        landed, tiles, done, reached = m[i]
        reached = reached or t4
        done = done or reached
        tiles = tiles or done
        landed = landed or t0
        parts = [landed - t0, tiles - landed, done - tiles, reached - done,
                 t4 - reached]
        k, acc = by.get(lab, (0, [0] * 5))
        by[lab] = (k + 1, [x + y for x, y in zip(acc, parts)])
    return {lab: [round(x / k / 1000, 2) for x in acc]
            for lab, (k, acc) in by.items()}


CHUNK_CASES = ((1, 32, 32), (8, 128, 1020), (16, 128, 159), (24, 32, 32),
               (32, 128, 600))        # (B, prompt_cap, start): chip_smoke's


def chunk_cases(res, cfg, g, tp, pp, tw, pw, tables, n_frames=4):
    """gen_chunk_fused per 4-frame chunk at CHUNK_CASES, and four frames of
    the step schedule at the same lanes and cursors (one predictor frame
    and one talker step a frame, the cursor uniform)."""
    import inspect
    import torch
    from qwen3_tts_tpu_torch.io.assets import Assets
    from qwen3_tts_tpu_torch.kernels import chunk_step as cs
    from qwen3_tts_tpu_torch.kernels import predictor_frame as tpf
    from qwen3_tts_tpu_torch.kernels import talker_step as tts
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    dev = torch.device("cuda")
    tcfg, pcfg = cfg.talker, cfg.predictor
    with torch.no_grad():
        pw4 = cs.prep_predictor_w4(pcfg, pp)
        pack = Assets.random_init(g, dtype=torch.bfloat16).pack()
        ex = cs.prep_chunk_extras(tcfg, pcfg, tp, pp, pack)
    has_marks = "marks" in inspect.signature(cs.gen_chunk_fused).parameters
    cap, greedy = 1024, (0.0, 40, 0.9)
    for b, pcap, start in CHUNK_CASES:
        lens = torch.tensor([pcap - 1 - (7 * i) % (pcap // 2)
                             for i in range(b)], dtype=torch.int32,
                            device=dev)
        pos = lens + (start - pcap)
        kv = [(torch.randn(tcfg.n_layers, b, tcfg.n_kv_heads, cap,
                           tcfg.head_dim, generator=g, device=dev) * 0.5
               ).to(torch.bfloat16) for _ in range(2)]
        lg = torch.randn(b, cs.V_CODEC, generator=g, device=dev) * 2.0
        hd = torch.randn(b, tcfg.d_model, generator=g, device=dev)
        p = pos.long()[None, :] + torch.arange(n_frames, device=dev)[:, None]
        cos, sin = (t.float().contiguous() for t in talker_lib._rope_tables(
            tcfg, talker_lib._pos4(p)))
        zeros = torch.zeros(n_frames, b, device=dev)
        wi = torch.full_like(lens, start)
        scratch = cs.chunk_scratch(tcfg, pcfg, dev, b, cap)
        labels = cs.phase_labels(tcfg, pcfg, n_frames)
        key = f"chunk_b{b}"
        res[key] = times(lambda clocks=None: cs.gen_chunk_fused(
            tcfg, pcfg, tw, pw4, ex, lg, hd, *kv, lens, wi, cos, sin,
            zeros, greedy, pcap, scratch=scratch, clocks=clocks), labels)
        res[key].update(grid=list(cs.gen_chunk_fused.grid), start=start)
        if has_marks and b > 1:           # the batched body's marks
            res[key]["split_us"] = split_marks(
                lambda clocks, marks: cs.gen_chunk_fused(
                    tcfg, pcfg, tw, pw4, ex, lg, hd, *kv, lens, wi, cos,
                    sin, zeros, greedy, pcap, scratch=scratch,
                    clocks=clocks, marks=marks), labels)
        # the step schedule: four frames of one predictor frame and one
        # talker step, cursors start .. start + 3
        h = torch.randn(b, pcfg.d_model, generator=g, device=dev)
        c0 = ((torch.arange(b, device=dev) * 977 + 5) % 2048).to(torch.int32)
        x = (torch.randn(b, tcfg.d_model, generator=g, device=dev) * 0.5
             ).to(torch.bfloat16)
        steps = [(cos[f].contiguous(), sin[f].contiguous(),
                  torch.full_like(lens, start + f)) for f in range(n_frames)]

        def schedule():
            for cf, sf, wf in steps:
                tpf.predict_frame_fused(pcfg, pw, h, c0, tables)
                tts.talker_step_fused(tcfg, tw, x, cf, sf, *kv, lens, wf,
                                      pcap, uniform_cursor=True)
        res[f"step4_b{b}"] = times(schedule)
        res[f"step4_b{b}"]["start"] = start
        del kv, scratch


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
        pp = init_predictor_params(cfg.predictor, g)
        pw = tpf.prep_predictor_weights(cfg.predictor, pp)
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
    tcfg = cfg.talker
    with torch.no_grad():
        tp = talker_lib.init_talker_params(tcfg, g)
        tw = tts.prep_layer_weights(tcfg, tp)
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
    chunk_cases(res, cfg, g, tp, pp, tw, pw, tables)
    res["seconds"] = round(time.perf_counter() - t0, 1)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
