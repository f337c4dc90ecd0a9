"""One run of one cell: set-up, the measured window, the correctness check,
the metrics.  Everything a cell needs is found by name from BENCHMARK.json:
its configuration file, its traffic mix (benchmark/traffic/<mix>.json),
the kind of client the mix names (benchmark/clients/<kind>.py: `Client`,
and `ROUND`, the span name of one decode call), its limits
(benchmark/checks/<workload>.json) and a reader per metric
(benchmark/metrics/<metric>.py, `read(run) -> float | None`).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import check, trace, traffic
from .probe import Probe
from . import weights as weights_mod

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_tts_tpu")


@dataclass
class Run:
    """What a metric reader reads."""
    workload: Dict
    config: Dict
    mix: Dict
    seconds: float
    t0: float                                    # window, host clock
    t1: float
    spans: List[tuple]
    requests: List[Any]                          # finished (any time)
    round: str = ""                              # span of a decode call
    stretch: Optional[trace.Stretch] = None
    extra: Dict = field(default_factory=dict)

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t0 <= t <= self.t1

    def spans_named(self, name: str, t0=None, t1=None):
        a = self.t0 if t0 is None else t0
        b = self.t1 if t1 is None else t1
        return [s for s in self.spans if s[0] == name and a <= s[2] <= b]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench_dir: Path = BENCH):
    return _module(bench_dir / "metrics" / f"{name}.py",
                   f"bench_metric_{name}").read


def client_kind(name: str, bench_dir: Path = BENCH):
    """The module of a mix's client kind: Client(engine, mix, pool, seed,
    probe) with start(warm_in_s), drive(t_end, tick) (tick() returns when
    it wants to be called next), stop(), finish(), done; and ROUND."""
    return _module(bench_dir / "clients" / f"{name}.py",
                   f"bench_client_{name}")


def cell_metrics(bench: Dict, workload: str, kind: str) -> List[Dict]:
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def speakers(root: Path, names) -> Dict[str, np.ndarray]:
    return {n: np.asarray(load_json(root / "speakers" / f"{n}.json")
                          ["spk_emb"], np.float32) for n in names}


def engine_config(config: Dict):
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    m = config["model"]
    return EngineConfig.from_dict({k: m[k] for k in
                                   ("talker", "predictor", "codec_decoder")})


def build_engine(root: Path, config: Dict, seed: int, device):
    """TtsEngine(weights=...) on the benchmark's weights."""
    from qwen3_tts_tpu_torch import TtsEngine
    from qwen3_tts_tpu_torch.io.assets import Assets
    raw = weights_mod.make(config, seed, device)
    t, p, a = raw["talker"], raw["predictor"], raw["assets"]
    dt = weights_mod._dtype(config["model"]["dtype"])
    weights = {
        "assets": Assets.from_arrays(a["proj_w"], a["proj_b"], a["text"],
                                     a["codec"], dtype=dt, device=device),
        "talker": {"layers": t["layers"], "final_norm": t["final_norm"],
                   "codec_head": t["head"]},
        "predictor": {"layers": p["layers"], "final_norm": p["final_norm"],
                      "lm_head": p["head"]},
        "codec_decoder": raw["codec"],
    }
    del raw
    eng = TtsEngine(model_dir=root / "benchmark" / "no_model_files",
                    config=engine_config(config), weights=weights,
                    device=device, speakers_dir=root / "speakers",
                    weight_cache=False, **config["engine"])
    del weights
    return eng


TRACE_TRIES = 3      # stretches a traced window takes at most


def window(client, mix: Dict, seconds: float, tracer) -> tuple:
    """Run the window; returns (t0, t1).  The traced stretch opens at
    mix["trace_at"] of the window and lasts mix["trace_s"] seconds, as
    near as the client's ticks come.  A stretch in which the profiler
    recorded no kernel is taken again at once, up to TRACE_TRIES in all,
    while a whole stretch still fits before the window closes."""
    t0 = time.perf_counter()
    t1 = t0 + seconds
    state = {"at": t0 + mix["trace_at"] * seconds, "on": None,
             "done": tracer is None}

    def tick() -> float:
        """Start or stop the tracer when due; returns when it is next
        due (inf: never)."""
        now = time.perf_counter()
        if state["done"]:
            return math.inf
        if state["on"] is None:
            if now < state["at"]:
                return state["at"]
            tracer.start()
            state["on"] = now
        if now < state["on"] + mix["trace_s"]:
            return state["on"] + mix["trace_s"]
        tracer.stop()
        n = tracer.kernels()
        now = time.perf_counter()
        late = now - state["on"] - mix["trace_s"]
        print(f"trace: stretch {tracer.tries} recorded {n} kernels "
              f"(stopped and counted in {late:.3f} s)", file=sys.stderr)
        if n == 0:
            again = (tracer.tries < TRACE_TRIES
                     and now + 1.5 * mix["trace_s"] < t1)
            print(f"trace: stretch {tracer.tries} recorded no kernel; "
                  + ("tracing again" if again else "no time or tries left"),
                  file=sys.stderr)
            if again:
                state["at"], state["on"] = now, None
                return now
        state["done"] = True
        return math.inf

    client.drive(t1, tick)
    if state["on"] is not None and not state["done"]:
        tracer.stop()
    return t0, min(time.perf_counter(), t1)


def execute(root: Path, workload: str, seed: int, seconds: float,
            traced: bool, t_start: float, device="cuda",
            control: bool = False, limits: Optional[Dict] = None,
            bench_dir: Path = BENCH, dump: Optional[Path] = None) -> Dict:
    """One run of `workload` (module docstring).  root: the checkout
    (BENCHMARK.json, the configuration files, speakers/); bench_dir: where
    the traffic mixes, checks and metric readers are found."""
    bench = load_json(root / "BENCHMARK.json")
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(root / cfg_entry["file"])
    mix = load_json(bench_dir / "traffic" / f"{wl['traffic']}.json")
    if limits is None:
        path = bench_dir / "checks" / f"{workload}.json"
        limits = load_json(path) if path.exists() else None
    device = torch.device(device)

    t_before = time.perf_counter()
    eng = build_engine(root, config, seed, device)
    t_eng = time.perf_counter() - t_before
    pool = traffic.pool(mix, seed)
    probe = Probe()
    client_mod = client_kind(mix["client"], bench_dir)
    client = client_mod.Client(eng, mix, pool, seed, probe)
    tracer = None
    if traced and device.type == "cuda":
        trace.warm()
        tracer = trace.Tracer(getattr(eng, "device_lock", None))
    try:
        t_drv = time.perf_counter()
        client.start(mix["warm_in_s"])
        t_drv = time.perf_counter() - t_drv
        print(f"setup: imports and CUDA start {t_before - t_start:.3f} s; "
              f"weights and engine {t_eng:.3f} s (engine parts "
              f"{ {k: round(v, 3) for k, v in eng.load_seconds.items()} }); "
              f"warm-up and warm-in {t_drv:.3f} s", file=sys.stderr)
        t0, t1 = window(client, mix, seconds, tracer)
    finally:
        client.stop()
    client.finish()
    if probe.fault:
        raise RuntimeError(f"the benchmark's view of the program broke: "
                           f"{probe.fault}")
    setup_s = t0 - t_start
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        mem = int(torch.cuda.max_memory_allocated(device))
    else:
        mem = 0
    run = Run(workload=wl, config=config, mix=mix, seconds=t1 - t0, t0=t0,
              t1=t1, spans=list(probe.spans), requests=list(client.done),
              round=client_mod.ROUND)
    run.extra["batch"] = int(mix.get("batch_size", 1))
    run.extra["started"] = list(getattr(client, "started", run.requests))
    if tracer:
        run.stretch = st = tracer.read()
        print(f"trace: stretch {tracer.tries}: {len(st.kernels)} kernels, "
              f"{len(st.device_ops) - len(st.kernels)} copies and sets, "
              f"busy {st.busy_s:.4f} s of {st.t1 - st.t0:.4f} s",
              file=sys.stderr)
        del tracer
    del client, eng, probe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    window_done = [r for r in run.requests if run.in_window(r.t_done)]
    failed = sum(r.error is not None for r in window_done)
    picked = check.sample(window_done, int(mix["check_requests"]), seed)
    spk = speakers(root, mix["speakers"])
    got, low = check.readings(config, seed, picked, spk,
                              int(mix["sampler"]["top_k"]),
                              run.extra["batch"], device, control)
    if limits is not None:
        ok, compared = check.judge(got, limits)
        ok = ok and bool(picked) and failed == 0
    else:
        ok, compared = False, {k: {"value": v, "limit": None}
                               for k, v in got.items()}

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, workload, kind):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = reader(m["name"], bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(ok), "attempted": len(window_done),
           "failed": failed, "metrics": metrics,
           "device": device_info(device, run, mem)}
    if traced and run.stretch is not None:
        out["breakdown"] = trace.breakdown(run.stretch, run.spans)
    if control:
        out["control"] = low
        out["sampled_frames"] = [int(len(r.codes)) for r in picked]
    out["check"] = compared
    if dump is not None:
        write_dump(dump, run, picked)
    return out


def write_dump(path: Path, run: Run, picked) -> None:
    """Every request of the run, on the window's clock (seconds from its
    start), for studying a cell's spread; no benchmark run writes it."""
    def rel(t):
        return None if t is None else t - run.t0
    rows = [{"index": r.index, "rows": r.rows, "frames": r.frames,
             "speaker": r.speaker, "instruct": r.instruct is not None,
             "greedy": r.greedy, "submit": rel(r.t_submit),
             "first": rel(r.t_first), "done": rel(r.t_done),
             "gaps": [b - a for a, b in r.gaps], "prefill_ms": r.prefill_ms,
             "served": r.served_frames,
             "error": r.error, "checked": any(r is p for p in picked)}
            for r in run.extra["started"]]
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"seconds": run.seconds, "requests": rows}, f)


def device_info(device, run: Run, mem: int) -> Dict:
    """mem: the peak read when the window closed, before the reference."""
    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": mem}
    if run.stretch is not None:
        info["busy_s"] = run.stretch.busy_s
        info["window_s"] = run.stretch.t1 - run.stretch.t0
    return info


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))
