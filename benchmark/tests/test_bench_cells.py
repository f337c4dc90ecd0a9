"""Whole runs of tiny cells on the CPU (the port's exact path): correct
against the reference; not correct with a served code altered where it is
produced; a configuration, a traffic mix, a client kind and a per-layer
metric added as files only; open arrivals; lanes the benchmark cannot
map stop the run; nothing of JAX imported."""

import json
import subprocess
import sys
import time

import pytest
import torch

import tiny
from harness import runner

SEED = 2**31 + 4242


def run(root, cell, traced=False, **kw):
    return runner.execute(root, cell, SEED, 1.5, traced, time.perf_counter(),
                          device="cpu", bench_dir=root / "benchmark", **kw)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny.online", "tiny.stream"])
def test_tiny_cell_is_correct(root, cell, tmp_path):
    out = run(root, cell, dump=tmp_path / "dump.json")
    assert out["correct"], out["check"]
    dump = json.loads((tmp_path / "dump.json").read_text())
    assert sum(r["checked"] for r in dump["requests"]) == 2
    assert all(r["done"] is None or r["done"] >= r["submit"]
               for r in dump["requests"])
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {"tiny.online": {"frames_per_s", "latency_p95_ms", "setup_s"},
            "tiny.stream": {"ttfa_p90_ms", "chunk_gap_p95_ms", "setup_s"}}
    assert set(out["metrics"]) == want[cell]
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("cell", ["tiny.online", "tiny.stream"])
def test_altered_code_is_not_correct(root, cell, monkeypatch):
    from qwen3_tts_tpu_torch.runtime import generate

    real = generate.gen_frames

    def altered(*args, **kwargs):
        state, codes, valid = real(*args, **kwargs)
        codes = codes.clone()
        codes[:, :, 5] = (codes[:, :, 5] + 1) % 2048
        return state, codes, valid

    monkeypatch.setattr(generate, "gen_frames", altered)
    out = run(root, cell)
    assert not out["correct"]
    assert out["check"]["gap_residual"]["value"] > \
        out["check"]["gap_residual"]["limit"]


DUMMY_CLIENT = """
from pathlib import Path
import time

from harness import runner

_online = runner.client_kind("online", Path(__file__).resolve().parent.parent)
ROUND = _online.ROUND


class Client(_online.Client):
    def drive(self, t_end, tick=lambda: float("inf")):
        t0 = time.perf_counter()
        super().drive(t_end, tick)
        self.probe.spans.append(("dummy.drive", t0, time.perf_counter(), {}))
"""


def test_added_files_make_a_cell(root, tmp_path):
    """A configuration, a traffic mix, a client kind and a per-layer
    metric, each a new file plus BENCHMARK.json entries: nothing else
    changes."""
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    cfg["name"] = "tiny2"
    (bench / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "online_tiny.json").read_text())
    mix.update(speech_s=[0.32, 0.64], batch_size=2, client="dummy",
               arrivals={"law": "closed", "clients": 2})
    (bench / "traffic" / "online_short.json").write_text(json.dumps(mix))
    (bench / "clients" / "dummy.py").write_text(DUMMY_CLIENT)
    (bench / "checks" / "tiny2.short.json").write_text(
        json.dumps(tiny.LIMITS))
    (bench / "metrics" / "dummy_drives.online.py").write_text(
        "def read(run):\n"
        "    return float(len(run.spans_named('dummy.drive', 0.0, 1e30)))\n")
    bj = json.loads((root / "BENCHMARK.json").read_text())
    bj["configs"].append({"name": "tiny2", "source": "tests",
                          "file": "benchmark/configs/tiny2.json",
                          "reduced": [], "why": "tests"})
    bj["workloads"].append({"name": "tiny2.short", "config": "tiny2",
                            "traffic": "online_short", "chips": 1,
                            "why": "tests"})
    bj["per_layer"].append({"name": "dummy_drives.online", "unit": "calls",
                            "better": "higher", "source": "program_span",
                            "layer": "serve", "moves": "frames_per_s",
                            "workloads": ["tiny2.short"]})
    for m in bj["end_to_end"]:
        if "frames_per_s" == m["name"] or "latency_p95_ms" == m["name"]:
            m["workloads"].append("tiny2.short")
    (root / "BENCHMARK.json").write_text(json.dumps(bj))
    out = run(root, "tiny2.short", traced=True)
    assert out["correct"], out["check"]
    # the warm-in's drive and the window's
    assert out["metrics"]["dummy_drives.online"]["value"] == 2.0
    assert "lane_occupancy.online" not in out["metrics"]


def test_open_arrivals_are_timed_from_when_due(root):
    """A Poisson mix through the same client kind: every request's latency
    counts from when it was due, and the run is correct."""
    bench = root / "benchmark"
    mix = json.loads((bench / "traffic" / "online_tiny.json").read_text())
    mix["arrivals"] = {"law": "poisson", "rate_per_s": 6.0}
    (bench / "traffic" / "online_open.json").write_text(json.dumps(mix))
    (bench / "checks" / "tiny.open.json").write_text(json.dumps(tiny.LIMITS))
    bj = json.loads((root / "BENCHMARK.json").read_text())
    bj["workloads"].append({"name": "tiny.open", "config": "tiny",
                            "traffic": "online_open", "chips": 1,
                            "why": "tests"})
    for m in bj["end_to_end"]:
        if m["name"] in ("frames_per_s", "latency_p95_ms"):
            m["workloads"].append("tiny.open")
    (root / "BENCHMARK.json").write_text(json.dumps(bj))
    out = run(root, "tiny.open")
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_lanes_out_of_order_stop_the_run():
    """A prefill that does not take the prompts queued since the last one,
    in order and at their lengths, is a fault of the benchmark's view, not
    a verdict on the program."""
    from harness.probe import Probe
    from harness.traffic import Request
    online = runner.client_kind("online")
    client = online.Client.__new__(online.Client)
    client.probe = Probe()
    from collections import deque
    a = Request(0, "abc", "vivian", None, 8, False, 15)
    b = Request(1, "abcdef", "vivian", None, 8, False, 18)
    client.pending = deque([a, b])
    assert client._take(2, [15, 18]) == [a, b]
    assert client.probe.fault is None
    client.pending = deque([a, b])
    client._take(2, [18, 15])
    assert "cannot tell which lane" in client.probe.fault
    client.probe = Probe()
    client.pending = deque([a, b])
    client._take(1, [15])
    assert client.probe.fault is not None


def test_nothing_imports_jax():
    """Every module the benchmark's process loads: the harness, each
    metric reader, the reference and the port's serving path; compared by
    whole top-level names (qwen3_tts_tpu_torch starts with
    qwen3_tts_tpu)."""
    code = (
        "import sys; sys.path[:0] = %r\n"
        "from harness import runner\n"
        "from pathlib import Path\n"
        "for p in sorted((runner.BENCH / 'metrics').glob('*.py')):\n"
        "    runner.reader(p.stem)\n"
        "for p in sorted((runner.BENCH / 'clients').glob('*.py')):\n"
        "    runner.client_kind(p.stem)\n"
        "import qwen3_tts_tpu_torch.serve.online\n"
        "import qwen3_tts_tpu_torch.serve.codec_path\n"
        "from qwen3_tts_tpu_torch import TtsEngine\n"
        "assert 'qwen3_tts_tpu_torch' in sys.modules\n"
        "print(runner.forbidden_modules())\n"
        % [str(tiny.BENCH), str(tiny.ROOT)])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "qwen3_tts_tpu_torch_extra", sys)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "qwen3_tts_tpu.engine", sys)
    assert runner.forbidden_modules() == ["qwen3_tts_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert runner.forbidden_modules() == ["jaxlib", "qwen3_tts_tpu"]
