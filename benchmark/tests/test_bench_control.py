"""The control at a size a test run can hold: the cells' weight formats
on the port's fused decode paths (their plain versions, on the CPU) at
small_model() widths.  Read on the same requests, the control (fp8
activations) lies beyond the cell's limits on at least one number, and
above the program on every number."""

import json
import time

import pytest
import torch

import tiny
from harness import runner

CASES = [("w4a8", "tiny.online", "qwen3-tts-1.7b-w4a8.online-b32"),
         ("w4a8", "tiny.stream", "qwen3-tts-1.7b-w4a8.stream-b1"),
         ("q8_0", "tiny.online", "qwen3-tts-1.7b-q8_0.online-b32")]


@pytest.mark.parametrize("config,cell,real", CASES)
def test_control_fails_the_limits(tmp_path, config, cell, real):
    torch.set_num_threads(2)
    root = tiny.make_root(tmp_path)
    (root / "benchmark" / "configs" / "tiny.json").write_text(
        json.dumps(tiny.small_config(config)))
    limits = json.loads((tiny.BENCH / "checks" / f"{real}.json").read_text())
    out = runner.execute(root, cell, 2**31 + 77, 10.0, False,
                         time.perf_counter(), device="cpu", control=True,
                         limits=limits, bench_dir=root / "benchmark")
    assert out["sampled_frames"], "no request finished in the window"
    got = {k: v["value"] for k, v in out["check"].items()}
    ctl = out["control"]
    assert any(ctl[k] > limits[k]["limit"] for k in got), (ctl, limits)
    assert ctl["audio_err"] > got["audio_err"]
    assert ctl["gap_residual"] > got["gap_residual"]
