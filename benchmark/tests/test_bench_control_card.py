"""On the card: each cell at its own size, the program within its limits
and the control (the reference with fp8 activations in the program's
place, read on the same requests) beyond at least one of them.  Skips
where no CUDA card is present.

    python3 -m pytest benchmark/tests/test_bench_control_card.py -m cuda
"""

import json
import subprocess
import sys

import pytest

from tiny import BENCH, ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); none here")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell, "--seed",
         "2147490001", "--seconds", "10", "--trace", "0", "--control", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert any(res["control"][k] > c["limit"]
               for k, c in res["check"].items()), (res["control"],
                                                    res["check"])
