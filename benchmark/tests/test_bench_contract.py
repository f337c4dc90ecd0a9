"""BENCHMARK.json against the benchmark's own rules: names and units,
every metric's reader file, every cell's files, bounds, and the
per-layer metrics' cells reporting the end-to-end metric they move."""

import json
import re

from tiny import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_files_exist():
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for w in SPEC["workloads"]:
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (BENCH / "clients" / f"{mix['client']}.py").is_file()
        assert (BENCH / "checks" / f"{w['name']}.json").is_file()
        assert w["chips"] == 1
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        if m["name"] != "setup_s":
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = [w["name"] for w in SPEC["workloads"]]

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for cell in cells:
        assert any(reports(m, cell) for m in SPEC["per_layer"])
        assert any(reports(m, cell) for n, m in e2e.items()
                   if n != "setup_s")
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
