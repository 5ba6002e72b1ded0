"""BENCHMARK.json keeps to its contract, and every cell finds its files
by name: a new cell or metric is data, found without an edit."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from bench_port import run as R

ROOT = R.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "layer", "moves",
               "workloads", "bound"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(map(line, b["command"]))
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fits_a_check_of_24_cells():
    b = bench()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [x["name"] for x in bench()[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("bench_port/") and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
    assert len({c["source"] for c in b["configs"]}) == len(b["configs"])


def test_workloads():
    b = bench()
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_metrics():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m) <= METRIC_KEYS
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert "layer" not in m and "moves" not in m
    for m in b["per_layer"]:
        assert "bound" not in m and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline_pct") or \
                m["name"].endswith("_roofline")
            assert m["unit"] == "%"
    # every cell reports setup_s, another end-to-end metric, a per-layer one
    for c in cells:
        mine = [m for m in b["end_to_end"] if c in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(c in m.get("workloads", cells) for m in b["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = R.load_cell(cell)
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(R.reader(ROOT, m["name"]))
    gen = os.path.join(ROOT, "bench_port", "corpora",
                       c["config"]["generator"] + ".py")
    assert os.path.exists(gen)
    assert set(c["traffic"]["expect"]) <= {"engine", "climb", "pwm",
                                           "hybrid_frac"}
    assert {"count_diff", "motif_mismatch", "pwm_err"} <= set(c["limits"])


def test_a_new_cell_and_metric_are_data(tmp_path):
    """A cell and a metric added as files and entries are picked up."""
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "bench_port"), root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "data"))
    b = bench()
    b["workloads"].append({"name": "extra.cell", "config": "mafk_1m",
                           "traffic": "extra_mix", "chips": 1, "why": "t"})
    b["per_layer"].append({"name": "jobs.count", "unit": "jobs",
                           "better": "higher", "source": "host_clock",
                           "layer": "cli", "moves": "job_s",
                           "workloads": ["extra.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "bench_port" / "traffic" / "extra_mix.json").write_text(
        json.dumps({"argv": ["-w", "8"], "expect": {}}))
    (root / "bench_port" / "limits" / "extra.cell.json").write_text(
        json.dumps({"count_diff": 0, "motif_mismatch": 0, "pwm_err": 1}))
    (root / "bench_port" / "metrics" / "jobs.count.py").write_text(
        "def read(rec):\n    return len(rec['jobs'])\n")
    c = R.load_cell("extra.cell", str(root))
    assert c["traffic"]["argv"] == ["-w", "8"]
    assert [m["name"] for m in c["per_layer"]][-1] == "jobs.count"
    assert R.reader(str(root), "jobs.count")({"jobs": [1, 2]}) == 2
    assert "jobs.count" not in [m["name"] for m in
                                R.load_cell("mafk_w10", str(root))["per_layer"]]
