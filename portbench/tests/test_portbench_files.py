"""BENCHMARK.json against the benchmark's contract: names and units by the
character rule, exactly the keys each entry may have, and every file that
a name leads to."""

import json
import re

from conftest import ROOT, bench
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51


def test_names_units_and_keys():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"} and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    assert [m["bound"] for m in b["end_to_end"] if m["name"] == "setup_s"] == [0.25]


def test_every_name_finds_its_files():
    b = bench()
    for c in b["configs"]:
        path = ROOT / c["file"]
        assert c["file"].startswith("portbench/") and path.is_file()
        cfg = json.loads(path.read_text())
        assert all(isinstance(cfg[k], int) for k in ("d", "m", "n", "logq", "p", "log_smudging",
                                                     "log_sigma"))
    for w in b["workloads"]:
        traffic = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "entries" / f"{traffic['entry']}.py").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert harness.metric_file(m["name"]).is_file(), m["name"]


def test_a_reader_is_found_by_its_whole_name_first(tmp_path):
    metrics = tmp_path / "portbench" / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "idle.py").write_text("")
    assert harness.metric_file("idle.prove", tmp_path) == metrics / "idle.py"
    (metrics / "idle.prove.py").write_text("")
    assert harness.metric_file("idle.prove", tmp_path) == metrics / "idle.prove.py"
    assert harness.metric_file("idle", tmp_path) == metrics / "idle.py"


def test_every_cell_reports_enough():
    """Each cell: setup_s, another end-to-end metric and a per-layer metric;
    each metric's cells exist; a per-layer metric's cells report what it moves."""
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    mine = lambda m, c: c in m.get("workloads", cells)
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for c in cells:
        e2e = [m["name"] for m in b["end_to_end"] if mine(m, c)]
        assert "setup_s" in e2e and len(e2e) >= 2, c
        layer = [m for m in b["per_layer"] if mine(m, c)]
        assert layer and all(m["moves"] in e2e for m in layer), c
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(cells) // 4)
