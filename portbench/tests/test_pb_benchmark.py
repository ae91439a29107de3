"""BENCHMARK.json and the files it names, against the benchmark's contract."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_one_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w.split("/") for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.endswith("_torch")
        assert (ROOT / p).is_dir()
        assert not p.startswith(("crispy_tpu", "tests", "tools"))


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"]) and _one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _one_line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_setup_a_rate_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        reported = {n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])}
        assert len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in BENCH["per_layer"])


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)


def test_rooflines_and_mfu_named_as_the_contract_asks():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    moved_by_roofline = {m["moves"] for m in BENCH["per_layer"] if m["name"].endswith("_roofline")}
    mfu_moves = {m["moves"] for m in BENCH["per_layer"] if "mfu" in m["name"]}
    assert moved_by_roofline <= mfu_moves


def test_files_that_the_cells_name():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
    for w in BENCH["workloads"]:
        traffic = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "drivers" / f"{traffic['driver']}.py").is_file()
        assert traffic["rate_metric"] in {m["name"] for m in BENCH["end_to_end"]}
        assert all(v is not None for v in traffic["check"]["limits"].values())
        assert traffic["check"]["limits"]
    from portbench.cells import metric_path

    for m in BENCH["per_layer"]:
        assert metric_path(m["name"]).is_file(), m["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_load_cell(cell):
    from portbench.cells import load_cell, metric_reader

    c = load_cell(cell)
    assert c.chips == 1 and c.per_layer and c.end_to_end
    for m in c.per_layer:
        assert callable(metric_reader(m["name"]))
