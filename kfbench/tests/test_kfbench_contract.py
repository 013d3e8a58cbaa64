"""BENCHMARK.json against the benchmark's contract, and the discovery of
each cell's configuration, mix, limits and metric readers by name."""

import json
import re

import pytest

from conftest import ROOT
from kfbench import check, run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|resolution|input_size|"
                    r"pyramid|camera|compute_size")


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kfbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "kfbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert line_ok(e[key]), (e["name"], key)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert line_ok(conf["why"]) and line_ok(conf["source"])
    assert conf["file"].startswith("kfbench/configs/")
    setting = json.loads((ROOT / conf["file"]).read_text())
    assert setting["name"] == conf["name"]
    assert sorted(conf["reduced"]) == sorted(setting["reduced"])
    assert len(conf["reduced"]) <= 16
    for key in conf["reduced"]:
        assert NAME.match(key) and not WIDTHS.search(key), key
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_are_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] == 1 and line_ok(cell["why"])
    found = run.find_cell(cell["name"])
    assert set(found["limits"]) == set(check.NUMBERS)
    e2e = {m["name"] for m in found["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert found["per_layer"]
    for m in found["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    assert set(metric) - {"workloads"} == keys
    assert callable(run.reader(metric["name"]))


def test_readers_read_nothing_where_nothing_was_measured():
    ctx = {"setup_s": 1.5, "frames": 10, "window_s": 2.0, "joules": None,
           "latencies_s": [], "host_ms": [], "captures": []}
    got = {m["name"]: run.reader(m["name"])(ctx)
           for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert got.pop("setup_s") == 1.5 and got.pop("frames_per_s") == 5.0
    assert all(v is None for v in got.values()), got


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        run.find_cell("no_such.cell")
