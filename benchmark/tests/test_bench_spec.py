"""Every entry of BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract."""
import json
import re

import pytest

from benchmark import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = harness.ROOT / cfg["file"]
    assert cfg["file"].startswith("benchmark/") and path.is_file()
    body = json.loads(path.read_text())
    assert body["name"] == cfg["name"]
    assert body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    assert set(body["limits"]) >= {"out_rel_max", "out_off_share",
                                   "water_error_gap_mm"}
    for k in cfg["reduced"]:
        assert NAME.match(k)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(cell):
    spec, entry, cfg, traffic = harness.cell_spec(cell["name"])
    assert entry["chips"] in (1, 4)
    assert traffic["n_cell"] > 0 and traffic["block_records"] > 0
    assert len(cell["why"]) <= 200
    reported = harness.cell_metrics(spec, entry, False)
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert harness.cell_metrics(spec, entry, True)


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_readers_resolve(metric):
    assert callable(harness.metric_reader(metric["name"]))
    assert metric["moves"] in [m["name"] for m in SPEC["end_to_end"]]
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
