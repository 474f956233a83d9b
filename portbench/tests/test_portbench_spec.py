"""BENCHMARK.json against the contract's characters and keys, and every
cell's files found by name."""

import json
import re

import pytest

from portbench import harness
from portbench.spec import HERE, load_cell

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["portbench"]
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert (ROOT / BENCH["command"][1]).is_file()


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    reported = {m["name"]: set(m.get("workloads", CELLS)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert _line(m["layer"]) and m["moves"] != "setup_s"
        # every cell the metric lists reports the end-to-end metric it moves
        assert set(m["workloads"]) <= reported[m["moves"]]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert json.loads((HERE / "workloads" / f"{cell}.json").read_text()) == entry
    c = load_cell(cell)
    config = next(x for x in BENCH["configs"] if x["name"] == entry["config"])
    assert (ROOT / config["file"]).resolve() == HERE / "configs" / f"{entry['config']}.json"
    assert set(config["reduced"]) == set(c.config["reduced"])
    assert c.config["source"] == config["source"]
    assert c.chips == entry["chips"]
    assert c.jobs()
    layer = harness.metrics_for(c, trace=True)
    e2e = {m["name"] for m in harness.metrics_for(c, trace=False)}
    assert layer and "setup_s" in e2e and len(e2e) >= 2
    for m in layer:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert harness.read_layer(m["name"], {}) is None
