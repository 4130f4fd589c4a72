"""BENCHMARK.json against the benchmark's contract, and every entry found
by name: each cell's configuration, mix and limits files, each per-layer
metric's reader with the declarations its entry makes."""
import importlib.util
import json
import re

import pytest

from ragbench.cell import HERE, ROOT, load_cell, manifest

MAN = manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
PER_LAYER = [m["name"] for m in MAN["per_layer"]]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["ragbench"]
    assert MAN["command"] == ["python3", "ragbench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    # the check's whole time with the full 24 cells
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_entries_follow_the_contract(kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[kind]
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k], (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        if kind == "end_to_end":
            assert 0.01 <= e["bound"] <= 0.25
            assert e["source"] in ("host_clock", "device_trace")
        if kind == "per_layer":
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        if kind == "workloads":
            assert e["chips"] in (1, 4)
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        c = load_cell(cell)
        mine = c.metric_names(False)
        assert "setup_s" in mine and len(mine) >= 2, cell
        assert c.metric_names(True), cell
        for m in MAN["per_layer"]:
            if cell in m.get("workloads", [cell]):
                assert m["moves"] in mine, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = load_cell(cell)
    conf = next(x for x in MAN["configs"] if x["name"] == c.config_name)
    assert conf["file"].startswith("ragbench/")
    assert (ROOT / conf["file"]).is_file()
    assert c.cfg["source"] == conf["source"]
    for key in conf["reduced"]:
        assert key in c.cfg and key in c.cfg["reduced"], key
    assert c.mix["loop"] == "closed" and c.cfg["db"]["index_type"] in (
        "ivf", "flat")
    assert c.limits, cell
    for name, lim in c.limits.items():
        assert "limit" in lim, (cell, name)


@pytest.mark.parametrize("name", PER_LAYER)
def test_per_layer_reader_declares_its_entry(name):
    entry = next(m for m in MAN["per_layer"] if m["name"] == name)
    mod = reader(name)
    assert mod.LAYER == entry["layer"]
    assert mod.UNIT == entry["unit"]
    assert mod.SOURCE == entry["source"]
    assert mod.MOVES == entry["moves"]
    assert list(mod.WORKLOADS) == entry.get("workloads", CELLS)
    assert set(mod.WORKLOADS) <= set(CELLS)
    assert callable(mod.read)


def test_roofline_shares_are_named_for_their_kernels():
    for m in MAN["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
    step = {m["moves"] for m in MAN["per_layer"] if "mfu" in m["name"]}
    rooflines = {m["moves"] for m in MAN["per_layer"]
                 if m["name"].endswith("_roofline")}
    assert rooflines <= step
