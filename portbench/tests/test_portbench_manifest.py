"""BENCHMARK.json against the benchmark's contract, and the files it names."""
import json
import os
import re

import pytest

from portbench import manifest

MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN).encode()) <= 64 * 1024
    for p in MAN["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/")
        assert ".." not in p.split("/")
    for word in MAN["command"]:
        assert LINE.match(word)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


def test_every_cell_reports_setup_another_metric_and_a_layer():
    pairs = set()
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(MAN, w, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(MAN, w, "per_layer")
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(MAN["workloads"])
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_layer_metric_cells_report_what_it_moves(metric):
    m = next(x for x in MAN["per_layer"] if x["name"] == metric)
    mover = next(x for x in MAN["end_to_end"] if x["name"] == m["moves"])
    cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
    for c in cells:
        assert "workloads" not in mover or c in mover["workloads"], (metric, c)
    layers = {x["layer"] for x in MAN["per_layer"]}
    assert m["layer"] in layers


def test_every_file_is_found_by_name():
    for c in MAN["configs"]:
        assert os.path.exists(os.path.join(manifest.ROOT, c["file"]))
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(manifest.HERE, "configs", c["name"] + ".py"))
        assert c["name"] in {w["config"] for w in MAN["workloads"]}
    for w in MAN["workloads"]:
        tr = manifest.load_traffic(w["traffic"])
        assert manifest.load_generator(tr["generator"]).Generator
        assert tr["limits"]
    for m in MAN["per_layer"]:
        assert os.path.exists(manifest.layer_path(m["name"]))


def test_command_names_only_files_under_paths():
    assert MAN["command"][:3] == ["python3", "-m", "portbench.run"]
    assert MAN["paths"] == ["portbench"]
