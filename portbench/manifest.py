"""BENCHMARK.json and the files it names. Everything that belongs to one
configuration, traffic mix or per-layer metric sits in a file of its own,
found by the name the manifest gives: configs/<config>.json and .py,
traffic/<traffic>.json (its "generator" names generators/<generator>.py), and
layers/<metric>.py."""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(path=None):
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(man, name):
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(man, cell, kind):
    """The metrics of `kind` ("end_to_end" or "per_layer") that `cell` reports."""
    return [m for m in man[kind] if "workloads" not in m or cell["name"] in m["workloads"]]


def load_traffic(name):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def load_generator(name):
    import importlib
    return importlib.import_module(f"portbench.generators.{name}")


def layer_path(metric):
    return os.path.join(HERE, "layers", metric + ".py")
