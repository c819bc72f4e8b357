"""The harness finds a new configuration, cell and metric by name: a
later change adds files and entries and edits none."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.lib import spec
from benchmark.lib.context import Context

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tree_digest(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_digest(root)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "register_3n_500.json"), "w") as fh:
        json.dump({"name": "register_3n_500", "workload": "register",
                   "nodes": 3, "concurrency": 6, "readers": 3,
                   "writers": 3, "values": 5, "ops_per_key": 500,
                   "reduced": []}, fh)
    with open(os.path.join(b, "cells", "register_3n_500.tiny.json"),
              "w") as fh:
        json.dump({"generator": "register_pool", "entry": "register",
                   "reference": "register",
                   "params": {"keys_per_history": [2, 3],
                              "pool": {"clean": 4}}}, fh)
    with open(os.path.join(b, "metrics", "keys_per_history.py"), "w") as fh:
        fh.write("def read(ctx):\n"
                 "    return sum(len(h.keys) for h in ctx.histories)"
                 " / len(ctx.histories)\n")
    bench["configs"].append({"name": "register_3n_500",
                             "file": "benchmark/configs/register_3n_500.json"})
    bench["workloads"].append({"name": "register_3n_500.tiny",
                               "config": "register_3n_500",
                               "traffic": "tiny", "chips": 1})
    bench["per_layer"].append({"name": "keys_per_history", "unit": "keys",
                               "workloads": ["register_3n_500.tiny"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)

    cell = spec.load(root, "register_3n_500.tiny")
    assert cell.config["nodes"] == 3
    assert cell.config["ops_per_key"] == 500
    names = [m["name"] for m, _ in cell.per_layer]
    assert "keys_per_history" in names
    assert "ladder_ms_per_op" not in names   # listed for other cells
    assert "device_idle_share" in names        # listed for every cell
    traffic = cell.traffic(7)
    hs = [traffic.history(i) for i in range(3)]
    assert sorted(len(h) for h in hs[:2]) == [2, 3]
    reader = dict((m["name"], r) for m, r in cell.per_layer)
    ctx = Context(1.0, 1.0, [type("H", (), {"keys": h})() for h in hs])
    assert reader["keys_per_history"].read(ctx) == sum(map(len, hs)) / 3
    # every file that was there is as it was
    after = _tree_digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    # the cells of the benchmark load as before
    for w in bench["workloads"]:
        spec.load(root, w["name"])
