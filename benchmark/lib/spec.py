"""Everything a run reads from data, found by name.

``BENCHMARK.json`` at the checkout's root names the cells and metrics.
A cell ``<config>.<traffic>`` reads ``benchmark/cells/<cell>.json``
(its traffic generator, the entry into the system, the reference and
their parameters) and ``benchmark/configs/<config>.json``; each metric
``m`` has a reader ``benchmark/metrics/<m>.py`` with ``read(ctx)``; a
generator, an entry and a reference are ``benchmark/traffic/<name>.py``,
``benchmark/entries/<name>.py`` and ``benchmark/reference/<name>.py``.
Adding a cell, a configuration or a metric adds files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

BENCH_DIR = "benchmark"


def _module_name(kind: str, name: str) -> str:
    return f"{BENCH_DIR}.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"


def load_module(root: str, kind: str, name: str):
    """``<root>/benchmark/<kind>/<name>.py`` as the module
    ``benchmark.<kind>.<name>`` (a name's ``.`` and ``-`` read as
    ``_``); relative imports inside it resolve in the benchmark's
    package."""
    mod_name = _module_name(kind, name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = os.path.join(root, BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One cell of ``BENCHMARK.json`` with its files: ``workload`` (the
    entry of ``workloads``), ``spec`` (``cells/<name>.json``),
    ``config`` (``configs/<config>.json``) and the metrics it reports,
    end to end and per layer, as ``(entry, reader)`` pairs."""

    def __init__(self, root: str, bench: dict, name: str):
        self.root = root
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = by_name[name]
        bdir = os.path.join(root, BENCH_DIR)
        self.spec = _read_json(os.path.join(bdir, "cells", name + ".json"))
        self.config = _read_json(os.path.join(
            bdir, "configs", self.workload["config"] + ".json"))
        self.chips = int(self.workload.get("chips", 1))

        def mine(metrics):
            return [m for m in metrics
                    if name in m.get("workloads", [name])]

        self.end_to_end = [(m, load_module(root, "metrics", m["name"]))
                           for m in mine(bench["end_to_end"])]
        self.per_layer = [(m, load_module(root, "metrics", m["name"]))
                          for m in mine(bench["per_layer"])]

    def module(self, kind: str):
        """The cell's ``traffic``, ``entries`` or ``reference`` module,
        named in its cell file under ``generator``, ``entry`` and
        ``reference``."""
        key = {"traffic": "generator", "entries": "entry",
               "reference": "reference"}[kind]
        return load_module(self.root, kind, self.spec[key])

    def traffic(self, seed: int):
        """The cell's traffic for ``seed``: its generator's ``make``
        over the configuration's keys with the cell's ``params`` over
        them."""
        return self.module("traffic").make(
            {**self.config, **self.spec["params"]}, seed)


def load(root: str, name: str) -> Cell:
    return Cell(root, _read_json(os.path.join(root, "BENCHMARK.json")),
                name)
