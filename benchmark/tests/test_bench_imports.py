"""What a run loads: never JAX or the JAX package; and the reference
loads nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LOAD_EVERY_CELL = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.run as run
from benchmark.lib import spec
bench = json.load(open({root!r} + "/BENCHMARK.json"))
for w in bench["workloads"]:
    cell = spec.load({root!r}, w["name"])
    for kind in ("traffic", "entries", "reference"):
        cell.module(kind)
import benchmark.control
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCES = """
import json, sys, os
sys.path.insert(0, {root!r})
from benchmark.lib import spec
for f in sorted(os.listdir({root!r} + "/benchmark/reference")):
    if f.endswith(".py") and f != "__init__.py":
        spec.load_module({root!r}, "reference", f[:-3])
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""


def _top_level_names(code: str) -> set:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    names = _top_level_names(LOAD_EVERY_CELL)
    # compared whole: the port's name begins with the JAX package's
    assert "jepsen_etcd_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "jepsen_etcd_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_names(LOAD_REFERENCES)
    assert not names & {"jax", "jaxlib", "flax", "jepsen_etcd_tpu",
                        "jepsen_etcd_tpu_torch", "torch"}


def test_the_runs_own_check_names_what_it_found(monkeypatch):
    from benchmark import run
    assert "jepsen_etcd_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jepsen_etcd_tpu.ops", object())
    assert "jepsen_etcd_tpu" in run.forbidden_modules()


RUN_ON_CPU = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.lib import spec
cell = spec.load({root!r}, "register_4n_2000.faulted")
cell.spec["params"].update(ops_per_key=300, pool={{"clean": 12,
    "corrupt": 2, "faulted": 2}})
out = run.run_cell(cell, 5, 0.5, True, device="cpu",
                   t_start=time.monotonic())
assert out["correct"], out
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""


def test_a_run_through_the_check_path_loads_no_jax():
    """What the check path loads lazily counts too: a short run on the
    CPU, then the same look at ``sys.modules``."""
    names = _top_level_names(RUN_ON_CPU)
    assert {"torch", "jepsen_etcd_tpu_torch"} <= names
    assert not names & {"jax", "jaxlib", "flax", "jepsen_etcd_tpu"}
