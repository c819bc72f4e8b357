"""The port's graftlint (``jepsen_etcd_tpu_torch/lint``) on the shapes of
``tests/test_lint.py``: per-family fixtures, the suppression and
baseline machinery, rule selection, the tree gate and the CLI. The
reference's JAX fixtures give way to a firing and a clean fixture for
each TORCH rule (``rules/torch_rules.py``). The families the two
packages share (DET, COL, THR, TEL) and the LINT000-LINT004 machinery
give the same findings (rule, line, column, message) as the
reference's linter on the same fixture files, and the reference's
linter finds the port's tree clean under those families too.

Fixture snippets lint under ``Policy(all_in_scope=True)`` — every file
columnar, every def entry-reachable, no wall-clock allowlist — so each
rule can fire on a bare tmp file without path gymnastics.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from jepsen_etcd_tpu import lint as ref_lint
from jepsen_etcd_tpu.lint import engine as ref_engine
from jepsen_etcd_tpu_torch.lint import Policy, run_lint
from jepsen_etcd_tpu_torch.lint import engine, policy
from jepsen_etcd_tpu_torch.lint.engine import write_baseline
from jepsen_etcd_tpu_torch.lint.rules import ALL_RULES, FAMILIES, select

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "jepsen_etcd_tpu_torch")

TEL_REGISTRY = {"spans": ("phase:*", "good.span"),
                "counters": ("a.b", "stream.*_reuse"),
                "events": ("boom",),
                "hists": ("good.hist", "lat.*")}


def lint_snippet(tmp_path, source, name="snippet.py", rules=None,
                 baseline_path=None, pkg=None):
    f = tmp_path / name
    f.write_text(source)
    mod = pkg or sys.modules[__name__]
    return mod.run_lint(paths=[str(f)], rules=rules,
                        baseline_path=baseline_path,
                        policy=mod.Policy(all_in_scope=True,
                                          tel_registry=TEL_REGISTRY),
                        root=str(tmp_path))


def rules_fired(report):
    return {f.rule for f in report.findings if not f.suppressed}


def count(report, rule):
    return sum(f.rule == rule and not f.suppressed
               for f in report.findings)


# -- DET ---------------------------------------------------------------------

DET001_FIRE = ("import time\n"
               "def stamp():\n"
               "    return time.time()\n")
DET001_CLEAN = ("def stamp(loop):\n"
                "    return loop.now()\n")
DET002_FIRE = ("import random\n"
               "def draw():\n"
               "    return random.random()\n")
DET002_CLEAN = ("import random\n"
                "def draw(seed):\n"
                "    return random.Random(seed).random()\n")
DET003_FIRE = ("def order(xs, y):\n"
               "    out = list(set(xs))\n"
               "    for v in set(xs) | {1}:\n"
               "        out.append(v)\n"
               "    return out, id(y)\n")
DET003_CLEAN = ("def order(xs):\n"
                "    return sorted(set(xs))\n")


def test_det001_wall_clock_fires(tmp_path):
    assert "DET001" in rules_fired(lint_snippet(tmp_path, DET001_FIRE))


def test_det001_virtual_clock_clean(tmp_path):
    assert "DET001" not in rules_fired(lint_snippet(tmp_path, DET001_CLEAN))


def test_det002_unseeded_random_fires(tmp_path):
    assert "DET002" in rules_fired(lint_snippet(tmp_path, DET002_FIRE))


def test_det002_seeded_instance_clean(tmp_path):
    assert "DET002" not in rules_fired(lint_snippet(tmp_path, DET002_CLEAN))


def test_det003_set_iteration_and_id(tmp_path):
    assert count(lint_snippet(tmp_path, DET003_FIRE), "DET003") == 3


def test_det003_sorted_set_clean(tmp_path):
    assert "DET003" not in rules_fired(lint_snippet(tmp_path, DET003_CLEAN))


# -- COL ---------------------------------------------------------------------

COL001_FIRE = ("def rows(h):\n"
               "    return [op for op in h.ops] + h.to_ops()\n")
COL002_FIRE = ("def bands(h):\n"
               "    return [h.completion(op) for op in h.nemesis_ops()]\n")
COL_CLEAN = ("def rows(cols):\n"
             "    return cols.client_pairs(), cols.time.tolist()\n")


def test_col001_ops_materialization_fires(tmp_path):
    assert count(lint_snippet(tmp_path, COL001_FIRE), "COL001") == 2


def test_col002_dict_api_fires(tmp_path):
    assert count(lint_snippet(tmp_path, COL002_FIRE), "COL002") == 2


def test_col_columnar_accessors_clean(tmp_path):
    r = lint_snippet(tmp_path, COL_CLEAN)
    assert not {"COL001", "COL002"} & rules_fired(r)


def test_col_scoped_to_columnar_modules(tmp_path):
    # default policy: only policy.COLUMNAR paths are in scope
    f = tmp_path / "plain.py"
    f.write_text("def rows(h):\n    return h.ops\n")
    r = run_lint(paths=[str(f)], baseline_path=None,
                 policy=Policy(), root=str(tmp_path))
    assert "COL001" not in rules_fired(r)


# -- TORCH -------------------------------------------------------------------

TORCH001_FIRE = ("import torch\n"
                 "import torch.nn.functional as F\n"
                 "def walk(x):\n"
                 "    for _ in range(8):\n"
                 "        x = torch.add(x, 1)\n"
                 "    while x.sum() > 0:\n"
                 "        x = F.relu(torch.linalg.norm(x) - x)\n"
                 "    return x\n")

#: loops whose torch calls launch nothing per iteration, or run in a
#: capture, a graphed callable or a plain version
TORCH001_CLEAN = {
    "graph_capture": ("import torch\n"
                      "def capture(x, g):\n"
                      "    with torch.cuda.graph(g):\n"
                      "        for _ in range(8):\n"
                      "            x = torch.add(x, 1)\n"
                      "    return x\n"),
    "captured_helper": ("import torch\n"
                        "def step(x):\n"
                        "    for _ in range(8):\n"
                        "        x = torch.add(x, 1)\n"
                        "    return x\n"
                        "def capture(x, g):\n"
                        "    with torch.cuda.graph(g):\n"
                        "        y = step(x)\n"
                        "    return y\n"),
    "graphed_callables": ("import torch\n"
                          "def body(x):\n"
                          "    for _ in range(8):\n"
                          "        x = torch.mul(x, 2)\n"
                          "    return x\n"
                          "fast = torch.cuda.make_graphed_callables("
                          "body, (torch.ones(4),))\n"),
    "plain_version": ("import torch\n"
                      "def scan_reference(x):\n"
                      "    for _ in range(8):\n"
                      "        x = torch.where(x > 0, x - 1, x)\n"
                      "    return x\n"),
    "runtime_queries": ("import torch\n"
                        "def lanes(n):\n"
                        "    out = []\n"
                        "    for i in range(n):\n"
                        "        if torch.cuda.is_available():\n"
                        "            out.append(torch.device('cuda', i))\n"
                        "    return out\n"),
    "hoisted": ("import torch\n"
                "def walk(x, n):\n"
                "    steps = torch.arange(n)\n"
                "    for i in range(n):\n"
                "        print(i)\n"
                "    return x + steps.sum()\n"),
}


def test_torch001_loop_launch_fires(tmp_path):
    r = lint_snippet(tmp_path, TORCH001_FIRE)
    assert count(r, "TORCH001") == 3   # add, relu, linalg.norm
    msgs = [f.message for f in r.findings if f.rule == "TORCH001"]
    assert any("torch.add()" in m for m in msgs)


@pytest.mark.parametrize("case", sorted(TORCH001_CLEAN))
def test_torch001_clean(tmp_path, case):
    r = lint_snippet(tmp_path, TORCH001_CLEAN[case])
    assert "TORCH001" not in rules_fired(r), case


def test_torch001_policy_plain_versions_clean(tmp_path, monkeypatch):
    src = ("import torch\n"
           "def _dp(x):\n"
           "    for _ in range(8):\n"
           "        x = torch.add(x, 1)\n"
           "    return x\n")
    assert "TORCH001" in rules_fired(lint_snippet(tmp_path, src))
    monkeypatch.setattr(policy, "PLAIN_VERSIONS", ("snippet.py:_dp",))
    assert "TORCH001" not in rules_fired(lint_snippet(tmp_path, src))


TORCH002_FIRE = ("import numpy as np\n"
                 "import torch\n"
                 "def drain(xs, dev, ev0, ev1, stream, a):\n"
                 "    out = []\n"
                 "    for x in xs:\n"
                 "        out.append(x.item())\n"                      # 1
                 "        out.append(x.cpu())\n"                       # 2
                 "        out.append(x.to('cpu'))\n"                   # 3
                 "        out.append(x.to(device='cpu'))\n"            # 4
                 "        torch.cuda.synchronize()\n"                  # 5
                 "        stream.synchronize()\n"                      # 6
                 "        out.append(ev0.elapsed_time(ev1))\n"         # 7
                 "        out.append(torch.sum(x).tolist())\n"         # 8
                 "        out.append(np.asarray(torch.sum(x)))\n"      # 9
                 "        out.append(torch.from_numpy(a).to(dev))\n"   # 10
                 "    return out\n")

TORCH002_CLEAN = {
    "untied_reads": ("def rows(xs):\n"
                     "    out = []\n"
                     "    for x in xs:\n"
                     "        out.append(x.tolist())\n"
                     "        out.append(x.numpy())\n"
                     "    return out\n"),
    "host_dtype_change": ("import numpy as np\n"
                          "import torch\n"
                          "def widen(arrs):\n"
                          "    return [torch.from_numpy(a).to(torch.int64)"
                          "\n            for a in arrs]\n"
                          "def widen_loop(arrs):\n"
                          "    out = []\n"
                          "    for a in arrs:\n"
                          "        out.append(torch.from_numpy(a).to("
                          "torch.int64))\n"
                          "    return out\n"),
    "hoisted": ("def drain(xs):\n"
                "    host = xs.cpu()\n"
                "    return [float(v) for v in host]\n"),
    "host_numpy": ("import numpy as np\n"
                   "def rows(links):\n"
                   "    out = []\n"
                   "    for ln in links:\n"
                   "        out.append(np.asarray(ln, np.int64))\n"
                   "    return out\n"),
    "plain_version": ("def wave_reference(xs):\n"
                      "    out = []\n"
                      "    for x in xs:\n"
                      "        out.append(x.item())\n"
                      "    return out\n"),
}


def test_torch002_sync_in_loop_fires(tmp_path):
    r = lint_snippet(tmp_path, TORCH002_FIRE)
    lines = sorted(f.line for f in r.findings if f.rule == "TORCH002")
    assert lines == list(range(6, 16)), lines


@pytest.mark.parametrize("case", sorted(TORCH002_CLEAN))
def test_torch002_clean(tmp_path, case):
    r = lint_snippet(tmp_path, TORCH002_CLEAN[case])
    assert "TORCH002" not in rules_fired(r), case


TORCH003_FIRE = ("import ctypes\n"
                 "import torch\n"
                 "from torch.utils.cpp_extension import load_inline\n"
                 "def run(fn, x):\n"
                 "    return torch.compile(fn)(x)\n"
                 "def loader(path):\n"
                 "    return ctypes.CDLL(path)\n"
                 "def capture():\n"
                 "    return torch.cuda.CUDAGraph()\n"
                 "def ext(src):\n"
                 "    return load_inline('k', src)\n"
                 "def traced(fn, xs):\n"
                 "    return torch.jit.trace(fn, xs)\n")

TORCH003_CLEAN = {
    "cached": ("import ctypes\n"
               "import functools\n"
               "import torch\n"
               "@functools.lru_cache(maxsize=None)\n"
               "def lib(path):\n"
               "    return ctypes.CDLL(path)\n"
               "@functools.cache\n"
               "def compiled(n):\n"
               "    return torch.compile(lambda v: v + n)\n"),
    "module_level": ("import torch\n"
                     "fast = torch.compile(lambda v: v + 1)\n"
                     "GRAPH = torch.cuda.CUDAGraph()\n"),
    "other_compiles": ("import json\n"
                       "import re\n"
                       "def pat(s, fh):\n"
                       "    return re.compile(s), json.load(fh)\n"),
}


def test_torch003_built_per_call_fires(tmp_path):
    r = lint_snippet(tmp_path, TORCH003_FIRE)
    assert count(r, "TORCH003") == 5


def test_torch003_in_loop_fires_even_when_cached(tmp_path):
    r = lint_snippet(tmp_path, (
        "import functools\n"
        "import torch\n"
        "@functools.lru_cache(maxsize=None)\n"
        "def graphs(n):\n"
        "    return [torch.cuda.CUDAGraph() for _ in range(n)] + \\\n"
        "        [torch.cuda.CUDAGraph()]\n"
        "def per_step(fns):\n"
        "    out = []\n"
        "    for fn in fns:\n"
        "        out.append(torch.compile(fn))\n"
        "    return out\n"))
    assert count(r, "TORCH003") == 1   # the loop, not the cached def


@pytest.mark.parametrize("case", sorted(TORCH003_CLEAN))
def test_torch003_clean(tmp_path, case):
    r = lint_snippet(tmp_path, TORCH003_CLEAN[case])
    assert "TORCH003" not in rules_fired(r), case


TORCH004_FIRE = ("import torch\n"
                 "def zeros(n, x):\n"
                 "    a = torch.zeros(n, dtype=torch.float64)\n"
                 "    b = torch.ones(n, dtype=torch.double)\n"
                 "    c = torch.empty(n, dtype='float64')\n"
                 "    d = torch.full((n,), 1, dtype=float)\n"
                 "    return a, b, c, d, x.double(), x.to(torch.float64),"
                 " x.to(dtype=torch.float64)\n")

TORCH004_CLEAN = {
    "numpy_host": ("import numpy as np\n"
                   "def mean(xs):\n"
                   "    return np.asarray(xs, dtype=np.float64).mean()\n"),
    "int_kernels": ("import torch\n"
                    "def zeros(n, x):\n"
                    "    return torch.zeros(n, dtype=torch.int32), "
                    "x.to(torch.int64), x.float()\n"),
}


def test_torch004_float64_fires(tmp_path):
    assert count(lint_snippet(tmp_path, TORCH004_FIRE), "TORCH004") == 7


@pytest.mark.parametrize("case", sorted(TORCH004_CLEAN))
def test_torch004_clean(tmp_path, case):
    r = lint_snippet(tmp_path, TORCH004_CLEAN[case])
    assert "TORCH004" not in rules_fired(r), case


def test_torch_messages_cite_no_tpu_number(tmp_path):
    r = lint_snippet(tmp_path, TORCH001_FIRE + TORCH002_FIRE +
                     TORCH003_FIRE + TORCH004_FIRE)
    msgs = {f.message for f in r.findings if f.rule.startswith("TORCH")}
    assert len({f.rule for f in r.findings
                if f.rule.startswith("TORCH")}) == 4
    for m in msgs:
        assert "TPU" not in m and "ms" not in m.split() and "PERF" not in m


# -- THR ---------------------------------------------------------------------

_THR_RACY = """\
import threading

class Feed:
    def __init__(self):
        self.rows = 0
        self._cv = threading.Condition()
        self._t = threading.Thread(target=self._worker)

    def _worker(self):
        self.rows += 1
"""
_THR_LOCKED = _THR_RACY.replace(
    "        self.rows += 1",
    "        with self._cv:\n            self.rows += 1")
THR002_FIRE = ("import threading\n"
               "N = 0\n"
               "def _worker():\n"
               "    global N\n"
               "    N += 1\n"
               "t = threading.Thread(target=_worker)\n")


def test_thr001_unlocked_write_fires(tmp_path):
    assert "THR001" in rules_fired(lint_snippet(tmp_path, _THR_RACY))


def test_thr001_locked_write_clean(tmp_path):
    assert "THR001" not in rules_fired(lint_snippet(tmp_path, _THR_LOCKED))


def test_thr002_global_rebind_fires(tmp_path):
    assert "THR002" in rules_fired(lint_snippet(tmp_path, THR002_FIRE))


# -- TEL ---------------------------------------------------------------------

TEL001_FIRE = ("def trace(tel):\n"
               "    tel.span('good.span')\n")
TEL001_CLEAN = ("def trace(tel):\n"
                "    with tel.span('good.span'):\n"
                "        pass\n")
TEL002_FIRE = ("def bump(tel):\n"
               "    tel.counter('a.typo')\n")
TEL002_CLEAN = ("def bump(tel, name):\n"
                "    tel.counter('a.b')\n"
                "    tel.counter(f'stream.{name}_reuse')\n"
                "    with tel.span('phase:setup'):\n"
                "        pass\n")
TEL_HIST_FIRE = ("def fold(tel, vals):\n"
                 "    tel.hist('h.typo', 1.0)\n"
                 "    tel.hist_many('h.typo2', vals)\n")
TEL_HIST_CLEAN = ("def fold(tel, vals, f):\n"
                  "    tel.hist('good.hist', 1.0)\n"
                  "    tel.hist_many(f'lat.{f}', vals)\n")
TEL_RE_MATCH = ("import re\n"
                "def where(m):\n"
                "    return m.span(1)\n")


def test_tel001_unentered_span_fires(tmp_path):
    assert "TEL001" in rules_fired(lint_snippet(tmp_path, TEL001_FIRE))


def test_tel001_with_span_clean(tmp_path):
    assert "TEL001" not in rules_fired(lint_snippet(tmp_path, TEL001_CLEAN))


def test_tel002_unregistered_name_fires(tmp_path):
    assert "TEL002" in rules_fired(lint_snippet(tmp_path, TEL002_FIRE))


def test_tel002_wildcard_and_prefix_clean(tmp_path):
    assert "TEL002" not in rules_fired(lint_snippet(tmp_path, TEL002_CLEAN))


def test_tel002_hist_names_checked(tmp_path):
    assert "TEL002" in rules_fired(lint_snippet(tmp_path, TEL_HIST_FIRE))


def test_tel002_registered_hist_clean(tmp_path):
    r = lint_snippet(tmp_path, TEL_HIST_CLEAN)
    assert "TEL002" not in rules_fired(r)


def test_tel_re_match_span_not_confused(tmp_path):
    # re.Match.span(1) has no string arg: not the telemetry signature
    r = lint_snippet(tmp_path, TEL_RE_MATCH)
    assert not {"TEL001", "TEL002"} & rules_fired(r)


# -- suppressions ------------------------------------------------------------

SUPPRESSED = ("import random\n"
              "def draw():\n"
              "    # graftlint: ignore[DET002] fixture exercises the grammar\n"
              "    return random.random()\n")
SUPPRESSED_FAMILY = ("import random\n"
                     "def draw():\n"
                     "    return random.random()  "
                     "# graftlint: ignore[DET] family-wide fixture\n")
NO_REASON = ("import random\n"
             "def draw():\n"
             "    return random.random()  # graftlint: ignore[DET002]\n")
ORPHAN = ("def clean():\n"
          "    # graftlint: ignore[DET002] nothing fires here\n"
          "    return 1\n")


def test_suppression_with_reason_silences(tmp_path):
    r = lint_snippet(tmp_path, SUPPRESSED)
    assert not r.errors
    assert any(f.rule == "DET002" and f.suppressed for f in r.findings)


def test_suppression_inline_and_family(tmp_path):
    assert not lint_snippet(tmp_path, SUPPRESSED_FAMILY).errors


def test_suppression_without_reason_is_lint002(tmp_path):
    r = lint_snippet(tmp_path, NO_REASON)
    assert {f.rule for f in r.errors} == {"LINT002"}


def test_orphan_suppression_is_lint001(tmp_path):
    assert {f.rule for f in lint_snippet(tmp_path, ORPHAN).errors} == \
        {"LINT001"}


def test_torch_suppression_and_orphan(tmp_path):
    r = lint_snippet(tmp_path, (
        "import torch\n"
        "def walk(x):\n"
        "    for _ in range(8):\n"
        "        # graftlint: ignore[TORCH001] fixture: a fixed eight\n"
        "        x = torch.add(x, 1)\n"
        "    # graftlint: ignore[TORCH002] nothing syncs here\n"
        "    return x\n"))
    assert {f.rule for f in r.errors} == {"LINT001"}
    assert any(f.rule == "TORCH001" and f.suppressed for f in r.findings)


def test_jax_suppression_is_an_orphan_only_when_jax_runs(tmp_path):
    """The port has no JAX family: a copied ``ignore[JAX002]`` is
    unknown to it and so never an orphan; the reference's linter, which
    runs JAX, flags it."""
    src = ("import numpy as np\n"
           "def rows(links):\n"
           "    # graftlint: ignore[JAX002] host numpy\n"
           "    return np.array(links)\n")
    assert not lint_snippet(tmp_path, src).errors
    assert {f.rule for f in lint_snippet(tmp_path, src,
                                         pkg=ref_lint).errors} == \
        {"LINT001"}


# -- baseline ----------------------------------------------------------------

def test_baseline_round_trip(tmp_path):
    src = DET002_FIRE
    bl = tmp_path / "baseline.json"
    first = lint_snippet(tmp_path, src)
    assert first.errors
    write_baseline(str(bl), first.findings)
    # grandfathered: same findings, zero errors
    again = lint_snippet(tmp_path, src, baseline_path=str(bl))
    assert not again.errors
    assert any(f.baselined for f in again.findings)
    # finding fixed: the stale entry must flag LINT004
    fixed = lint_snippet(tmp_path, DET002_CLEAN, baseline_path=str(bl))
    assert {f.rule for f in fixed.errors} == {"LINT004"}


def test_committed_baseline_is_empty():
    with open(engine.DEFAULT_BASELINE) as f:
        assert json.load(f) == {"version": 1, "entries": []}


# -- selection ---------------------------------------------------------------

def test_select_by_family_and_id():
    fams = {f.FAMILY for f in select(["DET"])}
    assert fams == {"DET"}
    fams = {f.FAMILY for f in select(["col001", "TEL", "torch003"])}
    assert fams == {"COL", "TEL", "TORCH"}
    with pytest.raises(ValueError):
        select(["NOPE999"])
    with pytest.raises(ValueError):
        select(["JAX"])   # the port has no JAX family
    assert len(ALL_RULES) == 13
    assert {f.FAMILY for f in FAMILIES} == {"DET", "COL", "TORCH", "THR",
                                            "TEL"}


def test_rule_filter_scopes_findings(tmp_path):
    # selection is family-granular: asking for DET002 runs the DET
    # family and nothing else
    r = lint_snippet(tmp_path, (
        "import random\n"
        "import torch\n"
        "def draw(tel, x):\n"
        "    tel.counter('a.typo')\n"
        "    for _ in range(2):\n"
        "        x = torch.add(x, 1)\n"
        "    return random.random()\n"),
        rules=["DET002"])
    fired = rules_fired(r)
    assert "DET002" in fired
    assert all(rule.startswith("DET") for rule in fired)


# -- parity with the reference's linter on the shared families ---------------

SHARED = {
    "det001_fire": DET001_FIRE, "det001_clean": DET001_CLEAN,
    "det002_fire": DET002_FIRE, "det002_clean": DET002_CLEAN,
    "det003_fire": DET003_FIRE, "det003_clean": DET003_CLEAN,
    "col001_fire": COL001_FIRE, "col002_fire": COL002_FIRE,
    "col_clean": COL_CLEAN,
    "thr001_fire": _THR_RACY, "thr001_clean": _THR_LOCKED,
    "thr002_fire": THR002_FIRE,
    "tel001_fire": TEL001_FIRE, "tel001_clean": TEL001_CLEAN,
    "tel002_fire": TEL002_FIRE, "tel002_clean": TEL002_CLEAN,
    "tel_hist_fire": TEL_HIST_FIRE, "tel_hist_clean": TEL_HIST_CLEAN,
    "tel_re_match": TEL_RE_MATCH,
    "suppressed": SUPPRESSED, "suppressed_family": SUPPRESSED_FAMILY,
    "lint002_no_reason": NO_REASON, "lint001_orphan": ORPHAN,
    "lint000_no_parse": "def broken(:\n    pass\n",
}
SHARED_FAMILIES = ["DET", "COL", "THR", "TEL"]


def _facts(report) -> list:
    return [(f.rule, f.path, f.line, f.col, f.message, f.snippet,
             f.suppressed, f.baselined, f.fingerprint())
            for f in report.findings]


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_families_equal_reference(tmp_path, case):
    port = lint_snippet(tmp_path, SHARED[case], rules=SHARED_FAMILIES)
    ref = lint_snippet(tmp_path, SHARED[case], rules=SHARED_FAMILIES,
                       pkg=ref_lint)
    assert _facts(port) == _facts(ref)
    assert port.files == ref.files
    assert port.rules_run == ref.rules_run


def test_baseline_machinery_equals_reference(tmp_path):
    """write_baseline writes the same file, and a stale entry is the
    same LINT004, from either package."""
    a, b = tmp_path / "a", tmp_path / "b"
    for d, mod, eng in ((a, sys.modules[__name__], engine),
                        (b, ref_lint, ref_engine)):
        d.mkdir()
        first = lint_snippet(d, DET002_FIRE + DET003_FIRE, pkg=mod)
        eng.write_baseline(str(d / "baseline.json"), first.findings)
    assert (a / "baseline.json").read_text() == \
        (b / "baseline.json").read_text()
    stale = [_facts(lint_snippet(d, DET002_CLEAN, pkg=mod,
                                 baseline_path=str(d / "baseline.json")))
             for d, mod in ((a, sys.modules[__name__]), (b, ref_lint))]
    assert stale[0] == stale[1]
    assert {f[0] for f in stale[0]} == {"LINT004"}


def test_reference_linter_finds_port_tree_clean():
    """The reference's linter, run over the port's package with the
    families both share, finds exactly what the port's own linter
    finds there: nothing unsuppressed."""
    kw = dict(paths=[PORT], rules=SHARED_FAMILIES, baseline_path=None)
    ref = ref_lint.run_lint(root=PORT, **kw)
    port = run_lint(root=REPO, **kw)
    assert not ref.errors, [f"{f.location()}: {f.rule}"
                            for f in ref.errors]
    assert _facts(ref) == _facts(port)
    assert ref.files == port.files > 50


# -- the tier-1 gate ---------------------------------------------------------

def test_tree_is_lint_clean():
    """THE gate: the port's tree has zero non-suppressed,
    non-baselined findings — no regression in the five families, no
    orphaned suppression, no stale baseline entry."""
    report = run_lint(root=REPO)
    msgs = [f"{f.location()}: {f.rule}: {f.message}"
            for f in report.errors]
    assert not msgs, "\n".join(msgs)
    assert report.files > 50  # the whole package was actually scanned
    assert not any(f.baselined for f in report.findings)
    assert all(f.path.split("/")[0] != "lint" for f in report.findings)


def test_tree_suppressions_name_port_rules_with_reasons():
    """Every in-tree suppression carries a reason and names a rule or
    family the port's linter has (no copied JAX ids)."""
    known = set(ALL_RULES) | {f.FAMILY for f in FAMILIES}
    sups = []
    for root, _, files in os.walk(PORT):
        for fn in files:
            if not fn.endswith(".py") or "/lint" in root + "/":
                continue
            path = os.path.join(root, fn)
            rel = os.path.relpath(path, PORT)
            with open(path) as fh:
                mod = engine.SourceModule(path, rel, fh.read())
            sups += [(rel, s) for s in mod.suppressions]
    assert sups
    for rel, s in sups:
        assert s.reason, rel
        assert set(s.rules) <= known, (rel, s.rules)


def test_cli_exit_codes(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_etcd_tpu_torch.lint", "--json"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    data = json.loads(out.stdout)
    assert data["errors"] == 0 and data["files"] > 50
    assert data["rules"] == sorted(ALL_RULES)
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n"
                   "def f(x):\n"
                   "    for _ in range(3):\n"
                   "        x = torch.add(x, 1)\n"
                   "    return x\n")
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_etcd_tpu_torch.lint", str(bad)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    assert "TORCH001" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_etcd_tpu_torch.lint", "--rule",
         "JAX", str(bad)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "unknown rules" in out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_etcd_tpu_torch.lint",
         "--list-rules"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    assert [ln.split()[0] for ln in out.stdout.splitlines()
            if ln.startswith("TORCH")] == ["TORCH001", "TORCH002",
                                           "TORCH003", "TORCH004"]


def test_linter_imports_neither_torch_nor_jax():
    """The engine parses ASTs: linting the port loads no torch, no
    jax and nothing of the JAX package."""
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from jepsen_etcd_tpu_torch.lint.engine import run_lint\n"
            "assert 'jepsen_etcd_tpu_torch' in sys.modules\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('torch', 'jax', 'jepsen_etcd_tpu')]\n"
            "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout
