"""Fixtures and helpers shared by the port's test files
(``tests/test_torch_*.py``); each imports what it uses, so pytest
applies it there.

The twins of the reference's unit tests (``test_torch_<name>.py`` for
the reference's ``test_<name>.py``) run each test's body on both
packages: ``both`` for a body written over a package name, and
``run_test_both`` for a simulated run, whose history bytes, verdict
dicts, ``test.json`` and timeline it holds equal."""

import importlib
import json
import os
import re

import pytest
import torch

REF, PORT = "jepsen_etcd_tpu", "jepsen_etcd_tpu_torch"

#: result fields that read the host's wall clock: the run's telemetry
#: summary (span seconds)
WALL_CLOCK_FIELDS = ("telemetry",)

#: test.json keys that name where and on what a run ran, not what it ran
WHERE = ("device", "store_base", "store_dir")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel workers on a few cores: torch's
    intra-op threads would spin against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mod(pkg: str, name: str):
    """Package ``pkg``'s module ``name`` (``"runner.sim"``)."""
    return importlib.import_module(f"{pkg}.{name}")


def both(body, *args, **kw):
    """``body(pkg, ...)`` on the port, then on the reference: the two
    outputs must be equal. Returns the port's."""
    got = body(PORT, *args, **kw)
    assert got == body(REF, *args, **kw)
    return got


def as_json(x):
    """A verdict dict as JSON reads it back (tuples become lists, keys
    strings, objects their repr)."""
    return json.loads(json.dumps(x, default=repr, sort_keys=True))


def _stored(run_dir: str, name: str) -> str:
    with open(os.path.join(run_dir, name)) as f:
        return f.read()


def _no_addresses(text: str) -> str:
    """``text`` with the addresses in objects' reprs (``<function f at
    0x7f...>``) blanked: they differ from one process to the next."""
    return re.sub(r" at 0x[0-9a-f]+", " at 0x", text)


def comparable(out, store) -> dict:
    """A run's results without their wall-clock fields, the timeline's
    file relative to its store."""
    res = {k: v for k, v in out["results"].items()
           if k not in WALL_CLOCK_FIELDS}
    if "file" in res.get("timeline", {}):
        res["timeline"] = dict(res["timeline"], file=os.path.relpath(
            res["timeline"]["file"], str(store)))
    return as_json(res)


def run_test_both(tmp_path, opts: dict, test_hook=None) -> tuple:
    """``run_test(etcd_test(opts))`` on the reference and on the port
    (``device="cpu"``), each under its own store below ``tmp_path``.
    Holds equal the history bytes, the verdict dicts, ``sim-seconds``,
    ``test.json`` (``WHERE`` aside) and ``timeline.html``, the package's
    name aside (objects' reprs in ``test.json`` name their module). Returns
    (port's out, reference's out, port's test, reference's test);
    ``test_hook(test)``, where given, returns what of each package's
    test map must be equal too."""
    outs, tests = {}, {}
    for pkg, extra in ((REF, {}), (PORT, {"device": "cpu"})):
        store = tmp_path / pkg
        test = mod(pkg, "compose").etcd_test(
            dict(opts, store_base=str(store), **extra))
        outs[pkg] = (mod(pkg, "runner.test_runner").run_test(test), store)
        tests[pkg] = test
    (port, pstore), (ref, rstore) = outs[PORT], outs[REF]
    assert port["history"].to_jsonl() == ref["history"].to_jsonl()
    assert comparable(port, pstore) == comparable(ref, rstore)
    assert port["valid?"] == ref["valid?"]
    assert port["sim-seconds"] == ref["sim-seconds"]
    got = json.loads(_no_addresses(_stored(port["dir"], "test.json")))
    want = json.loads(_no_addresses(
        _stored(ref["dir"], "test.json").replace(REF, PORT)))
    assert got["device"] == "cpu"
    assert {k: v for k, v in got.items() if k not in WHERE} == \
        {k: v for k, v in want.items() if k not in WHERE}
    assert _stored(port["dir"], "timeline.html") == \
        _stored(ref["dir"], "timeline.html").replace(REF, PORT)
    if test_hook is not None:
        assert test_hook(tests[PORT]) == test_hook(tests[REF])
    return port, ref, tests[PORT], tests[REF]
