"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points run on CUDA unless told otherwise."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "jepsen_etcd_tpu_torch",
    "jepsen_etcd_tpu_torch.device",
    "jepsen_etcd_tpu_torch.testing",
    "jepsen_etcd_tpu_torch.core",
    "jepsen_etcd_tpu_torch.core.op",
    "jepsen_etcd_tpu_torch.core.history",
    "jepsen_etcd_tpu_torch.core.mvcc",
    "jepsen_etcd_tpu_torch.models",
    "jepsen_etcd_tpu_torch.checkers",
    "jepsen_etcd_tpu_torch.checkers.core",
    "jepsen_etcd_tpu_torch.checkers.independent",
    "jepsen_etcd_tpu_torch.checkers.linearizable",
    "jepsen_etcd_tpu_torch.checkers.mvcc",
    "jepsen_etcd_tpu_torch.checkers.set_full",
    "jepsen_etcd_tpu_torch.checkers.session",
    "jepsen_etcd_tpu_torch.checkers.tpu_linearizable",
    "jepsen_etcd_tpu_torch.checkers.watch",
    "jepsen_etcd_tpu_torch.checkers.elle",
    "jepsen_etcd_tpu_torch.checkers.elle.graph",
    "jepsen_etcd_tpu_torch.checkers.elle.append",
    "jepsen_etcd_tpu_torch.checkers.elle.wr",
    "jepsen_etcd_tpu_torch.checkers.perf",
    "jepsen_etcd_tpu_torch.checkers.timeline",
    "jepsen_etcd_tpu_torch.runner",
    "jepsen_etcd_tpu_torch.runner.sim",
    "jepsen_etcd_tpu_torch.runner.interpreter",
    "jepsen_etcd_tpu_torch.runner.test_runner",
    "jepsen_etcd_tpu_torch.runner.store",
    "jepsen_etcd_tpu_torch.runner.store_index",
    "jepsen_etcd_tpu_torch.runner.trace",
    "jepsen_etcd_tpu_torch.runner.telemetry",
    "jepsen_etcd_tpu_torch.runner.stream",
    "jepsen_etcd_tpu_torch.runner.transport",
    "jepsen_etcd_tpu_torch.runner.checker_service",
    "jepsen_etcd_tpu_torch.runner.campaign",
    "jepsen_etcd_tpu_torch.runner.shrink",
    "jepsen_etcd_tpu_torch.runner.guided",
    "jepsen_etcd_tpu_torch.runner.host_agent",
    "jepsen_etcd_tpu_torch.runner.wall",
    "jepsen_etcd_tpu_torch.tel_cli",
    "jepsen_etcd_tpu_torch.forensics",
    "jepsen_etcd_tpu_torch.serve",
    "jepsen_etcd_tpu_torch.lint",
    "jepsen_etcd_tpu_torch.lint.__main__",
    "jepsen_etcd_tpu_torch.lint.engine",
    "jepsen_etcd_tpu_torch.lint.callgraph",
    "jepsen_etcd_tpu_torch.lint.policy",
    "jepsen_etcd_tpu_torch.lint.rules",
    "jepsen_etcd_tpu_torch.lint.rules.col",
    "jepsen_etcd_tpu_torch.lint.rules.det",
    "jepsen_etcd_tpu_torch.lint.rules.tel",
    "jepsen_etcd_tpu_torch.lint.rules.thr",
    "jepsen_etcd_tpu_torch.lint.rules.torch_rules",
    "jepsen_etcd_tpu_torch.simbatch",
    "jepsen_etcd_tpu_torch.simbatch.heap",
    "jepsen_etcd_tpu_torch.simbatch.engine",
    "jepsen_etcd_tpu_torch.simbatch.threefry",
    "jepsen_etcd_tpu_torch.simbatch.engine_v3",
    "jepsen_etcd_tpu_torch.generators",
    "jepsen_etcd_tpu_torch.generators.core",
    "jepsen_etcd_tpu_torch.generators.elle",
    "jepsen_etcd_tpu_torch.generators.independent",
    "jepsen_etcd_tpu_torch.sut",
    "jepsen_etcd_tpu_torch.sut.errors",
    "jepsen_etcd_tpu_torch.sut.store",
    "jepsen_etcd_tpu_torch.sut.wal",
    "jepsen_etcd_tpu_torch.sut.cluster",
    "jepsen_etcd_tpu_torch.sut.http_gateway",
    "jepsen_etcd_tpu_torch.sut.grpc_gateway",
    "jepsen_etcd_tpu_torch.client",
    "jepsen_etcd_tpu_torch.client.txn",
    "jepsen_etcd_tpu_torch.client.errors",
    "jepsen_etcd_tpu_torch.client.base",
    "jepsen_etcd_tpu_torch.client.direct",
    "jepsen_etcd_tpu_torch.client.etcdctl",
    "jepsen_etcd_tpu_torch.client.etcd_http",
    "jepsen_etcd_tpu_torch.client.etcd_grpc",
    "jepsen_etcd_tpu_torch.client.proto",
    "jepsen_etcd_tpu_torch.client.proto.etcd_rpc_pb2",
    "jepsen_etcd_tpu_torch.nemesis",
    "jepsen_etcd_tpu_torch.nemesis.packages",
    "jepsen_etcd_tpu_torch.nemesis.faults",
    "jepsen_etcd_tpu_torch.db",
    "jepsen_etcd_tpu_torch.db.etcd",
    "jepsen_etcd_tpu_torch.db.live",
    "jepsen_etcd_tpu_torch.db.local",
    "jepsen_etcd_tpu_torch.db.fake_etcd",
    "jepsen_etcd_tpu_torch.net",
    "jepsen_etcd_tpu_torch.net.proxy",
    "jepsen_etcd_tpu_torch.net.plane",
    "jepsen_etcd_tpu_torch.workloads",
    "jepsen_etcd_tpu_torch.workloads.base",
    "jepsen_etcd_tpu_torch.workloads.debug",
    "jepsen_etcd_tpu_torch.workloads.register",
    "jepsen_etcd_tpu_torch.workloads.none",
    "jepsen_etcd_tpu_torch.workloads.watch",
    "jepsen_etcd_tpu_torch.workloads.append",
    "jepsen_etcd_tpu_torch.workloads.wr",
    "jepsen_etcd_tpu_torch.workloads.set",
    "jepsen_etcd_tpu_torch.workloads.lock",
    "jepsen_etcd_tpu_torch.workloads.mvcc",
    "jepsen_etcd_tpu_torch.compose",
    "jepsen_etcd_tpu_torch.cli",
    "jepsen_etcd_tpu_torch.ops",
    "jepsen_etcd_tpu_torch.ops.common",
    "jepsen_etcd_tpu_torch.ops.closure",
    "jepsen_etcd_tpu_torch.ops.edit_distance",
    "jepsen_etcd_tpu_torch.ops.wgl",
    "jepsen_etcd_tpu_torch.ops.wgl_mxu",
    "jepsen_etcd_tpu_torch.ops._cuda",
    "jepsen_etcd_tpu_torch.native",
    "jepsen_etcd_tpu_torch.native.oracle",
]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    # a fresh interpreter: conftest and the reference tests import jax
    # into this one
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import runpy\n"
        f"runpy.run_path({os.path.join(REPO, 'chip_smoke.py')!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.')\n"
        "             or m == 'jepsen_etcd_tpu'\n"
        "             or m.startswith('jepsen_etcd_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def test_port_sources_name_no_jax_import():
    """No file of the port (and not chip_smoke.py) has an import line
    naming jax or the JAX package."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO,
                                               "jepsen_etcd_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                s = line.strip()
                if not s.startswith(("import ", "from ")):
                    continue
                mod = s.split()[1]
                if mod.split(".")[0] in ("jax", "jaxlib",
                                         "jepsen_etcd_tpu"):
                    offenders.append(f"{path}:{n}: {s}")
    assert not offenders, offenders


#: top-level packages a fake-etcd node must never import
HEAVY = ("torch", "jax", "jaxlib", "numpy", "jepsen_etcd_tpu")


def test_spawned_fake_etcd_imports_no_torch():
    """A fake-etcd node (``db/local.py`` spawns it by file path, at
    every start, restart and crash-loop probe) needs only ``sut/``: run
    by file path (here with no arguments, so it exits once its imports
    are done), its import trace names neither torch nor jax nor the JAX
    package."""
    from jepsen_etcd_tpu_torch.db.local import FAKE_ETCD
    assert FAKE_ETCD == os.path.join(REPO, "jepsen_etcd_tpu_torch", "db",
                                     "fake_etcd.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-X", "importtime", FAKE_ETCD],
                         cwd="/", env=env, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 2, out.stderr
    imported = [ln.rsplit("|", 1)[1].strip() for ln in
                out.stderr.splitlines() if ln.startswith("import time:")]
    assert "jepsen_etcd_tpu_torch.sut.http_gateway" in imported
    assert not [m for m in imported if m.split(".")[0] in HEAVY]


def test_host_agents_spawn_this_package():
    """A campaign's ``--hosts`` agents run this package's worker-agent
    command, never the JAX package's."""
    from jepsen_etcd_tpu_torch.runner import host_agent
    argv = host_agent.agent_argv("tcp://127.0.0.1:1", "host1")
    assert argv[:4] == [sys.executable, "-m", "jepsen_etcd_tpu_torch",
                        "worker-agent"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_pack():
    from jepsen_etcd_tpu_torch.core.history import History
    from jepsen_etcd_tpu_torch.core.op import Op
    from jepsen_etcd_tpu_torch.ops import wgl
    h = History([
        Op(type="invoke", process=0, f="write", value=[None, 1]),
        Op(type="ok", process=0, f="write", value=[1, 1]),
        Op(type="invoke", process=1, f="read", value=[None, None]),
        Op(type="ok", process=1, f="read", value=[1, 1]),
    ])
    return h, wgl.pack_register_history(h)


def _watch_history():
    from jepsen_etcd_tpu_torch.core.history import History
    from jepsen_etcd_tpu_torch.core.op import Op
    log = list(range(200))
    return History([Op(type=t, process=p, f="watch",
                       value=None if t == "invoke" else
                       {"revision": 201, "log": log})
                    for p in (0, 1) for t in ("invoke", "ok")])


def _mutex_history():
    from jepsen_etcd_tpu_torch.core.history import History
    from jepsen_etcd_tpu_torch.core.op import Op
    return History([Op(type=t, process=p, f=f, value=None)
                    for p, f in ((0, "acquire"), (0, "release"),
                                 (1, "acquire"))
                    for t in ("invoke", "ok")])


def _streamed_check(h, dev):
    """A register check handed a streamed pack hint: it runs where the
    checker's device says, as a post-hoc check does."""
    from jepsen_etcd_tpu_torch.checkers.independent import Independent
    from jepsen_etcd_tpu_torch.checkers.tpu_linearizable import \
        TPULinearizableChecker
    from jepsen_etcd_tpu_torch.core.history import History
    from jepsen_etcd_tpu_torch.ops import wgl
    from jepsen_etcd_tpu_torch.testing import keyed
    kh = History(keyed(h, "k", 0) + keyed(h, "j", 10))
    kh = History(kh.ops, columns=_columns(kh))
    packs = wgl.pack_register_histories_batched(kh.split_by_key())
    test = {"_stream": {"stats": {}, "register_packs": (packs, len(kh))}}
    return Independent(TPULinearizableChecker(
        cpu_cutoff=None, device=dev)).check(test, kh)


def _columns(h):
    from jepsen_etcd_tpu_torch.core.history import columns_of
    return columns_of([dict(o, index=i, time=i)
                       for i, o in enumerate(h.ops)])


def _launch(p, dev):
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    outs = [None]
    wgl_mxu.collect_packed_batch_mxu(
        wgl_mxu.launch_packed_batch_mxu([p], device=dev), outs)
    return outs[0]


@pytest.mark.parametrize("entry", ["resolve_device", "checker",
                                   "check_packed", "check_packed_ladder",
                                   "check_prefix", "check_packed_mxu",
                                   "check_packed_batch_mxu",
                                   "launch_packed_batch_mxu",
                                   "check_packed_batch", "check_batch",
                                   "independent_check",
                                   "watch_checker", "edit_distance_batch",
                                   "closure_batch", "list_append_checker",
                                   "rw_register_checker", "generate_jax",
                                   "generate_for_opts_v3",
                                   "default_schedule_jax",
                                   "fused_pipeline", "lock_checker",
                                   "stream_check_batch"])
def test_entry_points_raise_without_cuda_unless_cpu(no_cuda, entry):
    from jepsen_etcd_tpu_torch.checkers.independent import Independent
    from jepsen_etcd_tpu_torch.checkers.tpu_linearizable import \
        TPULinearizableChecker
    from jepsen_etcd_tpu_torch.checkers.watch import WatchChecker
    from jepsen_etcd_tpu_torch.core.history import History
    from jepsen_etcd_tpu_torch.device import resolve_device
    from jepsen_etcd_tpu_torch.checkers.elle import (ListAppendChecker,
                                                     RWRegisterChecker)
    from jepsen_etcd_tpu_torch.ops import closure, edit_distance, wgl, \
        wgl_mxu
    from jepsen_etcd_tpu_torch.runner.stream import FusedPipeline
    from jepsen_etcd_tpu_torch.simbatch import (BatchConfig,
                                                default_schedule_jax,
                                                generate_for_opts,
                                                generate_jax)
    from jepsen_etcd_tpu_torch.testing import (gen_append_history,
                                               gen_wr_history, keyed)
    from jepsen_etcd_tpu_torch.workloads import workloads
    h, p = _tiny_pack()
    sim = {"workload": "register", "concurrency": 4, "rate": 100.0,
           "time_limit": 0.2, "nemesis": ["kill"]}
    call = {
        "resolve_device": lambda dev: resolve_device(dev),
        "checker": lambda dev: TPULinearizableChecker(
            cpu_cutoff=None, device=dev).check({}, h),
        "check_packed": lambda dev: wgl.check_packed(p, device=dev),
        "check_packed_ladder": lambda dev: wgl.check_packed(
            p, f_max=32, device=dev),
        "check_prefix": lambda dev: wgl.check_prefix(
            p, device=dev).result,
        "check_packed_mxu": lambda dev: wgl_mxu.check_packed_mxu(
            p, device=dev),
        "check_packed_batch_mxu": lambda dev: wgl_mxu.check_packed_batch_mxu(
            [p], device=dev)[0],
        "launch_packed_batch_mxu": lambda dev: _launch(p, dev),
        "check_packed_batch": lambda dev: wgl.check_packed_batch(
            [p, p], f_max=32, device=dev)[0],
        "check_batch": lambda dev: TPULinearizableChecker(
            cpu_cutoff=None, device=dev).check_batch({}, {"a": h, "b": h})[
                "b"],
        "independent_check": lambda dev: Independent(TPULinearizableChecker(
            cpu_cutoff=None, device=dev)).check(
                {}, History(keyed(h, "k", 0) + keyed(h, "j", 10))),
        "watch_checker": lambda dev: WatchChecker(device=dev).check(
            {"concurrency": 2}, _watch_history()),
        "edit_distance_batch": lambda dev: {
            "valid?": edit_distance.edit_distance_batch(
                [1, 2, 3], [[1, 3]], force_device=True,
                device=dev) == [1]},
        "closure_batch": lambda dev: {
            "valid?": not closure.closure_batch(
                np.zeros((1, 3, 3), bool), force_device=True,
                device=dev)[1].any()},
        "list_append_checker": lambda dev: ListAppendChecker(
            use_tpu=True, device=dev).check(
                {}, gen_append_history(random.Random(1), 3, 20)),
        "rw_register_checker": lambda dev: RWRegisterChecker(
            use_tpu=True, device=dev).check(
                {}, gen_wr_history(random.Random(1), 3, 20)),
        "generate_jax": lambda dev: {"valid?": len(generate_jax(
            BatchConfig.from_opts(sim), [1], device=dev)[
                "histories"][0]) > 0},
        "generate_for_opts_v3": lambda dev: {"valid?": generate_for_opts(
            dict(sim, gen_epoch="epoch-v3"), [1], device=dev)[
                "epoch"] == "epoch-v3"},
        "default_schedule_jax": lambda dev: {"valid?": len(
            default_schedule_jax(BatchConfig.from_opts(sim), 1,
                                 device=dev)) > 0},
        "fused_pipeline": lambda dev: {"valid?": FusedPipeline(
            sim, device=dev).run([1])["verdicts"] == {1: True}},
        "lock_checker": lambda dev: workloads()["lock"](
            {"device": dev, "force_kernel": True})["checker"].check(
                {}, _mutex_history()),
        "stream_check_batch": lambda dev: _streamed_check(h, dev),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call("cuda")
    got = call("cpu")
    if entry == "resolve_device":
        assert got == torch.device("cpu")
    else:
        assert got["valid?"] is True


def test_wave_search_rejects_bad_inputs():
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    tab = torch.zeros((1, 16, 128), dtype=torch.int32)
    scal = torch.zeros((1, 16, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        wgl_mxu.wave_search(tab.long(), scal, 32)
    with pytest.raises(ValueError):
        wgl_mxu.wave_search(tab, scal, 48)
    with pytest.raises(ValueError):
        wgl_mxu.wave_search(tab[:, :, :64], scal, 32)
    with pytest.raises(ValueError):
        wgl_mxu.wave_search(tab, scal[:, :8], 32)
    out = wgl_mxu.wave_search(tab, scal, 32)
    assert out.dtype == torch.int32 and tuple(out.shape) == (1, 4)
    assert np.array_equal(out.numpy(), [[0, 0, 1, 1]])
