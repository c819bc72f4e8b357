"""The port's coverage-guided search and shrinker (``runner/guided.py``,
``runner/shrink.py``) against the JAX package's, on the CPU, on the
shapes of ``tests/test_guided.py``: explicit schedules replay the drawn
plan bit for bit; the scheduler's candidate stream, scoring, corpus
export/import and ageing equal the reference's for the same master
seed; the guided search against the seeded stale-read bug finds the same
failure at the same run, with ``guided.json``'s ledger, signatures,
envelope and corpus equal to the reference's; its minimized repro's
``shrink.json`` equals the reference's (the ``repro`` line names this
package) and replays; and ``tel --corpus`` / ``--coverage`` read the
same. The reference test's ``aggregate_html`` checks run against the
port's ``serve.py`` in ``tests/test_torch_readers.py`` and
``tests/test_torch_serve.py``."""

import json
import os

import pytest

from jepsen_etcd_tpu import tel_cli as ref_tel
from jepsen_etcd_tpu.runner import guided as ref_guided
from jepsen_etcd_tpu.runner import shrink as ref_shrink
from jepsen_etcd_tpu.simbatch import BatchConfig as RefBatchConfig
from jepsen_etcd_tpu.simbatch import default_schedule as ref_default_schedule
from jepsen_etcd_tpu.simbatch import generate as ref_generate
from jepsen_etcd_tpu.simbatch import history_sha as ref_history_sha
from jepsen_etcd_tpu_torch import tel_cli
from jepsen_etcd_tpu_torch.runner.campaign import campaign_specs
from jepsen_etcd_tpu_torch.runner.guided import (IMPORT_HALF_LIFE_GENS,
                                                 PARAM_POOLS,
                                                 GuidedScheduler,
                                                 run_guided)
from jepsen_etcd_tpu_torch.runner.shrink import (checker_opts_from,
                                                 replay_artifact,
                                                 shrink_run)
from jepsen_etcd_tpu_torch.simbatch import (BatchConfig, default_schedule,
                                            generate, history_sha)
from test_torch_fixtures import one_torch_thread  # noqa: F401

#: the quarry (the reference test's): epoch-v2 sim runs with the seeded
#: stale-read bug, which fires only inside open partition windows when
#: nemeses are configured
BASE = {"workload": "register", "nodes": ["n1", "n2", "n3"],
        "concurrency": 6, "rate": 100.0, "time_limit": 1.0,
        "inject_stale_reads": True, "gen_epoch": "epoch-v2"}
CELLS = [["kill"], ["pause"], ["latency"], ["member"], ["partition"]]
PORT_BASE = dict(BASE, device="cpu")


def _check(opts: dict, seed: int, nem_schedules=None) -> dict:
    from jepsen_etcd_tpu_torch.workloads import workloads
    cfg = BatchConfig.from_opts(opts)
    copts = checker_opts_from(opts)
    checker = workloads()[cfg.workload](
        dict(copts, device="cpu"))["checker"]
    g = generate(cfg, [seed], nem_schedules=nem_schedules)
    return checker.check(dict(copts), g["histories"][0])


def no_device(x):
    """``x`` with every ``device`` key of an opts dict dropped."""
    if isinstance(x, dict):
        return {k: no_device(v) for k, v in x.items() if k != "device"}
    if isinstance(x, list):
        return [no_device(v) for v in x]
    return x


def schedulers(**kw) -> tuple:
    return (GuidedScheduler(PORT_BASE, ["register"], CELLS, **kw),
            ref_guided.GuidedScheduler(BASE, ["register"], CELLS, **kw))


def test_explicit_schedule_replays_drawn_plan_bit_identically():
    opts = dict(BASE, nemesis=["partition"], seed=12)
    cfg, ref_cfg = BatchConfig.from_opts(opts), RefBatchConfig.from_opts(opts)
    for seed in (7, 12, 31):
        sched = default_schedule(cfg, seed)
        assert [list(w) for w in sched] == \
            [list(w) for w in ref_default_schedule(ref_cfg, seed)]
        sha = history_sha(generate(cfg, [seed])["histories"][0])
        assert sha == ref_history_sha(
            ref_generate(ref_cfg, [seed])["histories"][0])
        explicit = generate(cfg, [seed], nem_schedules=[sched])
        pop = generate(cfg, [seed] * 4, nem_schedules=[sched] * 4)
        assert history_sha(explicit["histories"][0]) == sha
        assert all(history_sha(h) == sha for h in pop["histories"])


def test_scheduler_stream_equals_the_references():
    """The same master seed gives the reference's candidate stream,
    window and knob mutations of a shared corpus ancestor included."""
    streams = []
    for s in schedulers(seed0=7, master_seed=7):
        s.corpus.append({"opts": dict(BASE, nemesis=["partition"],
                                      seed=99),
                         "seed": 99, "run": 1, "score": 4,
                         "signature": "workload=False",
                         "vector": {"frontier": 1, "rungs": 0,
                                    "spills": 0}})
        streams.append([s.next_generation(4) for _ in range(4)])
    assert json.dumps(no_device(streams[0]), sort_keys=True) == \
        json.dumps(streams[1], sort_keys=True)
    gen0 = streams[0][0] + streams[0][1]
    assert [tuple(o["nemesis"]) for o in gen0[:len(CELLS)]] == \
        [tuple(c) for c in CELLS]


def test_scoring_ignores_harness_noise():
    err_row = {"status": "error", "workload": "register",
               "nemesis": ["kill"], "seed": 1}
    ok_row = {"status": "done", "valid": True, "workload": "register",
              "nemesis": ["kill"], "seed": 2}
    scores = []
    for s in schedulers(seed0=0):
        scores.append((
            s.observe(dict(BASE), err_row, None),
            s.observe(dict(BASE), err_row,
                      {"frontier": 99, "signature": "x=False"}),
            s.observe(dict(BASE), ok_row, {"frontier": 3, "rungs": 0,
                                           "spills": 0,
                                           "signature": ""}),
            len(s.corpus)))
    assert scores[0] == scores[1]
    assert scores[0][:2] == (0, 0) and scores[0][2] > 0
    assert scores[0][3] == 1


def test_corpus_export_import_roundtrip():
    row = {"status": "done", "valid": False, "workload": "register",
           "nemesis": ["kill"], "seed": 2}
    vec = {"frontier": 3, "waves": 2, "rungs": 1, "spills": 0,
           "signature": "workload=False"}
    exports = []
    for s in schedulers(seed0=7, master_seed=7):
        assert s.observe(dict(BASE, nemesis=["kill"]), row, dict(vec)) > 0
        exports.append(json.loads(json.dumps(s.export_corpus())))
    assert exports[0] == exports[1]
    assert exports[0]["kind"] == "guided-corpus"
    s2, r2 = schedulers(seed0=7, master_seed=11)
    assert s2.import_corpus(exports[0]) == r2.import_corpus(exports[1]) == 1
    assert s2.envelope == r2.envelope
    assert s2.corpus == r2.corpus and s2.corpus[0]["imported"]
    assert s2.next_seed == r2.next_seed
    assert s2.observe(dict(BASE, nemesis=["kill"]), dict(row, seed=3),
                      dict(vec)) == 0
    with pytest.raises(ValueError):
        s2.import_corpus({"kind": "something-else"})


def _corpus_entry(run, score, **extra):
    return dict({"opts": dict(BASE, nemesis=["kill"], seed=run),
                 "seed": run, "run": run, "score": score,
                 "signature": "", "vector": {}}, **extra)


@pytest.mark.parametrize("case", ["age", "retire", "recover", "evict"])
def test_corpus_ageing_equals_the_references(case):
    """Imported ancestors decay, retire after a grace generation,
    recover, and lose the cap to fresher natives exactly as the
    reference's do."""
    states = []
    for s in schedulers(seed0=0, master_seed=5):
        imp = _corpus_entry(1, 8.0 if case == "evict" else 1.5,
                            imported=True, born=0)
        if case == "evict":
            s.corpus_cap = 2
            s.corpus[:] = [imp]
            for _ in range(2 * IMPORT_HALF_LIFE_GENS):
                s.next_generation(1)
            s.corpus.extend([_corpus_entry(2, 4.0),
                             _corpus_entry(3, 3.0)])
            s._evict()
        else:
            nat = _corpus_entry(2, 1.0 if case == "age" else 0.5)
            s.corpus[:] = [imp, nat] if case != "recover" else [imp]
            for _ in range(IMPORT_HALF_LIFE_GENS):
                s.next_generation(1)
            if case == "recover":
                imp["score"] = 8.0
            if case in ("retire", "recover"):
                s.next_generation(1)
        states.append((no_device(s.corpus), s.corpus_retired, s.wave,
                       [s._eff_score(c) for c in s.corpus],
                       s.next_seed))
    assert states[0] == states[1]


def test_import_stamps_born_and_roundtrips_wave_buckets():
    row = {"status": "done", "valid": False, "workload": "register",
           "nemesis": ["kill"], "seed": 2}
    vec = {"frontier": 3, "waves": 2, "rungs": 1, "spills": 0,
           "signature": "workload=False", "wave_hist": {24: 9, 26: 1}}
    out = []
    for s in schedulers(seed0=7, master_seed=7):
        s.observe(dict(BASE, nemesis=["kill"]), row, dict(vec))
        data = json.loads(json.dumps(s.export_corpus()))
        out.append(data["wave_buckets"])
    assert out[0] == out[1] == [24, 26]


def test_wave_hist_buckets_score_search_depth_shape():
    ok = {"status": "done", "valid": True, "workload": "register",
          "nemesis": ["kill"], "seed": 2}
    base_vec = {"frontier": 1, "rungs": 0, "spills": 0}
    scores = []
    for s in schedulers(seed0=0, master_seed=3):
        scores.append([
            s.observe(dict(BASE), ok, dict(base_vec, wave_hist={24: 9})),
            s.observe(dict(BASE), dict(ok, seed=3),
                      dict(base_vec, wave_hist={"24": 2})),
            s.observe(dict(BASE), dict(ok, seed=4),
                      dict(base_vec, wave_hist={26: 1})),
            sorted(s.seen_wave_buckets)])
    assert scores[0] == scores[1]
    assert scores[0][1:] == [0, 1, [24, 26]]


def test_param_mutation_hops_within_pools():
    hops = []
    for s in schedulers(seed0=0, master_seed=3):
        got = []
        for _ in range(64):
            o = dict(BASE, nemesis=["kill"], seed=1)
            before = {k: o.get(k) for k in PARAM_POOLS}
            s._hop_param(o)
            changed = [k for k in PARAM_POOLS if o.get(k) != before[k]]
            assert len(changed) == 1
            assert o[changed[0]] in PARAM_POOLS[changed[0]]
            got.append((changed[0], o[changed[0]]))
        hops.append(got)
    assert hops[0] == hops[1]
    assert len({k for k, _ in hops[0]}) >= 2


def _coverage_runs(tmp_path):
    def fake_run(name, hists):
        rdir = tmp_path / name
        rdir.mkdir(parents=True)
        (rdir / "results.json").write_text(json.dumps(
            {"valid?": True,
             "telemetry": {"counters": {"wgl.max-frontier": 2},
                           "hists": hists}}))

    fake_run("0001", {"wgl.rung_waves": {"buckets": {"24": 5, "26": 1}}})
    fake_run("0002", {"wgl.rung_waves": {"buckets": {"24": 2}}})
    fake_run("0003", {})


def test_coverage_surfaces_wave_histogram(tmp_path):
    _coverage_runs(tmp_path)
    out = tel_cli.coverage(str(tmp_path))
    assert out == ref_tel.coverage(str(tmp_path))
    assert out["aggregate"]["wave_hist"] == {24: 7, 26: 1}


def test_coverage_tolerates_stranded_campaign_rows(tmp_path):
    cdir = tmp_path / "camp" / "0001"
    done_dir = cdir / "run0"
    done_dir.mkdir(parents=True)
    (done_dir / "results.json").write_text(json.dumps(
        {"valid?": True,
         "telemetry": {"counters": {"wgl.max-frontier": 3}}}))
    rows = [{"index": 0, "status": "done", "valid": True,
             "dir": str(done_dir), "host": "hostA"},
            {"index": 1, "status": "error", "host": "hostB"},
            {"index": 2, "status": "done", "valid": False,
             "dir": str(cdir / "gone"), "host": "hostB"}]
    (cdir / "campaign.json").write_text(json.dumps(
        {"name": "camp", "runs": rows}))
    out = tel_cli.coverage(str(cdir))
    assert out == ref_tel.coverage(str(cdir))
    agg = out["aggregate"]
    assert agg["rows"] == 3 and agg["skipped"] == 2
    assert agg["hosts"]["hostB"] == {"runs": 2, "invalid": 1, "errors": 1}


def _shrink_view(art: dict) -> dict:
    return {k: v for k, v in art.items() if k != "repro"}


def test_shrink_minimizes_schedule_and_replays(tmp_path):
    """The shrinker on a failing (config, seed): the same artifact as
    the reference's, bytes of ``shrink.json`` aside from the repro's
    package name, and it replays to the same signature."""
    opts = dict(BASE, nemesis=["partition"], seed=12)
    assert _check(opts, 12).get("valid?") is False
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    art = shrink_run(dict(opts, device="cpu"), 12,
                     store_dir=str(tmp_path / "p"), device="cpu")
    want = ref_shrink.shrink_run(opts, 12, store_dir=str(tmp_path / "r"))
    assert _shrink_view(art) == _shrink_view(want)
    assert art["original_windows"] == 4
    assert art["windows"] < art["original_windows"]
    assert art["nemesis_ops"] < 10 and art["executions"] <= 40
    path = str(tmp_path / "p" / "shrink.json")
    assert art["repro"] == f"python -m jepsen_etcd_tpu_torch replay {path}"
    with open(path) as f:
        got_bytes = f.read()
    with open(tmp_path / "r" / "shrink.json") as f:
        want_bytes = f.read()
    assert got_bytes == want_bytes.replace(
        want["repro"], art["repro"])
    rep = replay_artifact(path, device="cpu")
    assert rep == ref_shrink.replay_artifact(
        str(tmp_path / "r" / "shrink.json"))
    assert rep["match"] is True and rep["signature"] == art["signature"]
    assert shrink_run(dict(BASE, nemesis=[], device="cpu"), 12,
                      store_dir=str(tmp_path / "none"),
                      device="cpu") is None


def _guided_view(out: dict) -> dict:
    view = {k: out[k] for k in ("budget", "runs", "generations", "seed0",
                                "master_seed", "workloads", "nemeses",
                                "signatures", "envelope",
                                "first_failure_run", "corpus_imported",
                                "corpus_retired")}
    view["corpus"] = no_device(out["corpus"])
    view["ledger"] = [{k: v for k, v in row.items() if k != "dir"}
                      for row in out["ledger"]]
    view["minimized"] = [{k: v for k, v in m.items()
                          if k not in ("dir", "repro")}
                         for m in out["minimized"]]
    view["counters"] = {k: v for k, v in
                        out["telemetry"]["counters"].items()
                        if k.startswith("guided.")}
    return view


def test_guided_finds_seeded_bug_as_the_reference_does(tmp_path):
    """The reference's acceptance run, on both packages: the uniform
    sweep fails first at run 25; the guided search, budget 12, fails by
    run 12 at the reference's run, with the reference's ledger,
    signatures, corpus and minimized repro, whose ``shrink.json``
    replays through ``cli replay --device cpu``; ``tel --corpus`` reads
    the same summary."""
    from jepsen_etcd_tpu_torch import cli
    specs = campaign_specs(PORT_BASE, ["register"], CELLS,
                           runs_per_cell=6, seed0=7)
    uniform_first = next(i + 1 for i, s in enumerate(specs)
                         if _check(s["opts"], s["opts"]["seed"]).get(
                             "valid?") is not True)
    assert uniform_first == 25

    corpus_out = str(tmp_path / "corpus.json")
    out = run_guided(PORT_BASE, ["register"], CELLS, budget=12, seed0=7,
                     pool=0, service=False, live=False,
                     store_base=str(tmp_path / "p"), name="hunt",
                     corpus_out=corpus_out)
    want = ref_guided.run_guided(BASE, ["register"], CELLS, budget=12,
                                 seed0=7, pool=0, service=False,
                                 live=False, store_base=str(tmp_path / "r"),
                                 name="hunt",
                                 corpus_out=str(tmp_path / "rc.json"))
    assert _guided_view(out) == _guided_view(want)
    ff = out["first_failure_run"]
    assert ff is not None and ff <= uniform_first // 2
    assert not out["telemetry"]["counters"].get("guided.errors")
    with open(corpus_out) as f, open(tmp_path / "rc.json") as g:
        assert no_device(json.load(f)) == json.load(g)

    assert out["minimized"], "no minimized repro was produced"
    m = out["minimized"][0]
    assert m["nemesis_ops"] < 10
    art_path = os.path.join(m["dir"], "shrink.json")
    assert m["repro"] == f"python -m jepsen_etcd_tpu_torch replay {art_path}"
    with open(art_path) as f:
        art = json.load(f)
    with open(os.path.join(want["minimized"][0]["dir"],
                           "shrink.json")) as f:
        ref_art = json.load(f)
    assert _shrink_view(art) == _shrink_view(ref_art)
    assert cli.main(["replay", art_path, "--device", "cpu"]) == 0

    got = tel_cli.corpus(str(tmp_path / "p"))
    assert got["first_failure_run"] == ff
    assert got["minimized"][0]["nemesis_ops"] == m["nemesis_ops"]
    assert _guided_view(got) == _guided_view(out)
