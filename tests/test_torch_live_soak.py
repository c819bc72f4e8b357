"""The port's soak mode (``run_soak``): sliding windows against one
long-lived fake-etcd node, the shapes of the soak cases of the
reference's tests/test_stream.py. The windows' checks run on the CPU
(``device: "cpu"``)."""

import gc
import weakref

import pytest

from jepsen_etcd_tpu_torch.runner.test_runner import SOAK_KEY_STRIDE, run_soak


@pytest.mark.soak
def test_soak_three_windows_fake_etcd(tmp_path):
    """The soak loop sustains >= 3 windows against one long-lived
    (fake-etcd) cluster — per-window verdicts all True, register key
    space rotated every window, and each window's history RELEASED
    before the next runs (bounded memory)."""
    refs = []

    def on_window(summary, out):
        refs.append(weakref.ref(out["history"]))
        return None

    opts = dict(workload="register", nodes=["n1"],
                client_type="http", db_mode="local",
                etcd_binary="fake", etcd_data_dir=str(tmp_path / "data"),
                # rate 150, not 50: the stats checker reads "unknown"
                # when a window's every cas loses its value-guess
                # lottery, so give each window enough attempts that
                # P(no cas ever succeeds) is negligible
                rate=150, ops_per_key=20, seed=3,
                soak=True, soak_windows=3, soak_window_s=2,
                store_base=str(tmp_path), no_telemetry=True,
                device="cpu")
    out = run_soak(opts, on_window=on_window)
    assert out["count"] == 3
    assert out["valid?"] is True
    assert [w["valid?"] for w in out["windows"]] == [True, True, True]
    assert [w["window"] for w in out["windows"]] == [0, 1, 2]
    offsets = [w["key_offset"] for w in out["windows"]]
    assert offsets == [0, SOAK_KEY_STRIDE, 2 * SOAK_KEY_STRIDE]
    assert all(w["ops"] > 0 for w in out["windows"])
    # bounded memory: every window's history is collectable once the
    # loop moved on (run_soak keeps summaries only)
    out = None
    gc.collect()
    assert len(refs) == 3
    assert all(r() is None for r in refs), \
        "soak retained a window's history"


@pytest.mark.soak
def test_soak_net_fault_schedule_heal_restores_progress(tmp_path):
    """The net plane rides under --soak. Windows cycle [healthy,
    drop:1.0]; the lossy window is held for the WHOLE window on the
    shared proxy plane (total chunk loss: every op times out), and the
    heal between windows restores progress on the SAME retained cluster
    — window 2 succeeds again."""
    ok_counts = []

    def on_window(summary, out):
        ok_counts.append(sum(1 for op in out["history"].ops
                             if op.get("type") == "ok"))
        return None

    opts = dict(workload="register", nodes=["n1"],
                client_type="http", db_mode="local",
                etcd_binary="fake", etcd_data_dir=str(tmp_path / "data"),
                rate=150, ops_per_key=20, seed=3, time_limit=2,
                soak=True, soak_windows=3, soak_window_s=2,
                soak_net_faults=["drop:1.0"],
                store_base=str(tmp_path), no_telemetry=True,
                device="cpu")
    out = run_soak(opts, on_window=on_window)
    assert out["count"] == 3
    faults = [w["soak-fault"] for w in out["windows"]]
    assert faults == [None, "drop:1.0", None]
    # healthy windows make real progress and check clean
    assert out["windows"][0]["valid?"] is True and ok_counts[0] > 0
    assert out["windows"][2]["valid?"] is True and ok_counts[2] > 0
    # the lossy window: the fault bit (nothing completed ok), and it
    # did NOT produce a false violation — it reads unknown/True, and
    # the heal left the retained cluster serving window 2
    assert ok_counts[1] == 0
    assert out["windows"][1]["valid?"] in (True, "unknown")


def test_soak_net_fault_requires_local_db():
    with pytest.raises(ValueError, match="proxy plane"):
        run_soak(dict(workload="register", client_type="http",
                      db_mode="live", soak_windows=1,
                      soak_net_faults=["latency"], device="cpu"))


def test_soak_refuses_sim_clients():
    with pytest.raises(ValueError, match="long-lived live cluster"):
        run_soak(dict(workload="register", client_type="direct",
                      soak_windows=1, device="cpu"))
