"""Twin of the reference's ``tests/test_store_rotation.py`` on the port's
``runner/store.py``: long sweeps must not fill the disk. Each test runs
on both packages (``both``), each under its own base directory, and
what it observes (run ids, the runs removed and kept, the ``latest``
links) is equal, paths taken relative to the base."""

import os

from test_torch_fixtures import both, mod, one_torch_thread  # noqa: F401


def store(pkg):
    return mod(pkg, "runner.store")


def _write_run(st, base, name, kb):
    d = st.make_store_dir(base, name)
    with open(os.path.join(d, "history.jsonl"), "w") as f:
        f.write("x" * (kb * 1024))
    st.link_latest(d)
    return d


def on_base(body, tmp_path):
    """``body(store module, base)`` on both packages, each with its own
    base under ``tmp_path``; outputs are compared relative to it."""
    def run(pkg):
        base = str(tmp_path / pkg)
        os.makedirs(base)
        out = body(store(pkg), base)
        return _rel(out, base)
    return both(run)


def _rel(x, base):
    if isinstance(x, str) and x.startswith(base):
        return os.path.relpath(x, base)
    if isinstance(x, (list, tuple)):
        return [_rel(v, base) for v in x]
    return x


def _tree(base):
    return sorted(os.path.relpath(os.path.join(r, f), base)
                  for r, ds, fs in os.walk(base) for f in fs + ds)


def _removes_oldest(st, base):
    runs = [_write_run(st, base, "t", 10) for _ in range(6)]
    for i, d in enumerate(runs):
        os.utime(d, (1000 + i, 1000 + i))
    removed = st.rotate_store(base, keep_dir=runs[-1], max_bytes=35 * 1024)
    assert removed == runs[:3]
    assert all(not os.path.exists(r) for r in runs[:3])
    assert all(os.path.exists(r) for r in runs[3:])
    return removed, _tree(base)


def test_rotation_removes_oldest_until_under_cap(tmp_path):
    on_base(_removes_oldest, tmp_path)


def _never_current(st, base):
    runs = [_write_run(st, base, "t", 10) for _ in range(3)]
    for i, d in enumerate(runs):
        os.utime(d, (1000 + i, 1000 + i))
    removed = st.rotate_store(base, keep_dir=runs[0], max_bytes=1024)
    assert runs[0] not in removed
    assert os.path.exists(runs[0])
    assert all(not os.path.exists(r) for r in runs[1:])
    return removed, _tree(base)


def test_rotation_never_removes_current_run(tmp_path):
    on_base(_never_current, tmp_path)


def _disabled(st, base):
    runs = [_write_run(st, base, "t", 10) for _ in range(3)]
    assert st.rotate_store(base, max_bytes=0) == []
    assert all(os.path.exists(r) for r in runs)
    return runs, _tree(base)


def test_rotation_disabled_with_zero_cap(tmp_path):
    on_base(_disabled, tmp_path)


def _dangling_latest(st, base):
    old = _write_run(st, base, "t", 10)
    os.utime(old, (1000, 1000))
    new = _write_run(st, base, "u", 10)
    os.utime(new, (2000, 2000))
    removed = st.rotate_store(base, keep_dir=new, max_bytes=12 * 1024)
    assert not os.path.exists(old)
    t_latest = os.path.join(base, "t", "latest")
    assert not os.path.islink(t_latest) or os.path.exists(t_latest)
    assert os.path.exists(os.path.join(base, "u", "latest"))
    return removed, _tree(base), os.path.islink(t_latest)


def test_rotation_unlinks_dangling_latest(tmp_path):
    on_base(_dangling_latest, tmp_path)


def _fresh_id(st, base):
    runs = [_write_run(st, base, "t", 10) for _ in range(6)]
    for i, d in enumerate(runs):
        os.utime(d, (1000 + i, 1000 + i))
    st.rotate_store(base, keep_dir=runs[-1], max_bytes=35 * 1024)
    nxt = st.make_store_dir(base, "t")
    assert os.path.basename(nxt) == "00006"
    assert nxt not in runs
    assert not os.listdir(nxt)
    return nxt, _tree(base)


def test_new_run_after_rotation_never_reuses_surviving_id(tmp_path):
    on_base(_fresh_id, tmp_path)
