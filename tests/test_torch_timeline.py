"""Twin of the reference's ``tests/test_timeline.py`` on the port's
``checkers/timeline.py`` (a byte-identical copy): the positioned
timeline's boxes, bands, hover detail and escaping, each document
byte-equal to the reference's on the same history, and a simulated lock
run under kill faults whose ``timeline.html`` is the reference run's
(``run_test_both``)."""

import os
import re

from jepsen_etcd_tpu.checkers.timeline import TimelineHtml as RefTimelineHtml
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu_torch.checkers.timeline import TimelineHtml
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.core.op import Op
from test_torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_fixtures import run_test_both

SECOND = 1_000_000_000


def H(*ops):
    return History([Op(o) for o in ops])


def ev(typ, p, f, v, t_s):
    return {"type": typ, "process": p, "f": f, "value": v,
            "time": int(t_s * SECOND)}


def overlapping_history():
    return H(
        ev("invoke", 0, "write", 1, 0.0),
        ev("invoke", "nemesis", "kill", None, 0.5),
        ev("invoke", 1, "read", None, 1.0),
        ev("invoke", 2, "write", "<x>", 1.5),
        ev("ok", 0, "write", 1, 2.0),
        ev("info", "nemesis", "kill", None, 2.5),
        ev("ok", 1, "read", 1, 3.0),
    )


def render(test, h, **kw) -> str:
    """The port's document, byte-equal to the reference's."""
    doc = TimelineHtml(**kw).render(test, h)
    assert doc == RefTimelineHtml(**kw).render(
        test, RefHistory.from_jsonl(h.to_jsonl()))
    return doc


def boxes(doc):
    """[(left_px, top_px, height_px, is_open)] for every op box."""
    out = []
    for m in re.finditer(
            r"class='op( open)?' style='left:(\d+)px;top:(\d+)px;"
            r"height:(\d+)px", doc):
        out.append((int(m.group(2)), int(m.group(3)), int(m.group(4)),
                    bool(m.group(1))))
    return out


def test_positioned_boxes_and_overlap():
    doc = render({"name": "t"}, overlapping_history())
    bs = boxes(doc)
    assert len(bs) == 3
    assert doc.count("class='colhead'") == 3
    lefts = {b[0] for b in bs}
    assert len(lefts) == 3
    (l0, t0, h0, _), (l1, t1, h1, _) = bs[0], bs[1]
    assert l0 != l1
    assert t0 < t1 + h1 and t1 < t0 + h0
    assert h0 > 10 and h1 > 10


def test_open_op_rendered_dashed_to_end():
    doc = render({"name": "t"}, overlapping_history())
    bs = boxes(doc)
    open_boxes = [b for b in bs if b[3]]
    assert len(open_boxes) == 1
    assert open_boxes[0][2] >= bs[0][2] // 2
    assert "never completed" in doc


def test_nemesis_band_and_hover_detail():
    doc = render({"name": "t"}, overlapping_history(), nemesis_perf=[
        {"name": "kills", "color": "#E9A4A4", "fs": ["kill"]},
    ])
    band = re.search(r"class='band' style='top:(\d+)px;"
                     r"height:(\d+)px;background:(#\w+)'", doc)
    assert band, "nemesis band missing"
    assert band.group(3) == "#E9A4A4"
    assert int(band.group(2)) > 10
    assert "class='bandlabel'" in doc and ">kill</div>" in doc
    assert "process 0" in doc
    assert re.search(r"title='[^']*2\.0000s\] ok \(2000\.0 ms\)", doc)


def test_axis_ticks_and_meta():
    doc = render({"name": "t"}, overlapping_history())
    assert doc.count("class='tick'") >= 4
    assert doc.count("class='grid'") >= 4
    assert "3 ops" in doc and "3 processes" in doc


def test_html_escaping():
    h = H(ev("invoke", 0, "write", "<x>", 0.0),
          ev("ok", 0, "write", "<x>", 1.0))
    doc = render({"name": "<script>alert(1)</script>"}, h)
    assert "<script>" not in doc
    assert "&lt;script&gt;" in doc
    assert "<x>" not in doc
    assert "&lt;x&gt;" in doc


def test_check_writes_file(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    res = TimelineHtml().check({"name": "t"}, overlapping_history(),
                               {"store_dir": str(tmp_path / "p")})
    ref = RefTimelineHtml().check(
        {"name": "t"},
        RefHistory.from_jsonl(overlapping_history().to_jsonl()),
        {"store_dir": str(tmp_path / "r")})
    assert res["valid?"] is True
    assert os.path.exists(res["file"])
    with open(res["file"]) as f, open(ref["file"]) as g:
        doc = f.read()
        assert doc == g.read()
    assert "class='op'" in doc
    assert os.path.relpath(res["file"], tmp_path / "p") == \
        os.path.relpath(ref["file"], tmp_path / "r")
    assert TimelineHtml().check({}, overlapping_history()) == \
        {"valid?": True}


def test_sim_lock_run_timeline(tmp_path):
    """A lock run under kill faults gives a timeline whose blocked
    acquires are positioned boxes and whose fault windows are bands,
    byte-equal to the reference run's."""
    out, _, _, _ = run_test_both(tmp_path, {
        "workload": "lock", "nemesis": ["kill"], "nemesis_interval": 2.0,
        "time_limit": 6, "rate": 30, "seed": 3})
    path = os.path.join(out["dir"], "timeline.html")
    assert os.path.exists(path)
    with open(path) as f:
        doc = f.read()
    bs = boxes(doc)
    assert len(bs) >= 4
    assert len({b[0] for b in bs}) >= 2
    assert len({b[1] for b in bs}) >= 2
    assert "class='band'" in doc
    assert "acquire" in doc
