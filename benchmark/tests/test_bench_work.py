"""The wave search's work, counted from histories by hand."""

from __future__ import annotations

from benchmark.metrics import wgl_wave_roofline as roof

C = roof.OPS_PER_CANDIDATE
B = roof.BYTES_PER_OP


def op(t, p, f="write", v=None, **kw):
    return {"type": t, "process": p, "f": f, "value": v, **kw}


def test_sequential_ops_have_a_window_of_one():
    ops = [op("invoke", 0), op("ok", 0, v=[1, 1]),
           op("invoke", 0, "read"), op("ok", 0, "read", [1, 1]),
           op("invoke", 1), op("ok", 1, v=[2, 0])]
    assert roof.work(ops) == (3 * 1 * C, 3 * B)


def test_overlapping_ops_widen_the_window():
    # p0 [1, 4], p1 [2, 3], p2 [5, 6]: two ops overlap at most
    ops = [op("invoke", 0), op("invoke", 1), op("ok", 1, v=[1, 2]),
           op("ok", 0, v=[2, 1]), op("invoke", 2, "read"),
           op("ok", 2, "read", [2, 1])]
    assert roof.work(ops) == (3 * 2 * C, 3 * B)


def test_fails_drop_out_and_infos_stay_open():
    # p0's cas fails (no entry); p1's write is :info (open to the end,
    # it may linearize but need not): one op to linearize, window 2
    ops = [op("invoke", 0, "cas", [None, [1, 2]]),
           op("fail", 0, "cas", [None, [1, 2]], error="did-not-succeed"),
           op("invoke", 1, v=[None, 3]),
           op("info", 1, v=[None, 3], error="timeout"),
           op("invoke", 2, "read"), op("ok", 2, "read", [0, None]),
           op("invoke", "nemesis", "kill"), op("info", "nemesis", "kill")]
    assert roof.work(ops) == (1 * 2 * C, 2 * B)


def test_a_refuted_key_needs_one_wave_past_its_deepest():
    ops = []
    for p in range(4):
        ops += [op("invoke", p), op("ok", p, v=[p + 1, p])]
    assert roof.work(ops) == (4 * 1 * C, 4 * B)
    assert roof.work(ops, depth=1) == (2 * 1 * C, 4 * B)
    assert roof.work(ops, depth=9) == (4 * 1 * C, 4 * B)


def test_the_ladder_reads_ms_per_op_of_the_info_keys():
    """``ladder_ms_per_op``'s denominator is counted from the histories:
    the ops that the keys holding an :info op must linearize, whatever
    waves the program reports."""
    from benchmark.lib.context import Checked, Context
    from benchmark.metrics import ladder_ms_per_op as ladder

    class Key:
        def __init__(self, name, ops):
            self.name, self.ops = name, ops

        def __len__(self):
            return len(self.ops)

    clean = Key("c", [op("invoke", 0), op("ok", 0, v=[1, 1])])
    faulted = Key("f", [op("invoke", 0), op("ok", 0, v=[1, 1]),
                        op("invoke", 1, v=[None, 2]),
                        op("info", 1, v=[None, 2], error="timeout"),
                        op("invoke", 2, "read"),
                        op("ok", 2, "read", [1, 1])])
    exp = {"linear": True, "depth": 2}
    h = Checked([clean, faulted], 0.0, 1.0, 2.0, None, None)
    h.exp = [exp, exp]
    spans = [("wgl.batch-dispatch", 1.1, 1.3),
             ("wgl.check_packed", 1.2, 1.5)]
    ctx = Context(1.0, 2.0, [h], spans=spans)
    # 0.4 s of ladder over the faulted key's two :ok ops
    assert abs(ladder.read(ctx) - 1e3 * 0.4 / 2) < 1e-9
    assert ladder.read(Context(1.0, 2.0, [h], spans=[])) is None
