from .op import Op, invoke_op, ok, fail, info, NEMESIS
from .history import History, pair_index

__all__ = ["Op", "invoke_op", "ok", "fail", "info", "NEMESIS", "History", "pair_index"]
