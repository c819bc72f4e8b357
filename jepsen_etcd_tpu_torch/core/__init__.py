from .op import Op, invoke_op, ok, fail, info, NEMESIS
from .history import History

__all__ = ["Op", "invoke_op", "ok", "fail", "info", "NEMESIS", "History"]
