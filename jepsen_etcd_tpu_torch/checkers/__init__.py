from .core import Checker
from .linearizable import check_history
from .tpu_linearizable import TPULinearizableChecker
from .watch import WatchChecker

__all__ = ["Checker", "check_history", "TPULinearizableChecker",
           "WatchChecker"]
