from .core import Checker
from .linearizable import check_history
from .tpu_linearizable import TPULinearizableChecker

__all__ = ["Checker", "check_history", "TPULinearizableChecker"]
