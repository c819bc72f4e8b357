from .core import Checker, Compose, Stats, compose
from .independent import Independent, independent_checker
from .linearizable import check_history
from .session import SessionGuarantees
from .tpu_linearizable import TPULinearizableChecker
from .watch import WatchChecker

__all__ = ["Checker", "Compose", "Stats", "compose", "Independent",
           "independent_checker", "check_history", "SessionGuarantees",
           "TPULinearizableChecker", "WatchChecker"]
