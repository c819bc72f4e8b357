from .core import (Checker, Compose, compose, Stats, UnhandledExceptions,
                   LogFilePattern, ClockPlot, Noop)
from .independent import Independent, independent_checker
from .linearizable import check_history
from .perf import Perf
from .session import SessionGuarantees, session_guarantees
from .timeline import TimelineHtml
from .tpu_linearizable import TPULinearizableChecker
from .watch import WatchChecker

__all__ = [
    "Checker", "Compose", "compose", "Stats", "UnhandledExceptions",
    "LogFilePattern", "ClockPlot", "Noop", "Independent",
    "independent_checker", "check_history", "Perf", "SessionGuarantees",
    "session_guarantees", "TimelineHtml", "TPULinearizableChecker",
    "WatchChecker",
]
