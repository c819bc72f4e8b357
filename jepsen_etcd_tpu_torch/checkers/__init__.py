from .core import (Checker, Compose, compose, Stats, UnhandledExceptions,
                   LogFilePattern, ClockPlot, Noop)
from .independent import Independent, independent_checker
from .linearizable import LinearizableChecker, linearizable, check_history
from .mvcc import (BoundedStaleness, CompactionWatch, LeaseChurn,
                   SnapshotRanges)
from .perf import Perf
from .session import SessionGuarantees, session_guarantees
from .set_full import SetFull, set_full
from .timeline import TimelineHtml
from .tpu_linearizable import TPULinearizableChecker
from .watch import WatchChecker

__all__ = [
    "Checker", "Compose", "compose", "Stats", "UnhandledExceptions",
    "LogFilePattern", "ClockPlot", "Noop", "Independent",
    "independent_checker", "LinearizableChecker", "linearizable",
    "check_history", "BoundedStaleness", "CompactionWatch",
    "LeaseChurn", "SnapshotRanges", "Perf", "SessionGuarantees",
    "session_guarantees", "SetFull", "set_full", "TimelineHtml",
    "TPULinearizableChecker", "WatchChecker",
]
