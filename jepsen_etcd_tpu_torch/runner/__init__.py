"""Run-level machinery of the port: ``sim`` (the virtual-time
coroutine kernel), ``interpreter`` and ``test_runner`` (the ``test``
entry point on the simulated cluster), ``store`` / ``store_index`` /
``trace`` (run artifacts), ``telemetry`` (the reference's file,
unchanged), ``stream`` (the streaming check feed and the fused
gen->check pipeline), ``transport`` (the framed sockets),
``checker_service`` (one process checking every run's packed histories
on the card), ``campaign`` (the matrix over a pool of worker processes
or ``host_agent`` processes, with one service), ``guided`` (the
coverage-guided search) and ``shrink`` (its delta-debugged repros and
their replay)."""

from .sim import (
    SimLoop, Task, Future, Event, Queue, sleep, current_loop, Cancelled,
    wait_for, gather,
)

__all__ = [
    "SimLoop", "Task", "Future", "Event", "Queue", "sleep", "current_loop",
    "Cancelled", "wait_for", "gather",
]
