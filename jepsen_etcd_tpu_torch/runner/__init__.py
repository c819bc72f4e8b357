"""Run-level machinery of the port: ``sim`` (the virtual-time
coroutine kernel), ``interpreter`` and ``test_runner`` (the ``test``
entry point: the simulated cluster, live clusters and soak windows),
``store`` / ``store_index`` /
``trace`` (run artifacts), ``telemetry`` (the reference's file,
unchanged), ``stream`` (the streaming check feed and the fused
gen->check pipeline), ``transport`` (the framed sockets),
``checker_service`` (one process checking every run's packed histories
on the card), ``campaign`` (the matrix over a pool of worker processes
or ``host_agent`` processes, with one service), ``guided`` (the
coverage-guided search), ``shrink`` (its delta-debugged repros and
their replay) and ``wall`` (the loop's wall-clock twin, for live
runs)."""

from .sim import (
    SimLoop, Task, Future, Event, Queue, sleep, current_loop, Cancelled,
    wait_for, gather,
)

__all__ = [
    "SimLoop", "Task", "Future", "Event", "Queue", "sleep", "current_loop",
    "Cancelled", "wait_for", "gather",
]
