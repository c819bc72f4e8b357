from .core import (
    Context, ensure_gen, Generator, PENDING,
    once, repeat, seq, fn_gen, mix, limit, stagger, delay, sleep_gen,
    time_limit, phases, log, reserve, clients, nemesis, on_threads,
    each_thread, any_gen, cycle, synchronize, f_map,
)
from . import independent

__all__ = [
    "Context", "ensure_gen", "Generator", "PENDING",
    "once", "repeat", "seq", "fn_gen", "mix", "limit", "stagger", "delay",
    "sleep_gen", "time_limit", "phases", "log", "reserve", "clients",
    "nemesis", "on_threads", "each_thread", "any_gen", "cycle",
    "synchronize", "f_map", "independent",
]
