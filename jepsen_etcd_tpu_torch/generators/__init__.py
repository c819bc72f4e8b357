"""Generators (the port's subset: the per-key history split of
``independent``; the generators themselves come with the simulator)."""
