"""Run-level services of the port. Only ``telemetry`` is here so far
(the reference's ``runner/telemetry.py``, unchanged); the simulator,
interpreter and campaign runner that the reference's ``runner/`` also
holds are not ported yet."""
