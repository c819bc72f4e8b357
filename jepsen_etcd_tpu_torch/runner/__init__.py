"""Run-level services of the port: ``telemetry`` (the reference's
``runner/telemetry.py``, unchanged) and ``stream`` (the fused gen->check
pipeline). The simulator, interpreter and campaign runner that the
reference's ``runner/`` also holds are not ported yet."""
