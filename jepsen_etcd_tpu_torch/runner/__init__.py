"""Run-level services of the port: ``telemetry`` (the reference's
``runner/telemetry.py``, unchanged), ``stream`` (the fused gen->check
pipeline), ``transport`` (the framed sockets, a copy of the
reference's) and ``checker_service`` (one process checking every run's
packed histories on the card). The simulator, interpreter and campaign
runner that the reference's ``runner/`` also holds are not ported
yet."""
