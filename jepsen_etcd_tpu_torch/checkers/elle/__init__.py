"""Elle-analog transactional anomaly checkers (the port of the
reference's ``checkers/elle/``).

The reference consumes the Elle library through ``append/test``
(append.clj:183-185) and ``wr/test`` (wr.clj:87-92); these modules
re-derive the two checkers — list-append and rw-register — with the
dependency-graph cycle search running as a batched boolean-matmul
transitive closure on the card (ops/closure.py).
"""

from .append import ListAppendChecker
from .wr import RWRegisterChecker

__all__ = ["ListAppendChecker", "RWRegisterChecker"]
