"""Debug-mode value provenance (``--debug``).

Re-designs ``append.clj:34-54`` / ``wr.clj:18-35``: when the test map has
``debug`` set, every value written to the SUT is wrapped as

    {"time": <virtual seconds>, "dir": <store run dir name>,
     "txn": <the generating op's txn>, "process": <op.process>,
     "value": <the real value>}

so histories are self-describing — a value read back identifies exactly
which run, txn, and process produced it (the reference used this to
track down an etcdctl state-leak across runs, etcd.clj:259-346).
``decode_get`` strips the wrapper on read so checkers see clean values;
the raw responses land on the op's ``debug`` field for the forensics
helpers (jepsen_etcd_tpu_torch.forensics).
"""

from __future__ import annotations

import os
from typing import Any

from ..core.op import Op
from ..runner.sim import current_loop, SECOND


def encode_put(test: dict, op: Op, value: Any) -> Any:
    """Wrap a to-be-written value with provenance in debug mode
    (append.clj:34-45, wr.clj:18-27)."""
    if not test.get("debug"):
        return value
    store_dir = test.get("store_dir", "")
    return {
        "time": current_loop().now / SECOND,
        "dir": os.path.basename(os.path.dirname(store_dir)) + "/"
               + os.path.basename(store_dir) if store_dir else "",
        "txn": list(op.value) if isinstance(op.value, (list, tuple))
               else op.value,
        "process": op.get("process"),
        "value": value,
    }


def decode_get(test: dict, value: Any) -> Any:
    """Strip the provenance wrapper from a read value
    (append.clj:47-54, wr.clj:29-35)."""
    if test.get("debug") and isinstance(value, dict) and "value" in value:
        return value["value"]
    return value


def attach_debug(test: dict, op: Op, **responses) -> Op:
    """In debug mode, record raw phase responses on the op's ``debug``
    field (the reference keeps :debug {:read-res ... :txn-res ...} on
    append/wr ops; forensics reads them back, etcd.clj:302-336)."""
    if not test.get("debug"):
        return op
    return op.evolve(debug={k.replace("_", "-"): v
                            for k, v in responses.items()})
