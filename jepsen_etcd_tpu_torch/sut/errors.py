"""Error taxonomy for the simulated SUT.

Mirrors the reference's remap-errors classification
(``client.clj:279-379``): every failure a client can see carries a ``type``
keyword and a ``definite`` flag. Definite errors mean the op certainly did
not happen (checker may treat as :fail); indefinite means unknown (:info).

The type names below preserve the reference's taxonomy keywords so
workload `with_errors` handling (client/errors.py) matches call-site
behavior one-for-one.
"""

from __future__ import annotations


# type -> definite?   (cf. client.clj lines noted)
ERROR_TYPES: dict[str, bool] = {
    "timeout": False,                    # await timeout, client.clj:244-252
    "unavailable": False,                # gRPC UNAVAILABLE, :298-300
    "leader-changed": False,             # :319-320
    "raft-stopped": True,                # "raft: stopped", :322-323
    "not-leader": True,                  # forwarded to dead leader
    "compacted": True,                   # CompactedException, :287-288
    "key-not-found": True,
    "duplicate-key": True,
    "invalid-auth-token": True,
    "too-many-requests": False,          # etcd server overloaded
    "member-not-found": True,
    "unhealthy-cluster": True,           # add-member safety check
    "request-too-large": True,
    "no-leader": False,                  # no leader reachable (election)
    "lease-not-found": True,
    "not-held": True,                    # unlock of a lock we don't hold
    "closed-client": True,
    "connect-failed": False,             # node down at dial time; jetcd
                                         # retries => indefinite by 5s timeout
    "paused": False,                     # SIGSTOP'd node: hangs -> timeout
    "nonmonotonic-watch": True,          # watch.clj:161-177 definite throw
    "corrupt": True,                     # corruption alarm / refuse to serve
    "task-leak": True,                   # sshj thread-leak analog,
                                         # support.clj:57-72
    "crash-loop": True,                  # local node died repeatedly
                                         # during startup (db/local.py)
    "unsupported": True,                 # fault not available in this
                                         # db mode (db/live, db/local)
}


class SimError(Exception):
    """An error from the simulated cluster, classified per the taxonomy."""

    def __init__(self, type_: str, msg: str = "", definite: bool | None = None):
        super().__init__(f"{type_}: {msg}" if msg else type_)
        if type_ not in ERROR_TYPES and definite is None:
            raise ValueError(f"unknown SimError type {type_!r}")
        self.type = type_
        self.definite = ERROR_TYPES[type_] if definite is None else definite

    def as_error_value(self):
        return [self.type, str(self)]
