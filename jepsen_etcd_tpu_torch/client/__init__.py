from . import txn
from .errors import with_errors, client_error
from .base import Client, TIMEOUT
from .direct import DirectClient
from .etcdctl import EtcdctlClient

__all__ = ["txn", "with_errors", "client_error", "Client", "TIMEOUT",
           "DirectClient", "EtcdctlClient"]


def client(test, node: str):
    """Construct a client for a node, dispatching on test['client_type']
    (mirrors the reference constructor dispatch, client.clj:210-222)."""
    ctype = (test.get("client_type") or "direct") if isinstance(test, dict) \
        else "direct"
    if ctype in ("http", "grpc"):
        # the live-etcd clients (etcd.clj:246-257 drives a real cluster)
        # come with the port's live side
        raise ValueError(
            f"client type {ctype!r} drives real etcd, which the port "
            "does not run yet (ROADMAP A item 8); use 'direct' or "
            "'etcdctl' against the simulated cluster")
    cluster = test["cluster"]
    if ctype == "direct":
        return DirectClient(cluster, node)
    if ctype == "etcdctl":
        return EtcdctlClient(cluster, node)
    raise ValueError(f"unknown client type {ctype!r}")
