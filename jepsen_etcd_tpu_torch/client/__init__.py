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
        # live-etcd mode (etcd.clj:246-257 drives a real cluster). With
        # the local control plane (--db local) the node is a NAME and
        # the control plane owns the name -> client URL mapping; in live
        # mode the node IS its endpoint URL
        endpoint = node
        if isinstance(test, dict) and test.get("db_mode") == "local":
            endpoint = test["db"].client_url(node)
        if ctype == "http":
            from .etcd_http import HttpEtcdClient
            c = HttpEtcdClient(endpoint)
        else:
            # native gRPC — the reference's wire protocol (jetcd,
            # client.clj:14-68)
            from .etcd_grpc import GrpcEtcdClient
            c = GrpcEtcdClient(endpoint)
        c.node = node  # histories and per-node stats keyed by name
        return c
    cluster = test["cluster"]
    if ctype == "direct":
        return DirectClient(cluster, node)
    if ctype == "etcdctl":
        return EtcdctlClient(cluster, node)
    raise ValueError(f"unknown client type {ctype!r}")
