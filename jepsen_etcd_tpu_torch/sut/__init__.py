from .errors import SimError, ERROR_TYPES
from .store import Store, Txn, cmp, get_op, put_op, del_op, range_op, Event
from .cluster import Cluster, ClusterConfig

__all__ = [
    "SimError", "ERROR_TYPES", "Store", "Txn", "cmp", "get_op", "put_op",
    "del_op", "range_op", "Event", "Cluster", "ClusterConfig",
]
