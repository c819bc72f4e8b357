from .etcd import Db, db

__all__ = ["Db", "db"]
