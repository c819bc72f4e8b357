"""The direct (in-process gRPC analog) client backend."""

from __future__ import annotations

from .base import Client
from ..sut.store import Txn


class DirectClient(Client):
    """Speaks to the simulated cluster natively — the jetcd-analog backend
    (client.clj:723-750 implements the txn seam over jetcd)."""

    async def _txn_rpc(self, txn: Txn) -> dict:
        return await self._call(self.cluster.kv_txn(self.node, txn))
