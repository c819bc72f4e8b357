"""Userspace network fault plane for `--db local`.

A per-link TCP proxy fleet (proxy.py) fronted by one NetPlane
controller (plane.py): every peer->peer and client->node URL in local
mode routes through a proxy, so partitions, one-way drops, latency,
bandwidth caps, and slow-close become plain userspace socket policy —
no netns/iptables privileges needed.
"""

from .plane import NetPlane
from .proxy import LinkProxy, Rule

__all__ = ["NetPlane", "LinkProxy", "Rule"]
