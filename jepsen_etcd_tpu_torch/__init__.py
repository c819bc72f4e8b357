"""PyTorch/CUDA port of jepsen_etcd_tpu: register linearizability (the
wave kernel, the capacity ladder and the spill BFS), the watch checker
(the edit-distance wavefront), Elle (the boolean closure), the batched
simulator, the checker service, the ``test`` command on the simulated
cluster (``python -m jepsen_etcd_tpu_torch test ...``), the campaign
runner (``campaign``, with guided search, shrink and ``replay``, host
agents and the ``tel`` command) and the live side: the etcd HTTP and
gRPC clients against an external cluster (``--db live``) or local
processes (``--db local``, with the fake-etcd stub and the proxy
plane), soak windows and the ``gateway`` command.

The JAX package ``jepsen_etcd_tpu`` is the reference; this package keeps
its module layout (``core/``, ``models/``, ``checkers/``, ``ops/``,
``runner/``, ...) so each counterpart sits at the same relative path. It
imports torch and numpy, never jax, and nothing of the JAX package.

Entry points take an explicit ``device`` and default to ``cuda``: with
no card present they raise unless the caller passes ``device="cpu"``,
where every hand-written kernel is replaced by its plain PyTorch
version. See ``device.resolve_device``, which this module resolves
on first use: importing a submodule that needs no torch (a spawned
fake-etcd node, the gateways) does not import it.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
