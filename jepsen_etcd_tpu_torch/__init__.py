"""PyTorch/CUDA port of jepsen_etcd_tpu: register linearizability (the
wave kernel, the capacity ladder and the spill BFS), the watch checker
(the edit-distance wavefront), Elle (the boolean closure), the batched
simulator, the checker service, the ``test`` command on the simulated
cluster (``python -m jepsen_etcd_tpu_torch test ...``) and the campaign
runner (``campaign``, with guided search, shrink and ``replay``, host
agents and the ``tel`` command).

The JAX package ``jepsen_etcd_tpu`` is the reference; this package keeps
its module layout (``core/``, ``models/``, ``checkers/``, ``ops/``,
``runner/``, ...) so each counterpart sits at the same relative path. It
imports torch and numpy, never jax, and nothing of the JAX package.

Entry points take an explicit ``device`` and default to ``cuda``: with
no card present they raise unless the caller passes ``device="cpu"``,
where every hand-written kernel is replaced by its plain PyTorch
version. See ``device.resolve_device``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
