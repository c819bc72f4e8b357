"""Device resolution for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when CUDA is asked for (explicitly or by
    default) and no card is present — the port never quietly moves a
    check to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return dev


@contextlib.contextmanager
def lane_stream(dev: torch.device):
    """Run the block on a CUDA stream of its own on ``dev`` (made the
    thread's current device), so that lanes sharing one card overlap
    and never queue work on its default stream; a no-op on the CPU.
    Yields the stream (None on the CPU)."""
    if dev.type != "cuda":
        yield None
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.Stream(device=dev)
        with torch.cuda.stream(stream):
            yield stream
