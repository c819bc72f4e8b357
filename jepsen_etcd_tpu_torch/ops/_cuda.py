"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc for sm_90a into a shared library with a
plain C interface under ``jepsen_etcd_tpu_torch/_build/`` (keyed by the
source's hash), at first use, and is loaded with ctypes. Pointers and
the stream pass as ``c_void_p``. A kernel that fails to build or launch
raises: there is no fallback for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (if not built yet) and return the
    path of its shared library."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"{name}_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _lib(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu``, with the argument types
    of its C functions set from ``signatures`` (function -> (restype,
    argtypes)); every library also exports ``<name>_error_string``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            signatures = dict(signatures)
            signatures[f"{name}_error_string"] = (ctypes.c_char_p,
                                                  [ctypes.c_int])
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def _check(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


_P, _I = ctypes.c_void_p, ctypes.c_int
_WGL = {"wgl_wave_launch": (_I, [_P, _P, _P, _I, _I, _I, _P]),
        "wgl_wave_profile": (_I, [_P, _P, _P, _P, _I, _I, _I, _P]),
        "wgl_wave_phases": (_I, []),
        "wgl_wave_phase_name": (ctypes.c_char_p, [_I])}
_INDEL = {"indel_bits_launch": (_I, [_P, _I, _P, _P, _I, _P, _P, _I, _P,
                                     ctypes.c_longlong, _P]),
          "indel_bits_smem_optin": (_I, [_I]),
          "indel_bits_state_words": (ctypes.c_longlong, [_I])}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def wgl_wave(tab: torch.Tensor, scal: torch.Tensor, out: torch.Tensor,
             wk: int) -> None:
    """Launch csrc/wgl_wave.cu on the current stream: tab [K, r_pad,
    TLANES], scal [K, r_pad, 8] -> out [K, 4], all int32 on one CUDA
    device (the caller checks shapes)."""
    lib = _lib("wgl_wave", _WGL)
    with torch.cuda.device(tab.device):
        err = lib.wgl_wave_launch(tab.data_ptr(), scal.data_ptr(),
                                  out.data_ptr(), tab.shape[0],
                                  tab.shape[1], wk, _stream(tab))
    _check(lib, "wgl_wave", err)


def wgl_wave_phase_names() -> list:
    """The phases the profiling instantiation of csrc/wgl_wave.cu times,
    in the order of its cycle counts."""
    lib = _lib("wgl_wave", _WGL)
    return [lib.wgl_wave_phase_name(i).decode()
            for i in range(lib.wgl_wave_phases())]


def wgl_wave_profile(tab: torch.Tensor, scal: torch.Tensor,
                     out: torch.Tensor, prof: torch.Tensor, wk: int) -> None:
    """Launch the profiling instantiation of csrc/wgl_wave.cu: the same
    search into ``out`` [K, 4], and into ``prof`` [K, phases + 2] int64
    the SM cycles thread 0 of each block spent in each phase, summed
    over the waves (clock64 at each phase boundary), then the frontier's
    filled states and the kept candidates, summed over the waves. Not
    counted in ``wgl_mxu.LAUNCHES``: it is a measurement, not the main
    path."""
    lib = _lib("wgl_wave", _WGL)
    with torch.cuda.device(tab.device):
        err = lib.wgl_wave_profile(tab.data_ptr(), scal.data_ptr(),
                                   out.data_ptr(), prof.data_ptr(),
                                   tab.shape[0], tab.shape[1], wk,
                                   _stream(tab))
    _check(lib, "wgl_wave", err)


def indel_smem_optin(device: torch.device) -> int:
    """Bytes of dynamic shared memory one block may opt in to."""
    lib = _lib("indel_bits", _INDEL)
    index = torch.device(device).index
    got = lib.indel_bits_smem_optin(
        torch.cuda.current_device() if index is None else index)
    if got < 0:
        raise RuntimeError("cudaDeviceGetAttribute failed")
    return got


def indel_state_words(n: int) -> int:
    """64-bit words of indel_bits.cu's state for one log against a
    canonical log of n codes (the kernel's layout, read from the
    kernel's source): the size of the log's slice of the global scratch
    (times 8: the bytes of shared memory it takes)."""
    return int(_lib("indel_bits", _INDEL).indel_bits_state_words(n))


def indel_bits(order: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               m: torch.Tensor, out: torch.Tensor, scratch) -> None:
    """Launch csrc/indel_bits.cu on the current stream: order [n], lo
    and hi [K, LB], m [K] -> out [K], all int32 on one CUDA device;
    ``scratch`` is a [K, indel_state_words(n)] int64 tensor for the
    global-memory regime (the launch refuses another width), or None for
    the shared-memory one (the caller checks shapes)."""
    lib = _lib("indel_bits", _INDEL)
    with torch.cuda.device(order.device):
        err = lib.indel_bits_launch(
            order.data_ptr(), order.shape[0], lo.data_ptr(), hi.data_ptr(),
            lo.shape[1], m.data_ptr(), out.data_ptr(), lo.shape[0],
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.shape[1], _stream(order))
    _check(lib, "indel_bits", err)
