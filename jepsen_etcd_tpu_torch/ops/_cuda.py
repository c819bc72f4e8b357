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


def _wgl_lib() -> ctypes.CDLL:
    with _lock:
        lib = _libs.get("wgl_wave")
        if lib is None:
            lib = ctypes.CDLL(build("wgl_wave"))
            fn = lib.wgl_wave_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            lib.wgl_wave_error_string.restype = ctypes.c_char_p
            lib.wgl_wave_error_string.argtypes = [ctypes.c_int]
            _libs["wgl_wave"] = lib
        return lib


def wgl_wave(tab: torch.Tensor, scal: torch.Tensor, out: torch.Tensor,
             wk: int) -> None:
    """Launch csrc/wgl_wave.cu on the current stream: tab [K, r_pad,
    TLANES], scal [K, r_pad, 8] -> out [K, 4], all int32 on one CUDA
    device (the caller checks shapes)."""
    lib = _wgl_lib()
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = lib.wgl_wave_launch(tab.data_ptr(), scal.data_ptr(),
                                  out.data_ptr(), tab.shape[0],
                                  tab.shape[1], wk, stream)
    if err != 0:
        msg = lib.wgl_wave_error_string(err).decode()
        raise RuntimeError(f"wgl_wave launch failed: {msg} ({err})")
