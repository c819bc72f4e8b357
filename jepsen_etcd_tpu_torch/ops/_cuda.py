"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc for sm_90a into a shared library with a
plain C interface under ``jepsen_etcd_tpu_torch/_build/`` (keyed by the
source's hash), at first use, and is loaded with ctypes. Pointers and
the stream pass as ``c_void_p``. A kernel that fails to build or launch
raises: there is no fallback for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
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


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu``, with the argument types
    of its C functions set from ``_SIGNATURES[name]`` (function ->
    (restype, argtypes)); every library also exports
    ``<name>_error_string``. The lock keeps two threads from building
    one source at once."""
    with _lock:
        lib = ctypes.CDLL(build(name))
    signatures = dict(_SIGNATURES[name])
    signatures[f"{name}_error_string"] = (ctypes.c_char_p, [ctypes.c_int])
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
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
_DRAIN = {"drain_register_launch": (_I, [_P] * 12 + [_I] * 7 + [_P]),
          "drain_register_smem": (_I, [_I] * 3),
          "drain_register_max_lanes": (_I, [])}
_RUNG = {"wgl_rung_launch": (_I, [_P, _P, _I, _P, _I, _I, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _P]),
         "wgl_rung_limit": (_I, [_I])}
_FRAMES = {"wgl_frames_launch": (_I, [_P, _I, _I, _I, _I, _P, _P, _P])}
_SIGNATURES = {"wgl_wave": _WGL, "indel_bits": _INDEL,
               "drain_register": _DRAIN, "wgl_rung": _RUNG,
               "wgl_frames": _FRAMES}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def wgl_wave(tab: torch.Tensor, scal: torch.Tensor, out: torch.Tensor,
             wk: int) -> None:
    """Launch csrc/wgl_wave.cu on the current stream: tab [K, r_pad,
    TLANES], scal [K, r_pad, 8] -> out [K, 4], all int32 on one CUDA
    device (the caller checks shapes)."""
    lib = _lib("wgl_wave")
    with torch.cuda.device(tab.device):
        err = lib.wgl_wave_launch(tab.data_ptr(), scal.data_ptr(),
                                  out.data_ptr(), tab.shape[0],
                                  tab.shape[1], wk, _stream(tab))
    _check(lib, "wgl_wave", err)


def wgl_wave_phase_names() -> list:
    """The phases the profiling instantiation of csrc/wgl_wave.cu times,
    in the order of its cycle counts."""
    lib = _lib("wgl_wave")
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
    lib = _lib("wgl_wave")
    with torch.cuda.device(tab.device):
        err = lib.wgl_wave_profile(tab.data_ptr(), scal.data_ptr(),
                                   out.data_ptr(), prof.data_ptr(),
                                   tab.shape[0], tab.shape[1], wk,
                                   _stream(tab))
    _check(lib, "wgl_wave", err)


def wgl_rung(rows: torch.Tensor, info: torch.Tensor, cls: torch.Tensor,
             fr: torch.Tensor, n_alive: torch.Tensor, out: torch.Tensor,
             res: torch.Tensor, R: int, k0: int, lim: int) -> None:
    """Launch csrc/wgl_rung.cu on the current stream: one rung run of
    capacity ``fr.shape[0]`` from wave ``k0`` to at most ``lim``.
    rows [r_pad, 196], info [r_pad, 2 * i_tab] and cls [c_pad, 8 + ni]
    int32 (``wgl._rung_kernel_tables``), fr [F, 3 + ni] and n_alive [1]
    int64 -> out [F, 3 + ni] and res [5] int64, all contiguous on one
    CUDA device; rows must hold every depth below R. Raises ValueError
    on anything else (the kernel refuses F, c_pad or ni beyond
    ``wgl_rung_limits``)."""
    ni = fr.shape[1] - 3
    want = ((rows, torch.int32, None), (info, torch.int32, None),
            (cls, torch.int32, None), (fr, torch.int64, None),
            (n_alive, torch.int64, (1,)), (out, torch.int64, fr.shape),
            (res, torch.int64, (5,)))
    if any(t.device != fr.device or t.dtype != dt or not t.is_contiguous()
           or (shape is not None and t.shape != shape)
           for t, dt, shape in want) or fr.device.type != "cuda" \
            or rows.dim() != 2 or rows.shape[1] != 196 \
            or rows.shape[0] < R or ni < 0 \
            or (ni and (cls.shape[1] != 8 + ni
                        or info.shape[0] != rows.shape[0])):
        raise ValueError("wgl_rung: inputs of the wrong device, type, "
                         "layout or shape")
    lib = _lib("wgl_rung")
    with torch.cuda.device(fr.device):
        err = lib.wgl_rung_launch(
            rows.data_ptr(), info.data_ptr(), info.shape[1] // 2,
            cls.data_ptr(), cls.shape[0], ni, fr.data_ptr(),
            n_alive.data_ptr(), out.data_ptr(), res.data_ptr(), fr.shape[0],
            R, k0, lim, _stream(fr))
    _check(lib, "wgl_rung", err)


@functools.lru_cache(maxsize=None)
def wgl_rung_limits() -> tuple:
    """(capacity, info classes, count words): the largest a
    csrc/wgl_rung.cu launch takes, as the built kernel states them."""
    lib = _lib("wgl_rung")
    return tuple(int(lib.wgl_rung_limit(i)) for i in range(3))


def wgl_frames(inputs: torch.Tensor, R: int, I: int, rows: torch.Tensor,
               info: torch.Tensor) -> None:
    """Launch csrc/wgl_frames.cu on the current stream: from ``inputs``
    (int32, a key's per-op vectors as ``wgl._frame_inputs`` lays them
    out, at least 12 R + 2 I long) -> the rung kernel's rows [r_pad, 196]
    and info [r_pad, 2 * i_tab] int32 (``wgl._rung_kernel_tables``);
    info [0, 0] for a key without info classes. All contiguous on one
    CUDA device. Raises ValueError on anything else."""
    want = ((inputs, 1), (rows, 2), (info, 2))
    if any(t.device != inputs.device or t.dtype != torch.int32
           or not t.is_contiguous() or t.dim() != dim for t, dim in want) \
            or inputs.device.type != "cuda" or R < 1 \
            or inputs.shape[0] < 12 * R + 2 * I \
            or rows.shape[1] != 196 or rows.shape[0] < R \
            or (info.numel() and (info.shape[0] != rows.shape[0]
                                  or info.shape[1] < 2 * I
                                  or info.shape[1] % 2)):
        raise ValueError("wgl_frames: inputs of the wrong device, type, "
                         "layout or shape")
    lib = _lib("wgl_frames")
    with torch.cuda.device(rows.device):
        err = lib.wgl_frames_launch(
            inputs.data_ptr(), R, I, info.shape[1] // 2, rows.shape[0],
            rows.data_ptr(), info.data_ptr() if info.numel() else None,
            _stream(rows))
    _check(lib, "wgl_frames", err)


def indel_smem_optin(device: torch.device) -> int:
    """Bytes of dynamic shared memory one block may opt in to."""
    lib = _lib("indel_bits")
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
    return int(_lib("indel_bits").indel_bits_state_words(n))


def indel_bits(order: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               m: torch.Tensor, out: torch.Tensor, scratch) -> None:
    """Launch csrc/indel_bits.cu on the current stream: order [n], lo
    and hi [K, LB], m [K] -> out [K], all int32 on one CUDA device;
    ``scratch`` is a [K, indel_state_words(n)] int64 tensor for the
    global-memory regime (the launch refuses another width), or None for
    the shared-memory one (the caller checks shapes)."""
    lib = _lib("indel_bits")
    with torch.cuda.device(order.device):
        err = lib.indel_bits_launch(
            order.data_ptr(), order.shape[0], lo.data_ptr(), hi.data_ptr(),
            lo.shape[1], m.data_ptr(), out.data_ptr(), lo.shape[0],
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.shape[1], _stream(order))
    _check(lib, "indel_bits", err)


def drain_smem(SB: int, KB: int, T: int) -> int:
    """Bytes of shared memory a csrc/drain_register.cu block takes with
    SB seeds and KB keys, tiles of T rows."""
    return int(_lib("drain_register").drain_register_smem(SB, KB, T))


def drain_max_lanes() -> int:
    """(seed, key) lanes a csrc/drain_register.cu block may take (its
    other warps are the workers)."""
    return int(_lib("drain_register").drain_register_max_lanes())


def drain_register(state0: tuple, planes: tuple, flags: tuple,
                   out: torch.Tensor, blocking: tuple,
                   seed_major: bool = False) -> None:
    """Launch csrc/drain_register.cu on the current stream: ``state0``
    (ver0, val0, pver0, pval0) [S, K], ``planes`` (k, f, wv, co, cn)
    [N, S] int32, ``flags`` (to, sg) [N, S] bool -> out [5, N, S] int32;
    with ``seed_major`` the planes are transposes of contiguous [S, N]
    tensors and ``out`` is [5, S, N]. ``blocking`` is (SB, KB, T): a
    block owns SB seeds and KB keys, a lane per (seed, key), and walks
    tiles of T rows (``engine_v3.drain_blocking``). All on one CUDA
    device (the caller checks shapes, types and layouts)."""
    lib = _lib("drain_register")
    N, S = planes[0].shape
    K = state0[0].shape[1]
    with torch.cuda.device(out.device):
        err = lib.drain_register_launch(
            *[t.data_ptr() for t in (*state0, *planes, *flags, out)],
            N, S, K, *blocking, int(seed_major), _stream(out))
    _check(lib, "drain_register", err)
