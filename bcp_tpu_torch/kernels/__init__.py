"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launchers and is compiled at
first use with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``_build/`` (git-ignored), which ``ctypes`` then loads. The launchers take
raw device pointers and PyTorch's current CUDA stream, launch, and return
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception. Nothing here runs when the module is imported: the CPU tests
import every module and have neither ``nvcc`` nor a card.

The library name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited kernel or header is rebuilt
and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int

#: extern "C" launchers of each source: name -> argument types
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "scatter_add": {
        "scatter_add_windows_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _P),
        "softmax_scatter_add_windows_f32": (_P, _P, _P, _I, _I, _I, _I, _I,
                                            _I, _I, _I, _P),
        "overlap_add_vector_width": (_P, _P, _P, _I, _I, _I, _I),
    },
    "conv3x3x3": {
        "conv3x3x3_bf16": (_P,) * 7,
        "conv3x3x3_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "conv3x3x3_dw": {
        "conv3x3x3_dw_bf16": (_P,) * 6,
        "conv3x3x3_dw_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _P),
    },
    "conv3x3x3_dxdw": {
        "conv3x3x3_dxdw_bf16": (_P,) * 10,
        "conv3x3x3_dxdw_pack": (_P, _P, _I, _I, _P),
        "conv3x3x3_dxdw_f32": (_P,) * 7 + (_I,) * 10 + (_P,),
    },
}


def _nvcc() -> str:
    # PyTorch's CUDA_HOME: $CUDA_HOME, $CUDA_PATH, nvcc on PATH, then
    # /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the port's kernels")
    return str(nvcc)


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, tagged with a hash of that source,
    every header under ``csrc/`` (an edited header rebuilds each library)
    and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (Popen, tmp_path, final_path) or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


def build_all() -> float:
    """Compile every kernel source at once (one nvcc each, in parallel)
    and return the seconds it took. Already-built sources are skipped."""
    t0 = time.perf_counter()
    started = {name: _start_build(name) for name in SIGNATURES}
    for name, st in started.items():
        if st is not None:
            _finish_build(name, st)
    return time.perf_counter() - t0


_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed (one
    thread at a time: the validation worker may ask while the training
    thread builds)."""
    with _BUILD_LOCK:
        st = _start_build(name)
        if st is not None:
            _finish_build(name, st)
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    """Raise when a launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {code}")


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``. The training thread and the
    background validation thread launch the same kernels, so the
    read-add-write is taken under a lock."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw pointer (read
    straight from the C extension where it offers that: no Stream object is
    built on the launch path)."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        index = device.index
        return raw(torch.cuda.current_device() if index is None else index)
    return torch.cuda.current_stream(device).cuda_stream
