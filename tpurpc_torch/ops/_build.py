"""Build and load the port's CUDA kernels: nvcc → shared library → ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``build/lib<name>.so`` for
``sm_90a`` with a plain C entry point, at first use (or ahead of time through
:func:`build`, which starts one ``nvcc`` per source, all at once). The
library is rebuilt when a source is newer than it. Nothing here runs at
import time: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

_P = ctypes.c_void_p
_U = ctypes.c_uint32
#: one segment of a span plan (ops/_span.py Segment): dst, src, head,
#: words, tail, skew, chunks
_SEG = [_P, _P, _U, _U, _U, _U, _U]

#: kernel → (C symbol, argtypes). Both take a span plan of ``_span`` (two
#: segments, then chunk_words) and the stream;
#: pointers and the stream are c_void_p. Every entry returns
#: cudaGetLastError().
KERNELS: Dict[str, Tuple[str, list]] = {
    "ring_scatter": ("tpr_ring_scatter", _SEG + _SEG + [_U, _P]),
    "ring_window": ("tpr_ring_window", _SEG + _SEG + [_U, _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build only on a machine with the CUDA toolkit")


def lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _sources(name: str) -> List[str]:
    return [os.path.join(CSRC, f"{name}.cu"), os.path.join(CSRC, "ring_copy.cuh")]


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(s) > built for s in _sources(name))


def build(names: Iterable[str] = tuple(KERNELS), verbose: bool = False
          ) -> Tuple[float, Dict[str, str]]:
    """Compile every stale kernel library among ``names``, one ``nvcc`` per
    source, all started together. Returns ``(seconds, {name: compiler
    output})``; raises RuntimeError with the compiler's output on failure.
    ``verbose`` adds ``-Xptxas=-v`` (registers, shared memory, spills)."""
    t0 = time.monotonic()
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.monotonic() - t0, logs


def load(name: str):
    """The kernel's C entry point (building the library first if needed).
    Once loaded, it is returned without taking the lock."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            if _stale(name):
                build([name])
            symbol, argtypes = KERNELS[name]
            fn = getattr(ctypes.CDLL(lib_path(name)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn


def launch(name: str, args: tuple, device: torch.device) -> None:
    """Call kernel ``name``'s C entry with ``args`` and the current stream
    of ``device``; enters the device only when it is not the current one.
    Raises on a non-zero cudaGetLastError() from the launch."""
    fn = load(name)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
