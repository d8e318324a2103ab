"""ctypes loader for the port's native data-plane core.

The C sources live in ``tpurpc_torch/native/`` (``src/*.cc`` with the
public headers in ``include/tpurpc/``) and build at first use, with one
``g++`` call, into ``tpurpc_torch/build/native/libtpurpc_torch.so``. The
file name is the port's own, so a process that also loads another copy of
the library never shares a path or a handle with it. The state machines
stay in Python; the per-byte work (framed-ring scan and copy with
acquire/release fences) and the whole native client and server loops
(``rpc/native_client.py``, ``rpc/native_server.py``) run in C++.
Pure-Python fallbacks stay in ``tpurpc_torch/core/ring.py``;
``TPURPC_NATIVE=0`` forces them, ``TPURPC_NATIVE_BUILD=0`` skips the build
and ``TPURPC_NATIVE_LIB`` points the loader at another artifact.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: "Optional[ctypes.CDLL]" = None
_SPIN: "Optional[ctypes.CDLL]" = None
_TRIED = False

ABI_VERSION = 7

#: the C sources the library builds from (the port's own copy)
_SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "src")


def _lib_path() -> str:
    # TPURPC_NATIVE_LIB points the loader at an alternate artifact (a
    # sanitized build, say) without clobbering the release .so
    override = os.environ.get("TPURPC_NATIVE_LIB")
    if override:
        return override
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(pkg, "build", "native", "libtpurpc_torch.so")


def _try_build(path: str) -> None:
    """Best-effort first-use build of the native core (fresh checkouts ship
    sources only): one g++ per source, started together, and a link; no
    cmake dependency. Guarded by an exclusive lockfile so that concurrent
    processes do not race the link; losers wait for the winner. Failure is
    fine: callers fall back to the pure-Python data plane.
    ``TPURPC_NATIVE_BUILD=0`` disables."""
    import shutil

    if os.environ.get("TPURPC_NATIVE_BUILD", "1") == "0":
        return
    if os.environ.get("TPURPC_NATIVE_LIB"):
        return  # an explicitly pointed-at artifact is never auto-built
    gxx = shutil.which("g++")
    if gxx is None:
        return
    import glob

    build_dir = os.path.dirname(path)
    srcs = sorted(glob.glob(os.path.join(_SRC_DIR, "*.cc")))
    if not srcs:
        return
    os.makedirs(build_dir, exist_ok=True)
    lock_path = os.path.join(build_dir, ".build.lock")
    fail_stamp = os.path.join(build_dir, ".build.failed")
    try:
        import fcntl

        src_mtime = max(os.path.getmtime(s) for s in srcs)
        with open(lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # winner builds, losers wait here
            if os.path.exists(fail_stamp):
                # A prior attempt failed. Honor the stamp only while the
                # sources are unchanged — newer sources (a fix, a git pull)
                # invalidate it, as does a stamp older than the sources on
                # disk. A transient failure (loaded machine) is retried by
                # touching the sources or deleting the build directory.
                try:
                    with open(fail_stamp) as f:
                        stamped = float(f.readline().strip() or 0)
                except (OSError, ValueError):
                    stamped = 0.0
                if stamped >= src_mtime:
                    return
                os.unlink(fail_stamp)
            if not os.path.exists(path):
                tmp = path + ".tmp"
                try:
                    _compile(gxx, srcs, build_dir, tmp)
                except Exception as exc:
                    # Stamp the failure so future processes skip the broken
                    # compile until the sources change.
                    with open(fail_stamp, "w") as f:
                        f.write(f"{src_mtime}\n{type(exc).__name__}: {exc}\n")
                    return
                os.replace(tmp, path)  # atomic: no partially-linked .so visible
    except Exception:
        pass


#: the compile flags of every source; ``-fno-gnu-unique``: a
#: function-local static in an inline function (the rendezvous pool's
#: singleton) would otherwise be one object per process across every
#: library built from these sources, whatever handle loaded them
_CXXFLAGS = ("-std=c++17", "-O3", "-DNDEBUG", "-fPIC", "-fno-gnu-unique")


def _compile(gxx: str, srcs, build_dir: str, out: str) -> None:
    """One ``g++ -c`` per source, all started together, then one link into
    ``out``. -lrt: shm_open/shm_unlink live in librt on older glibc
    (< 2.34); without it the link "succeeds" but dlopen fails with an
    undefined symbol and the native data plane falls back to Python.
    Harmless where libc already provides them."""
    import subprocess
    import time

    objs = [os.path.join(build_dir, os.path.basename(src) + ".o")
            for src in srcs]
    procs = [subprocess.Popen([gxx, *_CXXFLAGS, "-c", src, "-o", obj],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE)
             for src, obj in zip(srcs, objs)]
    deadline = time.monotonic() + 120
    failed = []
    for src, proc in zip(srcs, procs):
        try:
            _, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)}: "
                          f"{err.decode(errors='replace')[-400:]}")
    if failed:
        raise RuntimeError("; ".join(failed))
    subprocess.run([gxx, "-shared", *objs, "-o", out, "-lpthread", "-lrt"],
                   check=True, timeout=120, capture_output=True)
    for obj in objs:
        try:
            os.unlink(obj)
        except OSError:
            pass


def load() -> "Optional[ctypes.CDLL]":
    """The native library, or None (absent, disabled, or ABI-mismatched)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("TPURPC_NATIVE", "1") == "0":
        return None
    path = _lib_path()
    if not os.path.exists(path):
        _try_build(path)
    if not os.path.exists(path):
        return None
    try:
        # PyDLL: calls run WITH the GIL held. The ring ops take raw pointers
        # into shm segments whose lifetime is managed by Python memoryview
        # release + munmap on other threads; holding the GIL makes each
        # [liveness-check → native call] pair atomic against teardown, the
        # exact safety the pure-Python slicing path gets implicitly.
        lib = ctypes.PyDLL(path)
    except OSError:
        # A stale or mis-linked artifact fails dlopen (observed: a build
        # without -lrt leaves shm_open undefined on older glibc). Rebuild
        # from sources once instead of silently dropping the whole native
        # data plane to Python for the life of the process.
        try:
            os.unlink(path)
        except OSError:
            return None
        _try_build(path)
        if not os.path.exists(path):
            return None
        try:
            lib = ctypes.PyDLL(path)
        except OSError:
            return None
    if lib.tpr_abi_version() != ABI_VERSION:
        # A stale artifact from an older checkout: rebuild from the sources
        # on disk instead of silently dropping the native data plane (the
        # same recovery the dlopen-failure path gets). An explicitly
        # pointed-at TPURPC_NATIVE_LIB is never deleted or rebuilt.
        if os.environ.get("TPURPC_NATIVE_LIB"):
            return None
        try:
            os.unlink(path)
        except OSError:
            return None
        _try_build(path)
        if not os.path.exists(path):
            return None
        try:
            lib = ctypes.PyDLL(path)
        except OSError:
            return None
        if lib.tpr_abi_version() != ABI_VERSION:
            return None
    u64 = ctypes.c_uint64
    pu64 = ctypes.POINTER(u64)
    pu8 = ctypes.c_void_p
    lib.tpr_ring_readable.restype = u64
    lib.tpr_ring_readable.argtypes = [pu8, u64, u64, u64, u64, u64]
    lib.tpr_ring_read_into.restype = u64
    lib.tpr_ring_read_into.argtypes = [pu8, u64, pu64, pu64, pu64, pu8, u64,
                                       pu64, pu64]
    lib.tpr_ring_writev.restype = u64
    lib.tpr_ring_writev.argtypes = [pu8, u64, pu64, u64,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    pu64, ctypes.c_uint32, pu64]
    lib.tpr_ring_has_message.restype = ctypes.c_int
    lib.tpr_ring_has_message.argtypes = [pu8, u64, u64, u64, u64]
    # waiter-advertisement words (futex-style sleep handshake; see ring.cc)
    lib.tpr_store_u64_seqcst.restype = None
    lib.tpr_store_u64_seqcst.argtypes = [pu8, u64]
    lib.tpr_load_u64_fenced.restype = u64
    lib.tpr_load_u64_fenced.argtypes = [pu8]
    # fused hot-path send: credit fold + chunked gather-encode + notify
    # decision in one GIL-held call (see ring.cc tpr_send_fast)
    lib.tpr_send_fast.restype = u64
    lib.tpr_send_fast.argtypes = [pu8, u64, pu64, pu64, pu8, pu64, pu8,
                                  ctypes.POINTER(ctypes.c_void_p), pu64,
                                  ctypes.c_uint32, u64,
                                  ctypes.POINTER(ctypes.c_int)]
    _LIB = lib

    # Second handle via CDLL: these calls RELEASE the GIL — they are the
    # bounded busy-poll windows (BP/BPEV disciplines), and a spinning waiter
    # must not starve the very threads that produce what it waits for.
    # Callers pin the watched memory (an exported buffer view) across the
    # call; Region.close retries on BufferError until waiters unpin.
    spin = ctypes.CDLL(path)
    spin.tpr_ring_wait_message.restype = ctypes.c_int
    spin.tpr_ring_wait_message.argtypes = [pu8, u64, u64, u64, u64]
    spin.tpr_spin_u64_change.restype = ctypes.c_int
    spin.tpr_spin_u64_change.argtypes = [pu8, u64, u64]
    global _SPIN
    _SPIN = spin
    return _LIB


def load_spin() -> "Optional[ctypes.CDLL]":
    """GIL-releasing spin-wait entry points (None when native is unavailable)."""
    load()
    return _SPIN


def addr_of(buf, writable: bool) -> int:
    """Raw address of a buffer-protocol object without copying.

    numpy handles both read-only and writable exporters; the array is a view,
    so the caller must keep ``buf`` alive for the duration of the native call.
    """
    return pin(buf, writable)[1]


def pin(buf, writable: bool):
    """(array, address) for repeated native calls on a long-lived buffer.

    The returned array holds a buffer-protocol export: the underlying
    memoryview/shm segment cannot release while it is referenced, which is
    what makes a CACHED address safe to pass to native code. Owners must drop
    the pin before closing the buffer (close paths retry on BufferError for
    the in-flight-call window).

    ``__array_interface__`` instead of ``.ctypes.data``: the latter constructs
    a ctypes helper object per access, measurable on the per-RPC path."""
    arr = np.frombuffer(buf, dtype=np.uint8)
    if writable and not arr.flags.writeable:
        raise ValueError("writable buffer required")
    return arr, arr.__array_interface__["data"][0]


def reset_for_tests() -> None:
    global _LIB, _SPIN, _TRIED
    _LIB = None
    _SPIN = None
    _TRIED = False
