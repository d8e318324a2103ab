"""The fixture :func:`clean_obs` for the port's obs tests, which take
``REF``, ``PORT`` and ``both`` from ``torch_call_plane``, and the readings
the hook twins share.

Every observability module is process-wide in its package: a scenario
asserts deltas or reads only its own flight tags and its own objects'
fleet-gauge values, resets with the module's own reset, and
:func:`clean_obs` puts each package's recorder, tracer and watchdog back
as it found them.
"""

import importlib

import pytest

from torch_call_plane import BOTH, REF


def mod(pkg, path: str):
    """``pkg``'s module at ``path`` (``core.ring``, ``rpc.frame``, ...);
    ``shim.*`` is ``jaxshim`` in the reference and ``torchshim`` in the
    port."""
    if path.startswith("shim."):
        path = ("jaxshim." if pkg is REF else "torchshim.") + path[5:]
    root = "tpurpc" if pkg is REF else "tpurpc_torch"
    return importlib.import_module(f"{root}.{path}")


def counter(pkg, name: str) -> int:
    return pkg.metrics.counter(name).snapshot()


def hop(pkg, name: str):
    """``(bytes, busy_ns, copy_bytes)`` of a lens hop, now."""
    return tuple(c.snapshot() for c in pkg.lens.hop_counters(name))


def hist(pkg, name: str):
    """``(count, sum)`` of a registry histogram, now."""
    h = pkg.metrics.histogram(name)
    return h.snapshot()["count"], h.sum()


def fleet_reading(pkg, name: str, obj):
    """The fleet gauge ``name``'s reading of ``obj``, or None when the
    gauge does not track it."""
    g = pkg.metrics.fleet(name)
    if obj not in set(g._refs):
        return None
    return float(g._fn(obj))


def server(pkg, methods, **kw):
    """A started server of ``pkg`` on its Python plane (the hooks these
    tests read live there) with ``{path: (kind, fn)}``; returns
    ``(server, port)``."""
    srv_mod = pkg.server
    kw["native_dataplane"] = False
    srv = srv_mod.Server(max_workers=kw.pop("max_workers", 4), **kw)
    for path, (kind, fn) in methods.items():
        srv.add_method(path, getattr(srv_mod, f"{kind}_rpc_method_handler")(fn))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def method(pkg, ch, kind: str, path: str):
    """``ch``'s multicallable of ``kind``, off the native call path."""
    return getattr(ch, kind)(path, tpurpc_native=False)


def _reset(pkg):
    pkg.flight.RECORDER.reset()
    pkg.tracing.reset()
    pkg.tracing.force(None)
    pkg.tracing.tail(None)
    pkg.tracing.configure(0.0)
    pkg.watchdog.get().reset()


@pytest.fixture
def clean_obs():
    """Fresh flight rings, span buffers and watchdog registries in both
    packages, sampling at 0 and tail capture at its default; the watchdogs'
    knobs are restored afterwards."""
    saved = []
    for pkg in BOTH:
        _reset(pkg)
        wd = pkg.watchdog.get()
        saved.append((wd, (wd.min_stall_s, wd.sweep_s, wd.mult,
                           wd.enabled)))
    yield
    for wd, prev in saved:
        wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled = prev
    for pkg in BOTH:
        _reset(pkg)
        pkg.tracing.configure()
