"""Both packages' call planes side by side, for the port's call-plane tests.

``REF`` and ``PORT`` carry each package's channel, server, resolver,
service-config and interceptor modules, and its observability core
(``metrics``, ``tracing``, ``flight``, ``watchdog``, ``lens``,
``profiler``, ``stats``, ``trace`` and the copy ``ledger``), under the
same names, so that one scenario function runs on either package (or on
a client of one and a server of the other). Observations are plain values: status codes by
name, reply bytes, attempt counts, throttle tokens, server indices.

The fixtures ``platform`` and ``counted_plain`` and the model
``small_classify`` serve the tests that put device-ring servers on the
CPU; a test file imports them by name.
"""

import importlib
import socket
import threading
import time
import types

import pytest
import torch

import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc
from tpurpc.core import _native as ref_native
from tpurpc.utils import config as ref_config
from tpurpc_torch.core import _native as port_native
from tpurpc_torch.core.poller import PairPool, Poller
from tpurpc_torch.ops import ring_scatter as rs_mod
from tpurpc_torch.ops import ring_window as rw_mod
from tpurpc_torch.utils import config as torch_config


def _pkg(name, root):
    mods = {m: importlib.import_module(f"{root}.rpc.{m}")
            for m in ("channel", "server", "resolver", "service_config",
                      "interceptors", "status")}
    # the observability core, for the obs tests (tests/torch_obs.py)
    mods.update({m: importlib.import_module(f"{root}.obs.{m}")
                 for m in ("metrics", "tracing", "flight", "watchdog",
                           "lens", "profiler")})
    mods["stats"] = importlib.import_module(f"{root}.utils.stats")
    mods["trace"] = importlib.import_module(f"{root}.utils.trace")
    mods["ledger"] = importlib.import_module(f"{root}.tpu.ledger")
    return types.SimpleNamespace(name=name, rpc=jrpc if name == "ref" else trpc,
                                 **mods)


REF = _pkg("ref", "tpurpc")
PORT = _pkg("port", "tpurpc_torch")
PKGS = {"ref": REF, "port": PORT}
BOTH = (REF, PORT)


def code_name(exc) -> str:
    return exc.code().name


def observe(fn):
    """``fn()``'s value, or ``("error", code name, details)`` when it
    raises an RpcError of either package."""
    try:
        return ("ok", fn())
    except (REF.status.RpcError, PORT.status.RpcError) as exc:
        return ("error", code_name(exc), exc.details())


def code_of(pkg, name: str):
    return getattr(pkg.status.StatusCode, name)


def serve(pkg, methods: dict, interceptors=(), **kw):
    """A started server of ``pkg`` with ``{path: (kind, fn)}`` methods;
    returns ``(server, port)``."""
    srv = pkg.server.Server(max_workers=kw.pop("max_workers", 8),
                            interceptors=interceptors, **kw)
    for path, (kind, fn) in methods.items():
        make = getattr(pkg.server, f"{kind}_rpc_method_handler")
        srv.add_method(path, make(fn))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port


def poll(pred, timeout: float = 10.0, interval: float = 0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(interval)
    return pred()


def settles_at(fn, expect, settle_s: float = 0.3, interval: float = 0.02):
    """``fn()`` must equal ``expect`` for the whole settle window."""
    deadline = time.monotonic() + settle_s
    while time.monotonic() < deadline:
        if fn() != expect:
            return False
        time.sleep(interval)
    return fn() == expect


#: sockets that keep dead ports reserved for the process's life
_HELD: list = []


def dead_port() -> int:
    """A port that refuses connections: bound, never listening, and held,
    so that no server of another test process can take it meanwhile (a
    port closed at once can be reused by one under ``-n 6``)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    _HELD.append(s)
    return s.getsockname()[1]


def free_dead_port(port: int) -> None:
    """Let a :func:`dead_port` go, just before a server binds it."""
    for s in list(_HELD):
        if s.getsockname()[1] == port:
            _HELD.remove(s)
            s.close()


class Counter:
    """A thread-safe handler-side call counter."""

    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()

    def bump(self) -> int:
        with self._lock:
            self.n += 1
            return self.n


class Flaky:
    """A unary handler that fails with ``code`` for its first ``fail``
    calls, then answers ``b"ok:<n>"``."""

    def __init__(self, pkg, fail: int, code: str = "UNAVAILABLE"):
        self.pkg = pkg
        self.fail = fail
        self.code = code_of(pkg, code)
        self.calls = Counter()

    def __call__(self, req, ctx):
        n = self.calls.bump()
        if n <= self.fail:
            ctx.abort(self.code, "flake")
        return b"ok:" + str(n).encode()


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on the reference, then on the port; the
    observations must be equal. Returns them."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want, (got, want)
    return got


@pytest.fixture
def platform(monkeypatch):
    """``platform(name, **env)``: both packages on ``name``, the port on
    the CPU; both packages' cached configs and the port's pollers reset
    afterwards."""
    # the reference loads (and without native/build first compiles) its
    # native library on a ring's first use, under a lock other processes
    # wait on: take that wait here, outside any call's deadline
    ref_native.load()
    port_native.load()  # and the port's, outside deadlines too

    def use(name, **env):
        monkeypatch.setenv("GRPC_PLATFORM_TYPE", name)
        monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        ref_config.set_config(None)
        torch_config.set_config(None)
    yield use
    Poller.reset()
    PairPool.reset()
    ref_config.set_config(None)
    torch_config.set_config(None)


@pytest.fixture
def counted_plain(monkeypatch):
    """Count calls of the kernels' plain versions (the CPU path), in the
    test's own dict and, as a launch on the card would, in each wrapper
    module's ``launches`` (restored afterwards), which is what
    ``chip_smoke.CallPlaneServer.launched`` reads at each server."""
    calls = {"ring_scatter": 0, "ring_window": 0}
    monkeypatch.setattr(rs_mod, "launches", rs_mod.launches)
    monkeypatch.setattr(rw_mod, "launches", rw_mod.launches)

    def counting(name, fn, mod):
        def wrapped(*a, **kw):
            calls[name] += 1
            mod.launches += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(rs_mod, "ring_scatter_plain", counting(
        "ring_scatter", rs_mod.ring_scatter_plain, rs_mod))
    monkeypatch.setattr(rw_mod, "ring_window_plain", counting(
        "ring_window", rw_mod.ring_window_plain, rw_mod))
    return calls


def small_classify():
    """A seeded stand-in for ``Classify``: logits of the images' means."""
    torch.manual_seed(3)
    w = torch.randn(3, 10)

    def classify(tree):
        logits = tree["images"].mean(dim=(1, 2)) @ w
        return {"logits": logits, "top1": logits.argmax(dim=1)}
    return classify
