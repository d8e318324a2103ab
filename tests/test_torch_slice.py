"""The port's first slice end to end on the CPU, against the reference.

A tpurpc_torch server on the device-ring platform (``GRPC_PLATFORM_TYPE=TPU``,
``TPURPC_TORCH_DEVICE=cpu``) with a 64 KiB device ring serves resnet18_thin
through ``add_tensor_method(device=True)``; the reference's own server serves
the same flax parameters on the same platform. Six requests of float32
[2,32,32,3] (24,576 bytes each) go to both; the 3rd and 6th wrap the ring,
so the wrapped landing and the wrapped view take the kernels' plain versions
(counted here). Replies agree within float32 tolerance (1e-4: the same
arithmetic in XLA and in oneDNN), and the ring's credit returns in full.

Also here: the port's modules import nothing of jax, flax or tpurpc, and the
reference's own linter passes them.
"""

import glob
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_resnet import _random_variables
from tpurpc.core import _native as ref_native
from tpurpc.jaxshim import TensorClient as JaxClient
from tpurpc.jaxshim import add_tensor_method as jax_add_tensor_method
from tpurpc.models import resnet as jres
from tpurpc.rpc.channel import Channel as JaxChannel
from tpurpc.rpc.server import Server as JaxServer
from tpurpc.utils import config as jax_config
from tpurpc_torch.core import _native as port_native
from tpurpc_torch.core.poller import PairPool, Poller
from tpurpc_torch.models import resnet as tres
from tpurpc_torch.ops import ring_scatter as rs_mod
from tpurpc_torch.ops import ring_window as rw_mod
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.rpc.server import Server
from tpurpc_torch.torchshim.service import TensorClient, add_tensor_method
from tpurpc_torch.tpu import ledger
from tpurpc_torch.utils import config as torch_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
RING_KB = 64
REQUESTS = 6
SHAPE = (2, 32, 32, 3)


@pytest.fixture
def tpu_platform(monkeypatch):
    """Both packages on the device-ring platform, the port on the CPU."""
    # The reference loads its native library on a ring's first use and,
    # in a checkout without native/build, first builds it with g++ under
    # an exclusive lock that every other process waits on for the whole
    # compile. Take that wait here, not inside a call that has a deadline.
    ref_native.load()
    port_native.load()  # and the port's, outside deadlines too
    monkeypatch.setenv("GRPC_PLATFORM_TYPE", "TPU")
    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("TPURPC_HBM_RING_SIZE_KB", str(RING_KB))
    jax_config.set_config(None)
    torch_config.set_config(None)
    yield
    Poller.reset()
    PairPool.reset()
    torch_config.set_config(None)


def _serve(server, add, handler):
    add(server, "Classify", handler, device=True)
    server.start()
    return server.add_insecure_port("127.0.0.1:0")


@pytest.fixture
def counted_plain(monkeypatch):
    """Count calls of the kernels' plain versions (the CPU path)."""
    calls = {"ring_scatter": 0, "ring_window": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(rs_mod, "ring_scatter_plain",
                        counting("ring_scatter", rs_mod.ring_scatter_plain))
    monkeypatch.setattr(rw_mod, "ring_window_plain",
                        counting("ring_window", rw_mod.ring_window_plain))
    return calls


def test_slice_serves_resnet_like_the_reference(tpu_platform, counted_plain):
    jmodel = jres.resnet18_thin(num_classes=10)
    variables = _random_variables(jmodel, 32, seed=5)
    jinfer = jax.jit(jres.make_infer_fn(jmodel))

    def jax_handler(tree):
        logits = jinfer(variables, tree["images"])
        return {"logits": logits, "top1": logits.argmax(axis=1)}

    tmodel = tres.resnet18_thin(num_classes=10)
    tmodel.load_state_dict(tres.from_flax(variables))
    tinfer = tres.make_infer_fn(tmodel)

    def torch_handler(tree):
        x = tree["images"]
        assert x.device.type == "cpu" and x.shape == SHAPE
        logits = tinfer(x)
        return {"logits": logits, "top1": logits.argmax(dim=1)}

    jsrv, tsrv = JaxServer(max_workers=2), Server(max_workers=2)
    jport = _serve(jsrv, jax_add_tensor_method, jax_handler)
    tport = _serve(tsrv, add_tensor_method, torch_handler)
    jch, tch = JaxChannel(f"127.0.0.1:{jport}"), Channel(f"127.0.0.1:{tport}")
    rng = np.random.default_rng(11)
    try:
        with ledger.track() as w:
            for _ in range(REQUESTS):
                x = rng.standard_normal(SHAPE).astype(np.float32)
                want = JaxClient(jch).call("Classify", {"images": x})
                got = TensorClient(tch).call("Classify",
                                             {"images": torch.from_numpy(x)})
                np.testing.assert_allclose(got["logits"].numpy(),
                                           np.asarray(want["logits"]),
                                           rtol=TOL, atol=TOL)
                np.testing.assert_array_equal(got["top1"].numpy(),
                                              np.asarray(want["top1"]))
                # the same model on the same input; only the input's memory
                # (a ring view vs a fresh tensor) differs
                torch.testing.assert_close(got["logits"],
                                           tinfer(torch.from_numpy(x)),
                                           rtol=1e-6, atol=1e-6)
        ring = tsrv._connections[0].endpoint.device_ring
        stats = ring.stats()
    finally:
        jch.close()
        tch.close()
        jsrv.stop()
        tsrv.stop()
    assert counted_plain == {"ring_scatter": 2, "ring_window": 2}
    assert (rs_mod.launches, rw_mod.launches) == (0, 0)  # no card here
    assert stats["writable"] == stats["capacity"] == RING_KB << 10
    assert stats["live_spans"] == 0
    nbytes = int(np.prod(SHAPE)) * 4
    assert w["zero_copy_ops"] == REQUESTS - 2          # unwrapped: aliases
    assert w["zero_copy"] == (REQUESTS - 2) * nbytes


def test_device_client_and_streaming_kinds(tpu_platform):
    """call_device lands the reply in the client's ring; unary_stream and
    stream_stream device methods see device-ring views too."""
    srv = Server(max_workers=4)
    add_tensor_method(srv, "Double", lambda t: {"y": t["x"] * 2}, device=True)
    add_tensor_method(srv, "Count", lambda t: ({"i": t["x"] + k}
                                               for k in range(3)),
                      kind="unary_stream", device=True)
    add_tensor_method(srv, "Echo", lambda it: ({"y": t["x"] + 1} for t in it),
                      kind="stream_stream", device=True)
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")
    ch = Channel(f"127.0.0.1:{port}")
    client = TensorClient(ch)
    x = torch.arange(1024, dtype=torch.float32)
    try:
        with client.call_device("Double", {"x": x}) as tree:
            assert torch.equal(tree["y"], x * 2)
        ring = ch.device_ring()
        assert ring is not None and ring.stats()["live_spans"] == 0
        outs = [t["i"] for t in client.stream("Count", {"x": x})]
        assert [torch.equal(o, x + k) for k, o in enumerate(outs)] == [True] * 3
        outs = [t["y"] for t in client.duplex("Echo", iter([{"x": x}] * 4))]
        assert len(outs) == 4 and all(torch.equal(o, x + 1) for o in outs)
    finally:
        ch.close()
        srv.stop()


def test_host_mode_on_tcp(monkeypatch):
    """device=False on the TCP platform: the host-aliasing decode."""
    monkeypatch.setenv("GRPC_PLATFORM_TYPE", "TCP")
    torch_config.set_config(None)
    srv = Server(max_workers=2)
    add_tensor_method(srv, "Add", lambda t: {"z": t["a"] + t["b"]})
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")
    ch = Channel(f"127.0.0.1:{port}")
    try:
        a, b = torch.ones(3, 4), torch.full((3, 4), 2.0)
        assert torch.equal(TensorClient(ch).call("Add", {"a": a, "b": b})["z"],
                           a + b)
    finally:
        ch.close()
        srv.stop()
        torch_config.set_config(None)


#: ``"tpurpc.<subpackage>`` or ``'tpurpc.<module>`` of the reference
_REF_MODULE_IN_STRING = re.compile(
    r"""["']tpurpc\.(?:%s)\b""" % "|".join(sorted(
        os.path.splitext(name)[0]
        for name in os.listdir(os.path.join(REPO, "tpurpc"))
        if not name.startswith(("_", ".")))))


def _port_files():
    return sorted(glob.glob(os.path.join(REPO, "tpurpc_torch", "**", "*.py"),
                            recursive=True))


def test_port_imports_nothing_of_jax_or_the_reference():
    """Neither the port's modules nor ``chip_smoke.py`` (its imports are
    inside its functions, so its source is read too). No source names a
    module of the reference in a string either (a ``sys.modules`` gate or a
    lazy import by name would read the reference's planes whenever both
    packages are loaded)."""
    code = ("import importlib, pkgutil, sys, tpurpc_torch, chip_smoke\n"
            "for m in pkgutil.walk_packages(tpurpc_torch.__path__, "
            "'tpurpc_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'flax', 'tpurpc'))\n"
            "print(bad)\n"
            "print(sorted(k for k in sys.modules if k.startswith(\n"
            "    ('tpurpc_torch.serving', 'tpurpc_torch.analysis',\n"
            "     'tpurpc_torch.tools', 'tpurpc_torch.obs.odyssey'))))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    bad, walked = out.stdout.strip().splitlines()
    assert bad == "[]"
    # the walk reached the generation plane (its modules import the rest),
    # its observability and the command-line tools
    assert walked == str([
        "tpurpc_torch.analysis", "tpurpc_torch.analysis.locks",
        "tpurpc_torch.obs.odyssey",
        "tpurpc_torch.serving", "tpurpc_torch.serving.api",
        "tpurpc_torch.serving.disagg", "tpurpc_torch.serving.kv",
        "tpurpc_torch.serving.scheduler", "tpurpc_torch.tools",
        "tpurpc_torch.tools.bundle", "tpurpc_torch.tools.collector",
        "tpurpc_torch.tools.diagnose", "tpurpc_torch.tools.odyssey_smoke"])
    for path in _port_files() + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        for bad in ("import jax", "from jax", "import flax", "from flax",
                    "import tpurpc.", "from tpurpc.", "from tpurpc import",
                    "import tpurpc\n"):
            assert bad not in src, (path, bad)
        # a reference module's dotted name in a string (gRPC service names
        # such as "tpurpc.Tensor" are wire names, not modules)
        named = _REF_MODULE_IN_STRING.search(src)
        assert named is None, (path, named and named.group(0))


def test_reference_linter_passes_the_port():
    from tpurpc.analysis.lint import lint_paths

    violations = lint_paths(_port_files())
    assert violations == [], "\n".join(map(str, violations))
