"""Shared scaffolding of the native-plane twins (``test_torch_native_*``).

Both packages' native libraries build at first use from their own sources
(the reference's into ``native/build/``, the port's into
``tpurpc_torch/build/native/``); :func:`libs` takes both builds outside any
call's deadline and skips only where no ``g++`` exists. ``REF`` and
``PORT`` put each package's ``rpc`` surface, ``NativeChannel``, status
module, config and native loaders under the same names. A twin runs a
scenario on a client/server package pair and holds it against the
reference-to-reference run: ``DIRS`` are the two cross pairs.
"""

import os
import shutil
import subprocess
import types

import pytest

import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc
from tpurpc.core import _native as ref_native
from tpurpc.rpc import aio as ref_aio
from tpurpc.rpc import native_client as ref_nc
from tpurpc.rpc import status as ref_status
from tpurpc.utils import config as ref_config
from tpurpc_torch.core import _native as port_native
from tpurpc_torch.core.poller import PairPool, Poller
from tpurpc_torch.rpc import aio as port_aio
from tpurpc_torch.rpc import native_client as port_nc
from tpurpc_torch.rpc import status as port_status
from tpurpc_torch.utils import config as port_config

REF = types.SimpleNamespace(
    name="ref", rpc=jrpc, nc=ref_nc, status=ref_status,
    aio=ref_aio, config=ref_config, native=ref_native,
    NativeChannel=ref_nc.NativeChannel)
PORT = types.SimpleNamespace(
    name="port", rpc=trpc, nc=port_nc, status=port_status,
    aio=port_aio, config=port_config, native=port_native,
    NativeChannel=port_nc.NativeChannel)
PKG = {"ref": REF, "port": PORT}
#: (client package, server package) of the two cross directions
DIRS = [("port", "ref"), ("ref", "port")]
DIR_IDS = [f"{c}-to-{s}" for c, s in DIRS]


def libs() -> None:
    """Both libraries loaded (built first where absent); a skip only
    without a compiler."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain")
    assert ref_native.load() is not None, "reference library did not load"
    assert port_native.load() is not None, "port library did not load"
    # the client loaders' handles (the reference's has no build of its own)
    ref_nc._load()
    port_nc._load()


def reset_configs() -> None:
    ref_config.set_config(None)
    port_config.set_config(None)


@pytest.fixture
def on_platform(monkeypatch):
    """``on_platform(name, **env)``: both packages on ``name`` with both
    libraries built; configs and the port's pollers reset afterwards."""
    libs()

    def use(name, **env):
        monkeypatch.setenv("GRPC_PLATFORM_TYPE", name)
        monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        reset_configs()
    yield use
    Poller.reset()
    PairPool.reset()
    reset_configs()


def code_name(exc) -> tuple:
    """An RpcError of either package as ``(code name, details)``."""
    return exc.code().name, exc.details()


def twin(scenario, client: str, server: str, *args):
    """``scenario(client_pkg, server_pkg, *args)`` on the cross pair and on
    the reference pair; the observations must be equal. Returns one."""
    want = scenario(REF, REF, *args)
    got = scenario(PKG[client], PKG[server], *args)
    assert got == want, (got, want)
    return got


# ---------------------------------------------------------------------------
# C++ programs built against the port's C sources.
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_NATIVE = os.path.join(REPO, "tpurpc_torch", "native")
#: the reference's C tree, built the same way where a case compares the two
REF_NATIVE = os.path.join(REPO, "native")
#: C++ test programs and their objects (gitignored), never native/build/
CPP_DIR = os.path.join(REPO, "tpurpc_torch", "build", "cpp")
_FLAGS = {"opt": ("-std=c++17", "-O2"),
          "asan": ("-std=c++17", "-O1", "-g",
                   "-fsanitize=address,undefined")}
_CLIENT = ("tpurpc_client.cc", "tpr_rdv.cc", "tpr_obs.cc", "ring.cc")
_SERVER = ("tpurpc_server.cc", "tpr_rdv.cc", "tpr_obs.cc", "ring.cc")
_BOTH = ("tpurpc_client.cc", "tpurpc_server.cc", "tpr_rdv.cc", "tpr_obs.cc",
         "ring.cc")
PARTS = {"client": _CLIENT, "server": _SERVER, "both": _BOTH}


def _stale(out: str, deps) -> bool:
    return not os.path.exists(out) or any(
        os.path.getmtime(d) >= os.path.getmtime(out) for d in deps)


def _headers(root: str):
    inc = os.path.join(root, "include", "tpurpc")
    src = os.path.join(root, "src")
    return ([os.path.join(inc, h) for h in os.listdir(inc)]
            + [os.path.join(src, h) for h in os.listdir(src)
               if h.endswith(".h")])


def cpp_program(name: str, mains, parts: str = "client",
                flavor: str = "opt", extra=(), cflags=(),
                root: str = PORT_NATIVE) -> str:
    """Build (or reuse) ``tpurpc_torch/build/cpp/<flavor>/<name>`` from the
    ``mains`` sources and the C sources of ``parts`` (the port's, or the
    reference's with ``root=REF_NATIVE``, under ``<flavor>/ref/``); each source
    compiles once per flavor, all at once, under a file lock and at
    ``nice -n 10`` (a burst of compiles must not starve the deadline-bound
    tests of other workers). ``cflags`` compile the mains only; ``extra``
    goes to the link."""
    import fcntl

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ toolchain")
    out_dir = os.path.join(CPP_DIR, flavor,
                           *(["ref"] if root == REF_NATIVE else []))
    os.makedirs(out_dir, exist_ok=True)
    flags = _FLAGS[flavor]
    inc = ["-I", os.path.join(root, "include")]
    headers = _headers(root)
    srcs = [os.path.join(root, "src", s) for s in PARTS[parts]]
    mains_set = {str(m) for m in mains}
    srcs += [str(m) for m in mains]
    out = os.path.join(out_dir, name)
    nice = ["nice", "-n", "10"] if shutil.which("nice") else []
    with open(os.path.join(CPP_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        objs, procs = [], []
        for src in srcs:
            tag = os.path.basename(os.path.dirname(src))
            obj = os.path.join(out_dir, f"{tag}_{os.path.basename(src)}.o")
            objs.append(obj)
            own = tuple(cflags) if src in mains_set else ()
            if _stale(obj, [src, *headers]):
                procs.append((src, subprocess.Popen(
                    [*nice, gxx, *flags, *inc, *own, "-c", src, "-o", obj],
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)))
        for src, proc in procs:
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, (src, err.decode()[-2000:])
        if _stale(out, objs):
            subprocess.run([*nice, gxx, *flags, *objs, *extra, "-lpthread",
                            "-lrt", "-o", out], check=True, timeout=300,
                           capture_output=True)
    return out
