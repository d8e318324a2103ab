"""The protoc plugin and protobuf codec (``tpurpc_torch.codegen``).

Mirrors ``tests/test_codegen.py``:

1. On one ``CodeGeneratorRequest``, built from ``protoc
   --descriptor_set_out``, the port's plugin writes what the reference's
   writes, but for the package names and the Python file's suffix
   (``_tpurpc_torch.py``, so that stubs of both packages from one proto
   never take each other's place in ``sys.modules``); the C++ output is the
   same bytes.
2. Stubs that protoc writes through each plugin run end to end on every
   client/server package pair (each server registered by its own
   package's stubs), the servicer base answers UNIMPLEMENTED, and methods
   on messages of an imported file resolve to that file's module.
3. Modules shaped as ``grpc_tools.protoc`` writes them (the
   ``_registered_method`` keyword, grpcio handler objects, a generic
   handler and ``add_registered_method_handlers``) run on the port's
   server and channel, and a stock grpcio channel calls the port's server.
4. ``protobuf_codec`` round-trips and serves, byte for byte as the
   reference's.

Rules these tests keep, so that they leave nothing behind for the next
test in the same worker: nothing goes into protobuf's default descriptor
pool under a file name or a symbol another test uses. Message classes for
the codec come from a private ``DescriptorPool`` fed by the descriptor
set; the ``_pb2`` modules that stubs import are compiled from files and
packages of this file's own (``torch_codegen_*.proto``, packages
``torchdemo``, ``torchapp`` and ``torchshared``). ``sys.path`` and
``sys.modules`` are restored when the module's tests end, and both
packages' reflection registries (``_GLOBAL_FILES``, which an imported stub
module fills) are fresh lists while the stubs are imported and in every
test. Every server is stopped and every channel closed in a ``finally``;
every call has a timeout; ports are ephemeral. Skipped where protoc is
absent, as the reference's test fails there.
"""

import ast
import importlib
import io
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import grpc
import pytest

import tpurpc.rpc as jrpc
import tpurpc_torch.rpc as trpc
from tpurpc.codegen import plugin as ref_plugin
from tpurpc.codegen import protobuf_codec as ref_protobuf_codec
from tpurpc.rpc import reflection as ref_reflection
from tpurpc_torch.codegen import plugin as port_plugin
from tpurpc_torch.codegen import protobuf_codec
from tpurpc_torch.rpc import reflection as port_reflection

REPO = Path(__file__).resolve().parent.parent
PKGS = {"ref": jrpc, "port": trpc}
PAIRS = [("ref", "ref"), ("port", "port"), ("ref", "port"), ("port", "ref")]
PAIR_IDS = [f"{c}-to-{s}" for c, s in PAIRS]
PLUGINS = {"ref": ref_plugin, "port": port_plugin}
#: the generated stub module's suffix, by plugin
SUFFIX = {"ref": "_tpurpc", "port": "_tpurpc_torch"}
WAIT_S = 20

DEMO = textwrap.dedent("""\
    syntax = "proto3";
    package torchdemo;

    message Ping { string text = 1; int32 n = 2; }
    message Pong { string text = 1; int32 total = 2; }

    service Greeter {
      rpc Hello (Ping) returns (Pong);
      rpc Tail (Ping) returns (stream Pong);
      rpc Sum (stream Ping) returns (Pong);
      rpc Chat (stream Ping) returns (stream Pong);
    }
    """)
TYPES = textwrap.dedent("""\
    syntax = "proto3";
    package torchshared;
    message Blob { bytes data = 1; }
    """)
SVC = textwrap.dedent("""\
    syntax = "proto3";
    package torchapp;
    import "torch_codegen_types.proto";
    message Ack { int32 size = 1; }
    service Store { rpc Put (torchshared.Blob) returns (Ack); }
    """)
PROTOS = {"torch_codegen_demo.proto": DEMO,
          "torch_codegen_types.proto": TYPES,
          "torch_codegen_svc.proto": SVC}
#: modules the stubs import, by name; dropped from sys.modules at the end
MODULES = ("torch_codegen_demo_pb2", "torch_codegen_types_pb2",
           "torch_codegen_svc_pb2", "torch_codegen_demo_tpurpc",
           "torch_codegen_demo_tpurpc_torch", "torch_codegen_svc_tpurpc",
           "torch_codegen_svc_tpurpc_torch")


def _shim(out: Path, pkg: str) -> Path:
    """An executable protoc plugin that runs ``pkg``'s plugin module."""
    root = "tpurpc" if pkg == "ref" else "tpurpc_torch"
    shim = out / f"protoc-gen-{root}"
    shim.write_text(f"#!/bin/sh\nexec {sys.executable} -m "
                    f"{root}.codegen.plugin\n")
    shim.chmod(0o755)
    return shim


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """protoc once over the three protos: the descriptor set, the
    ``_pb2`` modules, and each plugin's Python stubs (through a shim, as
    protoc runs any plugin). Imports the modules with both reflection
    registries swapped for fresh lists; restores ``sys.path`` and
    ``sys.modules`` at the end."""
    if shutil.which("protoc") is None:
        pytest.skip("protoc is not installed")
    out = tmp_path_factory.mktemp("torch_codegen")
    for name, text in PROTOS.items():
        (out / name).write_text(text)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    desc = out / "set.pb"
    subprocess.run(
        ["protoc", f"--plugin=protoc-gen-tpurpc={_shim(out, 'ref')}",
         f"--plugin=protoc-gen-tpurpc_torch={_shim(out, 'port')}",
         f"--python_out={out}", f"--tpurpc_out={out}",
         f"--tpurpc_torch_out={out}", "--include_imports",
         f"--descriptor_set_out={desc}", f"-I{out}", *PROTOS],
        check=True, env=env, timeout=120)
    assert not any(m in sys.modules for m in MODULES)
    saved_path = list(sys.path)
    sys.path.insert(0, str(out))
    registered = {"ref": [], "port": []}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_reflection, "_GLOBAL_FILES", registered["ref"])
            mp.setattr(port_reflection, "_GLOBAL_FILES", registered["port"])
            mods = {m: importlib.import_module(m) for m in MODULES}
        yield {"dir": out, "set": desc.read_bytes(), "mods": mods,
               "registered": registered}
    finally:
        sys.path[:] = saved_path
        for m in MODULES:
            sys.modules.pop(m, None)


@pytest.fixture(autouse=True)
def fresh_registries(monkeypatch):
    """Both reflection registries are fresh lists for each test."""
    monkeypatch.setattr(ref_reflection, "_GLOBAL_FILES", [])
    monkeypatch.setattr(port_reflection, "_GLOBAL_FILES", [])


def _run_plugin(pkg, request: bytes, monkeypatch) -> bytes:
    """``pkg``'s plugin ``main()`` on ``request`` in this process, with its
    standard input and output swapped for buffers."""
    stdin = io.TextIOWrapper(io.BytesIO(request))
    stdout = io.TextIOWrapper(io.BytesIO())
    with monkeypatch.context() as mp:
        mp.setattr(sys, "stdin", stdin)
        mp.setattr(sys, "stdout", stdout)
        assert PLUGINS[pkg].main() == 0
        stdout.flush()
    return stdout.buffer.getvalue()


def _generate(compiled, parameter, monkeypatch):
    """Both plugins on one CodeGeneratorRequest for every proto; returns
    ``{pkg: {file name: content}}`` and each response's error."""
    from google.protobuf import descriptor_pb2
    from google.protobuf.compiler import plugin_pb2

    files = descriptor_pb2.FileDescriptorSet.FromString(compiled["set"]).file
    request = plugin_pb2.CodeGeneratorRequest(
        file_to_generate=list(PROTOS), parameter=parameter)
    request.proto_file.extend(files)
    raw = request.SerializeToString()
    got, errors = {}, {}
    for pkg in ("ref", "port"):
        resp = plugin_pb2.CodeGeneratorResponse.FromString(
            _run_plugin(pkg, raw, monkeypatch))
        got[pkg] = {f.name: f.content for f in resp.file}
        errors[pkg] = resp.error
    return got, errors


def test_plugin_output_equals_reference_but_names(compiled, monkeypatch):
    """Python stubs: the reference's with ``tpurpc`` read as
    ``tpurpc_torch`` (the imports and the header) and the file's suffix;
    and what protoc wrote through the shim is the same text."""
    got, errors = _generate(compiled, "", monkeypatch)
    assert errors == {"ref": "", "port": ""}
    assert sorted(got["ref"]) == ["torch_codegen_demo_tpurpc.py",
                                  "torch_codegen_svc_tpurpc.py"]
    assert sorted(got["port"]) == ["torch_codegen_demo_tpurpc_torch.py",
                                   "torch_codegen_svc_tpurpc_torch.py"]
    for name, text in got["ref"].items():
        port_name = name[:-len("_tpurpc.py")] + "_tpurpc_torch.py"
        assert got["port"][port_name] == text.replace("tpurpc",
                                                      "tpurpc_torch")
        assert (compiled["dir"] / port_name).read_text() == \
            got["port"][port_name]
        assert (compiled["dir"] / name).read_text() == text
    demo = got["port"]["torch_codegen_demo_tpurpc_torch.py"]
    assert "import tpurpc_torch.rpc as _tps\n" in demo
    assert "tpurpc." not in demo.replace("tpurpc_torch.", "")


def test_plugin_cpp_output_equals_reference(compiled, monkeypatch):
    got, errors = _generate(compiled, "cpp", monkeypatch)
    assert errors == {"ref": "", "port": ""}
    assert sorted(got["port"]) == ["torch_codegen_demo_tpurpc.pb.h",
                                   "torch_codegen_svc_tpurpc.pb.h"]
    assert got["port"] == got["ref"]


def test_plugin_refuses_an_unknown_parameter_as_the_reference(compiled,
                                                              monkeypatch):
    got, errors = _generate(compiled, "rust", monkeypatch)
    assert errors["port"] == errors["ref"] == \
        "unknown tpurpc codegen parameter 'rust'"
    assert got == {"ref": {}, "port": {}}


def test_stub_modules_of_both_plugins_live_side_by_side(compiled):
    """The divergence in the output's name: both packages' stubs of one
    proto are distinct modules, each on its own package's runtime, and
    their import registered the protos' descriptors with their own
    package's reflection only."""
    mods = compiled["mods"]
    ref_mod = mods["torch_codegen_demo_tpurpc"]
    port_mod = mods["torch_codegen_demo_tpurpc_torch"]
    assert ref_mod is not port_mod
    assert ref_mod._tps is jrpc and port_mod._tps is trpc
    assert ref_mod._tps_reflection is ref_reflection
    assert port_mod._tps_reflection is port_reflection
    pb2 = mods["torch_codegen_demo_pb2"]
    reg = compiled["registered"]
    assert pb2.DESCRIPTOR.serialized_pb in reg["port"]
    assert reg["port"] == reg["ref"]


class _GreeterImpl:
    def __init__(self, pb2):
        self.pb2 = pb2

    def Hello(self, request, context):
        return self.pb2.Pong(text=f"hello {request.text}", total=request.n)

    def Tail(self, request, context):
        for i in range(request.n):
            yield self.pb2.Pong(text=request.text, total=i)

    def Sum(self, request_iterator, context):
        return self.pb2.Pong(text="sum",
                             total=sum(r.n for r in request_iterator))

    def Chat(self, request_iterator, context):
        for r in request_iterator:
            yield self.pb2.Pong(text=f"re:{r.text}", total=r.n)


def _greet(stub, pb2):
    """Every Greeter method once; plain values."""
    pong = stub.Hello(pb2.Ping(text="tpu", n=7), timeout=WAIT_S)
    tails = [p.total for p in stub.Tail(pb2.Ping(text="t", n=3),
                                        timeout=WAIT_S)]
    total = stub.Sum(iter([pb2.Ping(n=i) for i in (1, 2, 3)]),
                     timeout=WAIT_S).total
    chats = [(p.text, p.total) for p in stub.Chat(
        iter([pb2.Ping(text="x", n=1), pb2.Ping(text="y", n=2)]),
        timeout=WAIT_S)]
    return (pong.text, pong.total), tails, total, chats


GREETED = (("hello tpu", 7), [0, 1, 2], 6, [("re:x", 1), ("re:y", 2)])


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
def test_generated_stubs_end_to_end(compiled, client, server):
    """Each package's server, its servicer registered by the stubs its own
    package's plugin wrote, called through the other (or the same)
    package's channel and stub."""
    mods = compiled["mods"]
    pb2 = mods["torch_codegen_demo_pb2"]
    srv = PKGS[server].Server(max_workers=4)
    mods[f"torch_codegen_demo{SUFFIX[server]}"].add_GreeterServicer_to_server(
        _GreeterImpl(pb2), srv)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with PKGS[client].Channel(f"127.0.0.1:{port}") as ch:
            stub = mods[f"torch_codegen_demo{SUFFIX[client]}"].GreeterStub(ch)
            got = _greet(stub, pb2)
    finally:
        srv.stop(grace=0)
    assert got == GREETED


@pytest.mark.parametrize("stubs", ["ref", "port"])
def test_generated_servicer_base_is_unimplemented(compiled, stubs):
    mods = compiled["mods"]
    pb2 = mods["torch_codegen_demo_pb2"]
    gen = mods[f"torch_codegen_demo{SUFFIX[stubs]}"]
    pkg = PKGS[stubs]
    srv = pkg.Server(max_workers=2)
    gen.add_GreeterServicer_to_server(gen.GreeterServicer(), srv)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with pkg.Channel(f"127.0.0.1:{port}") as ch:
            with pytest.raises(pkg.RpcError) as ei:
                gen.GreeterStub(ch).Hello(pb2.Ping(text="x"), timeout=WAIT_S)
    finally:
        srv.stop(grace=0)
    assert ei.value.code() is pkg.StatusCode.UNIMPLEMENTED
    assert ei.value.details() == "Method Hello not implemented"


@pytest.mark.parametrize("stubs", ["ref", "port"])
def test_plugin_cross_file_message_types(compiled, stubs):
    """A method on a message of an imported file resolves to that file's
    ``_pb2`` module."""
    mods = compiled["mods"]
    svc_pb2, types_pb2 = (mods["torch_codegen_svc_pb2"],
                          mods["torch_codegen_types_pb2"])
    gen = mods[f"torch_codegen_svc{SUFFIX[stubs]}"]
    pkg = PKGS[stubs]

    class Impl(gen.StoreServicer):
        def Put(self, request, context):
            return svc_pb2.Ack(size=len(request.data))

    srv = pkg.Server(max_workers=2)
    gen.add_StoreServicer_to_server(Impl(), srv)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with pkg.Channel(f"127.0.0.1:{port}") as ch:
            ack = gen.StoreStub(ch).Put(types_pb2.Blob(data=b"12345"),
                                        timeout=WAIT_S)
    finally:
        srv.stop(grace=0)
    assert ack.size == 5


def _grpcio_style_module(pb2):
    """The call shapes grpc_tools.protoc emits (grpcio-tools is not
    installed, so the generated text is written out here)."""
    class GreeterStub:
        def __init__(self, channel):
            self.Hello = channel.unary_unary(
                "/torchdemo.Greeter/Hello",
                request_serializer=pb2.Ping.SerializeToString,
                response_deserializer=pb2.Pong.FromString,
                _registered_method=True)
            self.Tail = channel.unary_stream(
                "/torchdemo.Greeter/Tail",
                request_serializer=pb2.Ping.SerializeToString,
                response_deserializer=pb2.Pong.FromString,
                _registered_method=True)
            self.Sum = channel.stream_unary(
                "/torchdemo.Greeter/Sum",
                request_serializer=pb2.Ping.SerializeToString,
                response_deserializer=pb2.Pong.FromString,
                _registered_method=True)
            self.Chat = channel.stream_stream(
                "/torchdemo.Greeter/Chat",
                request_serializer=pb2.Ping.SerializeToString,
                response_deserializer=pb2.Pong.FromString,
                _registered_method=True)

    def add_GreeterServicer_to_server(servicer, server):
        handlers = {
            "Hello": grpc.unary_unary_rpc_method_handler(
                servicer.Hello, request_deserializer=pb2.Ping.FromString,
                response_serializer=pb2.Pong.SerializeToString),
            "Tail": grpc.unary_stream_rpc_method_handler(
                servicer.Tail, request_deserializer=pb2.Ping.FromString,
                response_serializer=pb2.Pong.SerializeToString),
            "Sum": grpc.stream_unary_rpc_method_handler(
                servicer.Sum, request_deserializer=pb2.Ping.FromString,
                response_serializer=pb2.Pong.SerializeToString),
            "Chat": grpc.stream_stream_rpc_method_handler(
                servicer.Chat, request_deserializer=pb2.Ping.FromString,
                response_serializer=pb2.Pong.SerializeToString),
        }
        generic = grpc.method_handlers_generic_handler("torchdemo.Greeter",
                                                       handlers)
        server.add_generic_rpc_handlers((generic,))
        server.add_registered_method_handlers("torchdemo.Greeter", handlers)

    return GreeterStub, add_GreeterServicer_to_server


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_stock_grpcio_generated_shapes_run(compiled, pkg):
    """A grpc_tools-shaped module drives each package's server and channel
    unchanged, and a stock grpcio channel calls the same server over h2."""
    pb2 = compiled["mods"]["torch_codegen_demo_pb2"]
    GreeterStub, add_to_server = _grpcio_style_module(pb2)
    srv = PKGS[pkg].Server(max_workers=4)
    add_to_server(_GreeterImpl(pb2), srv)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with PKGS[pkg].Channel(f"127.0.0.1:{port}") as ch:
            got = _greet(GreeterStub(ch), pb2)
        with grpc.insecure_channel(f"127.0.0.1:{port}") as gch:
            stock = _greet(GreeterStub(gch), pb2)
    finally:
        srv.stop(grace=0)
    assert got == stock == GREETED


def _pool_classes(compiled):
    """Ping and Pong from a private DescriptorPool: nothing enters the
    default pool."""
    from google.protobuf import descriptor_pb2, descriptor_pool
    from google.protobuf import message_factory

    pool = descriptor_pool.DescriptorPool()
    for fd in descriptor_pb2.FileDescriptorSet.FromString(
            compiled["set"]).file:
        pool.Add(fd)
    return [message_factory.GetMessageClass(
        pool.FindMessageTypeByName(f"torchdemo.{name}"))
        for name in ("Ping", "Pong")]


def test_protobuf_codec_roundtrip_as_the_reference(compiled):
    Ping, _ = _pool_classes(compiled)
    ser, deser = protobuf_codec(Ping)
    ref_ser, ref_deser = ref_protobuf_codec(Ping)
    msg = Ping(text="abc", n=42)
    wire = ser(msg)
    assert wire == ref_ser(msg)
    back = deser(memoryview(wire))    # views, as the rpc layer delivers
    assert (back.text, back.n) == (ref_deser(memoryview(wire)).text, 42)
    assert deser.__name__ == ref_deser.__name__ == "parse_Ping"


@pytest.mark.parametrize("server", ["ref", "port"])
def test_protobuf_codec_with_handlers(compiled, server):
    """The port's codec on the port's channel, against each package's
    server using that package's codec."""
    Ping, Pong = _pool_classes(compiled)
    codec = {"ref": ref_protobuf_codec, "port": protobuf_codec}[server]
    _, ping_deser = codec(Ping)
    pong_ser, _ = codec(Pong)
    pkg = PKGS[server]
    srv = pkg.Server(max_workers=2)
    srv.add_method("/torchdemo.Greeter/Hello",
                   pkg.unary_unary_rpc_method_handler(
                       lambda req, ctx: Pong(text=req.text.upper(),
                                             total=req.n),
                       request_deserializer=ping_deser,
                       response_serializer=pong_ser))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        ping_ser, _ = protobuf_codec(Ping)
        _, pong_deser = protobuf_codec(Pong)
        with trpc.Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary("/torchdemo.Greeter/Hello", ping_ser,
                                pong_deser)
            pong = mc(Ping(text="up", n=9), timeout=WAIT_S)
    finally:
        srv.stop(grace=0)
    assert (pong.text, pong.total) == ("UP", 9)


def test_codegen_imports_protobuf_only_in_main():
    """Importing ``tpurpc_torch.codegen`` never needs protobuf (the card's
    machine has none): no module-level import of ``google``."""
    root = REPO / "tpurpc_torch" / "codegen"
    for path in (root / "__init__.py", root / "plugin.py"):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] in ("google", "grpc", "tpurpc")
                           for n in names), (path.name, names)
