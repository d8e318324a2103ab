"""protoc plugin: generate tpurpc_torch service stubs from .proto files.

A copy of ``tpurpc/codegen/plugin.py``. Usage::

    protoc --plugin=protoc-gen-tpurpc_torch=SHIM \\
           --tpurpc_torch_out=OUT_DIR --python_out=OUT_DIR x.proto

where SHIM is an executable that runs ``python -m
tpurpc_torch.codegen.plugin``. For each file carrying services it emits
``<name>_tpurpc_torch.py`` with, per service: ``<Svc>Stub`` (channel-side
multicallables), ``<Svc>Servicer`` (override-me base), and
``add_<Svc>Servicer_to_server`` — the trio grpcio's plugin generates,
shaped for this package's runtime. The sibling ``*_pb2.py`` from
--python_out provides the message classes.

The module's name differs from the reference plugin's ``<name>_tpurpc.py``
so that stubs generated for both packages from one proto never take each
other's place in ``sys.modules``. ``--tpurpc_torch_out=cpp:DIR`` emits
``<name>_tpurpc.pb.h``, C++ stubs over the native application API, the
same bytes as the reference plugin's.

The generator walks the CodeGeneratorRequest protobuf on stdin and writes a
CodeGeneratorResponse on stdout, per the protoc plugin contract.
"""

from __future__ import annotations

import sys

_SHAPES = {
    (False, False): "unary_unary",
    (False, True): "unary_stream",
    (True, False): "stream_unary",
    (True, True): "stream_stream",
}


def _pb2_module(proto_name: str) -> str:
    return proto_name[:-len(".proto")].replace("/", ".").replace("-", "_") \
        + "_pb2"


def build_type_map(proto_files):
    """(type→file, file→package) across the whole CodeGeneratorRequest:
    service methods may use messages from IMPORTED files (well-known types,
    shared message protos), which must resolve to THEIR pb2 module, not the
    service file's."""
    type_map = {}
    file_packages = {}

    def walk(prefix, msgs, fname):
        for msg in msgs:
            full = f"{prefix}.{msg.name}"
            type_map[full] = fname
            walk(full, msg.nested_type, fname)

    for fd in proto_files:
        file_packages[fd.name] = fd.package
        prefix = f".{fd.package}" if fd.package else ""
        walk(prefix, fd.message_type, fd.name)
    return type_map, file_packages


def _message_ref(type_name: str, type_map: dict, file_packages: dict,
                 aliases: dict) -> str:
    """Fully-qualified '.pkg.Msg.Nested' → 'alias.Msg.Nested' on the pb2
    module of the DEFINING file."""
    fname = type_map[type_name]
    name = type_name.lstrip(".")
    pkg = file_packages[fname]
    if pkg and name.startswith(pkg + "."):
        name = name[len(pkg) + 1:]
    return f"{aliases[fname]}.{name}"


def generate_file(fd, type_map: dict, file_packages: dict) -> str:
    """Source of <name>_tpurpc_torch.py for one FileDescriptorProto."""
    pkg = fd.package
    # alias every pb2 module any method type resolves to
    needed = {fd.name}
    for svc in fd.service:
        for m in svc.method:
            for t in (m.input_type, m.output_type):
                needed.add(type_map.get(t, fd.name))
    aliases = {fname: f"_pb2_{i}" for i, fname in enumerate(sorted(needed))}
    out = [
        '"""Generated by the tpurpc_torch protoc plugin. DO NOT EDIT."""',
        "",
        "import tpurpc_torch.rpc as _tps",
        "from tpurpc_torch.rpc import reflection as _tps_reflection",
        "",
    ]
    out += [f"import {_pb2_module(fname)} as {alias}"
            for fname, alias in sorted(aliases.items())]
    out += [
        "",
        "# reflection: describe/file_containing_symbol work out of the box",
        "_tps_reflection.register_module_descriptors([",
    ]
    out += [f"    {alias}.DESCRIPTOR.serialized_pb,"
            for _fname, alias in sorted(aliases.items())]
    out += ["])", ""]
    for svc in fd.service:
        full = f"{pkg}.{svc.name}" if pkg else svc.name
        # ---- stub ----------------------------------------------------------
        out += [
            "",
            f"class {svc.name}Stub:",
            f'    """Client stub for {full}."""',
            "",
            "    def __init__(self, channel):",
        ]
        for m in svc.method:
            shape = _SHAPES[(m.client_streaming, m.server_streaming)]
            resp = _message_ref(m.output_type, type_map, file_packages,
                                aliases)
            out += [
                f"        self.{m.name} = channel.{shape}(",
                f"            '/{full}/{m.name}',",
                f"            request_serializer=lambda m: m.SerializeToString(),",
                f"            response_deserializer="
                f"lambda b: {resp}.FromString(bytes(b)))",
            ]
        # ---- servicer base -------------------------------------------------
        out += [
            "",
            "",
            f"class {svc.name}Servicer:",
            f'    """Override the methods you implement ({full})."""',
        ]
        for m in svc.method:
            arg = ("request_iterator" if m.client_streaming else "request")
            out += [
                "",
                f"    def {m.name}(self, {arg}, context):",
                "        context.abort(_tps.StatusCode.UNIMPLEMENTED,",
                f"                      'Method {m.name} not implemented')",
            ]
        # ---- registration --------------------------------------------------
        out += [
            "",
            "",
            f"def add_{svc.name}Servicer_to_server(servicer, server):",
            "    handlers = {",
        ]
        for m in svc.method:
            shape = _SHAPES[(m.client_streaming, m.server_streaming)]
            req = _message_ref(m.input_type, type_map, file_packages,
                               aliases)
            out += [
                f"        '{m.name}': _tps.{shape}_rpc_method_handler(",
                f"            servicer.{m.name},",
                f"            request_deserializer="
                f"lambda b: {req}.FromString(bytes(b)),",
                f"            response_serializer="
                f"lambda m: m.SerializeToString()),",
            ]
        out += [
            "    }",
            f"    server.add_service('{full}', handlers)",
            "",
        ]
    return "\n".join(out) + "\n"


def _cpp_message_ref(type_name: str, type_map: dict, file_packages: dict
                     ) -> str:
    """Fully-qualified '.pkg.Msg.Nested' → '::pkg::Msg_Nested' (protobuf C++
    flattens nested messages with underscores under the package namespace)."""
    fname = type_map[type_name]
    name = type_name.lstrip(".")
    pkg = file_packages[fname]
    if pkg and name.startswith(pkg + "."):
        rest = name[len(pkg) + 1:]
        ns = "::".join(pkg.split("."))
        return f"::{ns}::{rest.replace('.', '_')}"
    return f"::{name.replace('.', '_')}"


def generate_cpp_file(fd, type_map: dict, file_packages: dict) -> str:
    """Source of <name>_tpurpc.pb.h for one FileDescriptorProto — typed C++
    stubs + service bases over the native app API."""
    pkg = fd.package
    needed = {fd.name}
    for svc in fd.service:
        for m in svc.method:
            for t in (m.input_type, m.output_type):
                needed.add(type_map.get(t, fd.name))
    out = [
        "// Generated by the tpurpc protoc plugin (--tpurpc_out=cpp:DIR).",
        "// DO NOT EDIT.",
        "#pragma once",
        "",
        "#include <string>",
        "",
        '#include "tpurpc/client.hpp"',
        '#include "tpurpc/server.h"',
        '#include "tpurpc/typed.hpp"',
        "",
    ]
    for fname in sorted(needed):
        # protoc's C++ generator keeps the filename verbatim (only the
        # .proto suffix changes) — no dash munging, unlike Python modules
        out.append(f'#include "{fname[:-len(".proto")]}.pb.h"')
    ns_parts = pkg.split(".") if pkg else []
    out.append("")
    for part in ns_parts:
        out.append(f"namespace {part} {{")

    def ref(t):
        return _cpp_message_ref(t, type_map, file_packages)

    for svc in fd.service:
        full = f"{pkg}.{svc.name}" if pkg else svc.name
        # ---- client stub ---------------------------------------------------
        out += [
            "",
            f"// Client stub for {full} over tpurpc::Channel.",
            f"class {svc.name}Client {{",
            " public:",
            f"  explicit {svc.name}Client(::tpurpc::Channel &ch) "
            ": ch_(ch) {}",
        ]
        for m in svc.method:
            req, resp = ref(m.input_type), ref(m.output_type)
            path = f"/{full}/{m.name}"
            if not m.client_streaming and not m.server_streaming:
                out += [
                    "",
                    f"  ::tpurpc::Status {m.name}(const {req} &request, "
                    f"{resp} *response, int timeout_ms = 0) {{",
                    f"    auto [st, body] = ch_.UnaryCall(\"{path}\", "
                    "request.SerializeAsString(), timeout_ms);",
                    "    if (st.ok() && !response->ParseFromArray(",
                    "            body.data(), static_cast<int>(body.size())"
                    ")) {",
                    "      st.code = TPR_INTERNAL;",
                    "      st.details = \"response message parse failed\";",
                    "    }",
                    "    return st;",
                    "  }",
                ]
            elif not m.client_streaming:  # server-streaming
                out += [
                    "",
                    f"  // server-streaming: Read() responses, then Finish().",
                    f"  ::tpurpc::TypedCall<{req}, {resp}> {m.name}("
                    f"const {req} &request, int timeout_ms = 0) {{",
                    f"    auto call = ch_.StartCall(\"{path}\", {{}}, "
                    "timeout_ms);",
                    "    call.Write(request.SerializeAsString(), "
                    "/*end_stream=*/true);",
                    f"    return ::tpurpc::TypedCall<{req}, {resp}>("
                    "std::move(call));",
                    "  }",
                ]
            else:  # client-streaming or bidi
                kind = ("bidi" if m.server_streaming else "client-streaming")
                out += [
                    "",
                    f"  // {kind}: Write() requests (WritesDone() when "
                    "finished), Read(), Finish().",
                    f"  ::tpurpc::TypedCall<{req}, {resp}> {m.name}("
                    "int timeout_ms = 0) {",
                    f"    return ::tpurpc::TypedCall<{req}, {resp}>("
                    f"ch_.StartCall(\"{path}\", {{}}, timeout_ms));",
                    "  }",
                ]
        out += [
            "",
            " private:",
            "  ::tpurpc::Channel &ch_;",
            "};",
        ]
        # ---- service base --------------------------------------------------
        out += [
            "",
            f"// Override the methods you implement ({full}); return a",
            "// status code (0 = OK) for the trailers.",
            f"class {svc.name}Service {{",
            " public:",
            f"  virtual ~{svc.name}Service() = default;",
        ]
        for m in svc.method:
            req, resp = ref(m.input_type), ref(m.output_type)
            if not m.client_streaming and not m.server_streaming:
                out.append(f"  virtual int {m.name}(const {req} &, {resp} *)"
                           " { return TPR_UNIMPLEMENTED; }")
            elif not m.client_streaming:
                out.append(f"  virtual int {m.name}(const {req} &, "
                           f"::tpurpc::ServerCall<{req}, {resp}> &)"
                           " { return TPR_UNIMPLEMENTED; }")
            else:
                out.append(f"  virtual int {m.name}("
                           f"::tpurpc::ServerCall<{req}, {resp}> &)"
                           " { return TPR_UNIMPLEMENTED; }")
        out += [
            "",
            "  void RegisterWith(tpr_server *server) {",
        ]
        for m in svc.method:
            out.append(f"    tpr_server_register(server, "
                       f"\"/{full}/{m.name}\", &{svc.name}Service::"
                       f"_{m.name}_Tramp, this);")
        out += [
            "  }",
            "",
            " private:",
        ]
        for m in svc.method:
            req, resp = ref(m.input_type), ref(m.output_type)
            out += [
                f"  static int _{m.name}_Tramp(tpr_server_call *c, "
                "void *ud) {",
                f"    auto *self = static_cast<{svc.name}Service *>(ud);",
                f"    ::tpurpc::ServerCall<{req}, {resp}> call(c);",
            ]
            if not m.client_streaming:
                out += [
                    f"    {req} request;",
                    "    if (!call.Read(&request)) {",
                    "      call.SetDetails(\"malformed or missing request "
                    "message\");",
                    "      return TPR_INTERNAL;",
                    "    }",
                ]
                if not m.server_streaming:
                    out += [
                        f"    {resp} response;",
                        f"    int code = self->{m.name}(request, &response);",
                        "    if (code == 0 && !call.Write(response)) "
                        "return TPR_UNAVAILABLE;",
                        "    return code;",
                    ]
                else:
                    out.append(f"    return self->{m.name}(request, call);")
            else:
                out.append(f"    return self->{m.name}(call);")
            out.append("  }")
        out.append("};")
    out.append("")
    for part in reversed(ns_parts):
        out.append(f"}}  // namespace {part}")
    return "\n".join(out) + "\n"


def main() -> int:
    from google.protobuf.compiler import plugin_pb2

    request = plugin_pb2.CodeGeneratorRequest.FromString(
        sys.stdin.buffer.read())
    response = plugin_pb2.CodeGeneratorResponse()
    response.supported_features = (
        plugin_pb2.CodeGeneratorResponse.FEATURE_PROTO3_OPTIONAL)
    type_map, file_packages = build_type_map(request.proto_file)
    # protoc passes everything before ':' in --tpurpc_torch_out=PARAM:DIR
    # as the request parameter: "" / "python" -> Python stubs, "cpp" -> C++
    # stubs.
    lang = (request.parameter or "python").strip().lower() or "python"
    if lang not in ("python", "cpp"):
        response.error = f"unknown tpurpc codegen parameter {lang!r}"
        sys.stdout.buffer.write(response.SerializeToString())
        return 0
    for fd in request.proto_file:
        if fd.name not in request.file_to_generate or not fd.service:
            continue
        f = response.file.add()
        if lang == "cpp":
            # C++ filenames stay verbatim (protoc cpp_out convention)
            f.name = f"{fd.name[:-len('.proto')]}_tpurpc.pb.h"
            f.content = generate_cpp_file(fd, type_map, file_packages)
        else:
            base = fd.name[:-len(".proto")].replace("-", "_")
            f.name = f"{base}_tpurpc_torch.py"
            f.content = generate_file(fd, type_map, file_packages)
    sys.stdout.buffer.write(response.SerializeToString())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
