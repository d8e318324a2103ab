"""gRPC Server Reflection (grpc.reflection.v1alpha + v1) for the port's
servers; a copy of ``tpurpc/rpc/reflection.py``.

The standard tooling hook — ``grpcurl list``, ``grpc_cli ls``, IDE explorers
— speaks a bidi stream of ``ServerReflectionRequest``/``Response`` messages
(proto at ``src/proto/grpc/reflection/v1alpha/reflection.proto``). The
wire format is written by hand, as :mod:`tpurpc_torch.rpc.health` does — the handful of
fields involved don't justify a protobuf dependency:

    ServerReflectionRequest {
      string host = 1;
      oneof message_request {
        string file_by_filename = 3;
        string file_containing_symbol = 4;
        ExtensionRequest file_containing_extension = 5;
        string all_extension_numbers_of_type = 6;
        string list_services = 7;
      }
    }
    ServerReflectionResponse {
      string valid_host = 1;
      ServerReflectionRequest original_request = 2;
      oneof message_response {
        FileDescriptorResponse file_descriptor_response = 4;   // repeated bytes fdp = 1
        ExtensionNumberResponse all_extension_numbers_response = 5;
        ListServiceResponse list_services_response = 6;        // repeated ServiceResponse{name=1} = 1
        ErrorResponse error_response = 7;                      // int32 code = 1, string msg = 2
      }
    }

``list_services`` is answered from the server's registered method table (the
part every tool needs); descriptor lookups are answered from an optional
registry filled via :func:`ServerReflection.add_file_descriptor_protos`
(serialized ``FileDescriptorProto`` bytes, e.g. from generated
``*_pb2.DESCRIPTOR.serialized_pb``) and return NOT_FOUND otherwise, exactly
like a C++ server built without the descriptor pool entries.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional

from tpurpc_torch.rpc.server import Server, stream_stream_rpc_method_handler

from tpurpc_torch.wire.protowire import encode_varint as _varint
from tpurpc_torch.wire.protowire import fields as _fields
from tpurpc_torch.wire.protowire import ld as _ld

V1ALPHA_SERVICE = "grpc.reflection.v1alpha.ServerReflection"
V1_SERVICE = "grpc.reflection.v1.ServerReflection"


class _Request:
    """Decoded ServerReflectionRequest (which_oneof, argument)."""

    ONEOF = {3: "file_by_filename", 4: "file_containing_symbol",
             5: "file_containing_extension",
             6: "all_extension_numbers_of_type", 7: "list_services"}

    def __init__(self, raw: bytes):
        self.raw = bytes(raw)
        self.host = ""
        self.kind: Optional[str] = None
        self.arg = b""
        for field_no, wt, val in _fields(self.raw):
            if field_no == 1:
                self.host = bytes(val).decode("utf-8", "replace")
            elif field_no in self.ONEOF:
                if wt != 2:
                    # every oneof arm is a string/message: length-delimited
                    # only. A varint here is a malformed request, not a
                    # lookup that happens to miss.
                    raise ValueError(
                        f"oneof field {field_no} has wire type {wt}")
                self.kind = self.ONEOF[field_no]
                self.arg = bytes(val)


#: process-global descriptor registry: a module registers its serialized
#: pb2 files (:func:`register_module_descriptors`), so every reflection
#: servicer created afterwards can answer describe/file_containing_symbol
#: with no manual wiring (grpcio gets this from the protobuf descriptor
#: pool; this is its explicit equivalent)
_GLOBAL_FILES: list = []
_GLOBAL_LOCK = threading.Lock()


def register_module_descriptors(serialized) -> None:
    """Add serialized FileDescriptorProtos to the process-global registry
    (idempotent by content)."""
    with _GLOBAL_LOCK:
        for raw in serialized:
            raw = bytes(raw)
            if raw not in _GLOBAL_FILES:
                _GLOBAL_FILES.append(raw)


class ServerReflection:
    """The servicer. Attach with :func:`enable_server_reflection`."""

    NOT_FOUND = 5  # grpc status code carried in ErrorResponse.error_code

    def __init__(self, server: Server):
        self._server = server
        self._lock = threading.Lock()
        #: filename -> serialized FileDescriptorProto
        self._files: Dict[str, bytes] = {}
        #: symbol (pkg.Msg / pkg.Svc / pkg.Svc.Method) -> filename
        self._symbols: Dict[str, str] = {}
        with _GLOBAL_LOCK:
            seed = list(_GLOBAL_FILES)
        if seed:
            self.add_file_descriptor_protos(seed)

    # -- descriptor registry -------------------------------------------------

    def add_file_descriptor_protos(self, serialized: List[bytes]) -> None:
        """Register serialized FileDescriptorProtos (e.g.
        ``mod_pb2.DESCRIPTOR.serialized_pb``) for descriptor lookups."""
        for raw in serialized:
            name, symbols = _index_fdp(raw)
            with self._lock:
                self._files[name] = bytes(raw)
                for s in symbols:
                    self._symbols[s] = name

    # -- service list --------------------------------------------------------

    def _service_names(self) -> List[str]:
        names = set()
        for path in self._server._methods:
            #  "/pkg.Service/Method" -> "pkg.Service"
            svc = path.rsplit("/", 1)[0].lstrip("/")
            if svc:
                names.add(svc)
        return sorted(names)

    # -- the RPC -------------------------------------------------------------

    def _info(self, request_iterator: Iterator[bytes], ctx) -> Iterator[bytes]:
        for raw in request_iterator:
            try:
                req = _Request(raw)
            except ValueError:
                yield _ld(7, _varint((1 << 3) | 0) + _varint(3)  # INVALID_ARG
                          + _ld(2, b"malformed ServerReflectionRequest"))
                continue
            body = self._answer(req)
            # valid_host(1) + original_request(2) + the answer
            yield (_ld(1, req.host.encode()) + _ld(2, req.raw) + body)

    def _answer(self, req: _Request) -> bytes:
        if req.kind == "list_services":
            services = b"".join(
                _ld(1, _ld(1, name.encode()))        # ServiceResponse.name
                for name in self._service_names())
            return _ld(6, services)                   # list_services_response
        if req.kind in ("file_by_filename", "file_containing_symbol"):
            key = req.arg.decode("utf-8", "replace")
            with self._lock:
                if req.kind == "file_by_filename":
                    raw = self._files.get(key)
                else:
                    raw = self._files.get(self._symbols.get(key, ""))
            if raw is not None:
                return _ld(4, _ld(1, raw))            # file_descriptor_response
            return self._error(f"{req.kind} not found: {key!r}")
        if req.kind == "all_extension_numbers_of_type":
            return self._error("extensions not supported")
        if req.kind == "file_containing_extension":
            return self._error("extensions not supported")
        return self._error("no message_request set")

    def _error(self, msg: str) -> bytes:
        return _ld(7, bytes([1 << 3]) + _varint(self.NOT_FOUND)
                   + _ld(2, msg.encode()))


def _index_fdp(raw: bytes):
    """Minimal FileDescriptorProto scan: name(1), package(2),
    message_type(4).name(1), service(6){name(1), method(2).name(1)}."""
    name = ""
    package = ""
    messages: List[str] = []
    services: List[tuple] = []
    for field_no, _wt, val in _fields(bytes(raw)):
        if field_no == 1:
            name = bytes(val).decode()
        elif field_no == 2:
            package = bytes(val).decode()
        elif field_no == 4:  # DescriptorProto
            for f2, _w2, v2 in _fields(bytes(val)):
                if f2 == 1:
                    messages.append(bytes(v2).decode())
                    break
        elif field_no == 6:  # ServiceDescriptorProto
            sname, methods = "", []
            for f2, _w2, v2 in _fields(bytes(val)):
                if f2 == 1:
                    sname = bytes(v2).decode()
                elif f2 == 2:  # MethodDescriptorProto
                    for f3, _w3, v3 in _fields(bytes(v2)):
                        if f3 == 1:
                            methods.append(bytes(v3).decode())
                            break
            services.append((sname, methods))
    prefix = package + "." if package else ""
    symbols = [prefix + m for m in messages]
    for sname, methods in services:
        symbols.append(prefix + sname)
        symbols.extend(f"{prefix}{sname}.{m}" for m in methods)
    return name, symbols


def enable_server_reflection(server: Server) -> ServerReflection:
    """Attach reflection under both the v1alpha and v1 service names
    (grpcurl probes v1 first, falls back to v1alpha)."""
    servicer = ServerReflection(server)
    handler = stream_stream_rpc_method_handler(servicer._info)
    for svc in (V1ALPHA_SERVICE, V1_SERVICE):
        server.add_method(f"/{svc}/ServerReflectionInfo", handler)
    return servicer
