"""Codegen and protobuf integration: a copy of ``tpurpc/codegen/``.

Three layers, so an application ports mechanically:

* :func:`protobuf_codec` — runtime (de)serializers from any generated
  protobuf message class; no codegen needed for hand-rolled services.
* **Stock grpcio stubs work unchanged**: modules generated by
  ``python -m grpc_tools.protoc`` call ``channel.unary_unary(path,
  request_serializer=..., _registered_method=True)`` and
  ``server.add_generic_rpc_handlers((generic_handler,))`` — this package's
  Channel/Server accept both shapes (see ``rpc/channel.py`` kwarg
  tolerance and ``rpc/server.py`` grpcio-handler adaptation), so
  ``FooStub(tpurpc_channel)`` and ``add_FooServicer_to_server(s, srv)``
  run as-is.
* :mod:`tpurpc_torch.codegen.plugin` — a ``protoc`` plugin emitting
  stubs for this package (``protoc --plugin=protoc-gen-tpurpc_torch=...
  --tpurpc_torch_out=DIR x.proto`` → ``x_tpurpc_torch.py`` with Stub /
  Servicer / add_to_server), for projects that want tpurpc_torch as the
  only runtime dependency.

Nothing here imports protobuf when the package is imported: the codec
takes any class with protobuf's ``SerializeToString``/``FromString``, and
the plugin imports ``google.protobuf`` only in ``main()``.
"""

from __future__ import annotations

from typing import Tuple


def protobuf_codec(message_class) -> Tuple:
    """(serializer, deserializer) for a generated protobuf message class.

    ``serializer`` accepts an instance (SerializeToString); ``deserializer``
    parses wire bytes/views (FromString). Usable directly as the codec
    arguments of every tpurpc_torch multicallable / method-handler factory."""
    def serialize(msg) -> bytes:
        return msg.SerializeToString()

    def deserialize(buf):
        return message_class.FromString(bytes(buf))

    deserialize.__name__ = f"parse_{message_class.__name__}"
    return serialize, deserialize
