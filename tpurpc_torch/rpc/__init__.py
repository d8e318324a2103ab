"""tpurpc_torch.rpc — status codes, framing, server and channel.

The grpcio-shaped surface of ``tpurpc/rpc/__init__.py``, limited to what
the port has, so that a grpcio-style program runs against
``import tpurpc_torch.rpc as grpc``:

    channel = grpc.insecure_channel("host:port")
    reply = channel.unary_unary("/demo.Greeter/SayHello")(b"world", timeout=5)

    srv = grpc.server()
    srv.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "demo.Greeter", {"SayHello": grpc.unary_unary_rpc_method_handler(fn)}),))
    srv.add_insecure_port("0.0.0.0:50051"); srv.start()

A channel takes a service config (per-method timeout, waitForReady,
retryPolicy or hedgingPolicy, retryThrottling) from its resolver, from
``update_service_config`` or from the ``grpc.service_config`` option, or
explicit ``retry_policy=RetryPolicy(...)`` / ``hedging_policy=`` arguments;
``server(interceptors=[...])`` and ``intercept_channel`` take grpcio-shaped
interceptors, and ``FaultInjector`` injects aborts and delays.
``secure_channel`` / ``Server.add_secure_port`` with
``ssl_channel_credentials`` / ``ssl_server_credentials`` run TLS (and mTLS)
on every platform; ``enable_server_reflection`` and ``enable_channelz``
serve grpc.reflection and grpc.channelz.v1 on a server.
``Channel.get_state`` reads ``ChannelConnectivity``, ``channel_ready_future``
waits for READY, and ``inproc_channel(server)`` is the in-process
transport.
``LoadBalancerServicer`` and ``enable_lookaside`` are look-aside load
balancing (grpclb): a balancer streams server lists and a watcher moves
the channel's membership with them; ``xds:///service`` targets
(``tpurpc_torch/rpc/xds.py``) follow an xDS control plane's EDS updates.

``H2Channel`` (``tpurpc_torch/wire/h2_client.py``) is exported lazily, as
the reference does: an eager import here would make a program that imports
``tpurpc_torch.wire.grpc_h2`` first meet this package mid-cycle. ``aio``
(the asyncio surface, ``grpc.aio``'s analog) is lazy too and stays out of
``__all__``, so the sync path never pays the asyncio import.
"""

from tpurpc_torch.rpc.status import (AbortError, ChannelConnectivity,
                                     Metadata, RpcError, StatusCode)
from tpurpc_torch.rpc.channel import (Channel, RetryPolicy,
                                      channel_ready_future, insecure_channel,
                                      secure_channel)
from tpurpc_torch.rpc.credentials import (
    ChannelCredentials,
    ServerCredentials,
    insecure_for_testing_channel_credentials,
    ssl_channel_credentials,
    ssl_server_credentials,
)
from tpurpc_torch.rpc.server import (
    RpcMethodHandler,
    Server,
    ServerContext,
    inproc_channel,
    method_handlers_generic_handler,
    stream_stream_rpc_method_handler,
    stream_unary_rpc_method_handler,
    unary_stream_rpc_method_handler,
    unary_unary_rpc_method_handler,
)
from tpurpc_torch.rpc.interceptors import (ClientInterceptor, FaultConfig,
                                           FaultInjector, ServerInterceptor,
                                           intercept_channel)
from tpurpc_torch.rpc.resolver import register_resolver, ring_hash_key
from tpurpc_torch.rpc.health import add_health_servicer
from tpurpc_torch.rpc.reflection import enable_server_reflection
from tpurpc_torch.rpc.lookaside import LoadBalancerServicer, enable_lookaside
from tpurpc_torch.rpc.channelz_v1 import enable_channelz
from tpurpc_torch.rpc import server  # the module, callable as server()

__all__ = [
    "AbortError", "ChannelConnectivity", "Metadata", "RpcError", "StatusCode",
    "Channel", "channel_ready_future", "insecure_channel",
    "Server", "ServerContext", "RpcMethodHandler", "server", "inproc_channel",
    "method_handlers_generic_handler",
    "unary_unary_rpc_method_handler", "unary_stream_rpc_method_handler",
    "stream_unary_rpc_method_handler", "stream_stream_rpc_method_handler",
    "register_resolver", "ring_hash_key", "add_health_servicer",
    "ClientInterceptor", "FaultConfig", "FaultInjector",
    "ServerInterceptor", "intercept_channel", "RetryPolicy",
    "H2Channel",
    "secure_channel", "ChannelCredentials", "ServerCredentials",
    "ssl_channel_credentials", "ssl_server_credentials",
    "insecure_for_testing_channel_credentials",
    "enable_server_reflection", "enable_channelz",
    "LoadBalancerServicer", "enable_lookaside",
]


def __getattr__(name):
    if name == "H2Channel":
        from tpurpc_torch.wire.h2_client import H2Channel

        return H2Channel
    if name == "aio":
        import tpurpc_torch.rpc.aio as aio

        return aio
    raise AttributeError(f"module 'tpurpc_torch.rpc' has no attribute {name!r}")
