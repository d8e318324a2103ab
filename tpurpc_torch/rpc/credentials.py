"""Channel and server credentials: TLS for every transport, grpcio-shaped.

A copy of ``tpurpc/rpc/credentials.py``. :func:`ssl_server_credentials` and
:func:`ssl_channel_credentials` build ``ssl.SSLContext`` objects that the
endpoint factory consumes: a TCP connection is wrapped whole; a ring
connection (the device-ring platform included) runs its address bootstrap
over the TLS socket and keeps it as the encrypted notify and liveness
channel, while the ring payload stays in shared memory or on the card. Both
contexts offer ALPN ``h2`` and require TLS 1.2 at least.

The API mirrors ``grpc.ssl_server_credentials`` /
``grpc.ssl_channel_credentials``, so porting a grpcio program is mechanical.
"""

from __future__ import annotations

import ssl
import tempfile
from typing import Optional, Sequence, Tuple


class ServerCredentials:
    """Opaque server-side credentials (grpcio's ServerCredentials analog)."""

    def __init__(self, context: ssl.SSLContext):
        self._context = context


class ChannelCredentials:
    """Opaque client-side credentials (grpcio's ChannelCredentials analog)."""

    def __init__(self, context: ssl.SSLContext,
                 override_hostname: Optional[str] = None):
        self._context = context
        self._override_hostname = override_hostname


def _load_chain(ctx: ssl.SSLContext, key_pem: bytes, cert_pem: bytes) -> None:
    # ssl only loads cert chains from files; stage the PEMs in a private
    # tempfile pair for the duration of the load.
    with tempfile.NamedTemporaryFile(suffix=".pem") as certf, \
            tempfile.NamedTemporaryFile(suffix=".pem") as keyf:
        certf.write(cert_pem)
        certf.flush()
        keyf.write(key_pem)
        keyf.flush()
        ctx.load_cert_chain(certf.name, keyf.name)


def ssl_server_credentials(
        private_key_certificate_chain_pairs: Sequence[Tuple[bytes, bytes]],
        root_certificates: Optional[bytes] = None,
        require_client_auth: bool = False) -> ServerCredentials:
    """grpcio-shaped: [(private_key_pem, cert_chain_pem)], optional client CA.

    ALPN advertises h2 so stock gRPC-over-TLS clients negotiate cleanly;
    the port's own clients are sniffed after the handshake as on insecure
    ports. Only roots without ``require_client_auth`` asks for a client
    certificate and accepts a connection without one (``CERT_OPTIONAL``).
    """
    if not private_key_certificate_chain_pairs:
        raise ValueError("at least one (key, cert-chain) pair required")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    for key_pem, cert_pem in private_key_certificate_chain_pairs:
        _load_chain(ctx, key_pem, cert_pem)
    if root_certificates is not None:
        ctx.load_verify_locations(cadata=root_certificates.decode())
    if require_client_auth:
        if root_certificates is None:
            raise ValueError("require_client_auth needs root_certificates")
        ctx.verify_mode = ssl.CERT_REQUIRED
    elif root_certificates is not None:
        ctx.verify_mode = ssl.CERT_OPTIONAL
    try:
        ctx.set_alpn_protocols(["h2"])
    except NotImplementedError:  # pragma: no cover - openssl without ALPN
        pass
    return ServerCredentials(ctx)


def ssl_channel_credentials(
        root_certificates: Optional[bytes] = None,
        private_key: Optional[bytes] = None,
        certificate_chain: Optional[bytes] = None) -> ChannelCredentials:
    """grpcio-shaped: CA bundle + optional client cert (mTLS)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    if root_certificates is not None:
        ctx.load_verify_locations(cadata=root_certificates.decode())
    else:
        ctx.load_default_certs()
    if private_key is not None and certificate_chain is not None:
        _load_chain(ctx, private_key, certificate_chain)
    try:
        ctx.set_alpn_protocols(["h2"])
    except NotImplementedError:  # pragma: no cover
        pass
    return ChannelCredentials(ctx)


def insecure_for_testing_channel_credentials() -> ChannelCredentials:
    """TLS without certificate verification — tests and lab rigs ONLY (the
    grpc.ssl_target_name_override moral equivalent, minus the hostname)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    try:
        ctx.set_alpn_protocols(["h2"])
    except NotImplementedError:  # pragma: no cover
        pass
    return ChannelCredentials(ctx)
