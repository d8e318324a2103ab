"""gRPC wire plane: HTTP/2 + HPACK, so stock gRPC clients reach a port
server and the port's ``H2Channel`` reaches stock gRPC servers. A copy of
``tpurpc/wire/``."""
