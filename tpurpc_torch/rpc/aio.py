"""asyncio surface: async servers and channels over the threaded core.

A copy of ``tpurpc/rpc/aio.py``, the ``grpc.aio`` analog: async handlers
and awaitable calls, so a serving process overlaps host IO with device
work. While one handler awaits a device result (or a downstream RPC),
every other handler keeps running on the same event loop.

The layer bridges rather than re-implementing the transport on asyncio:
the threaded data plane (endpoint readers, frame writers, ring pollers)
is unchanged, and the asyncio layer adapts at the call boundary:

* server: async behaviors are scheduled onto the server's event loop via
  ``run_coroutine_threadsafe``; the dispatching pool worker parks on the
  future while every async handler interleaves on the loop. Concurrency
  is bounded by ``max_workers`` as in the sync server.
* client: awaitable multicallables run the blocking call machinery on a
  dedicated thread per call; streaming responses arrive as async
  iterators.

Four call shapes on both sides, secure ports and channels included.

Not here: the reference's ``NativeChannel`` (its async face of the C
core's client, which comes with the port of the C core). Unlike the
reference's, :func:`server` passes ``interceptors`` to the server.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, AsyncIterator, Callable, Iterator, Optional

import importlib

# by module path, as the reference does: the package's grpcio-shaped
# server() and insecure_channel() share the submodules' names
_server_mod = importlib.import_module("tpurpc_torch.rpc.server")
_channel_mod = importlib.import_module("tpurpc_torch.rpc.channel")
from tpurpc_torch.rpc.status import Deserializer, Metadata, Serializer
from tpurpc_torch.rpc.status import identity_codec as _identity

__all__ = ["Server", "Channel", "server", "insecure_channel",
           "secure_channel", "unary_unary_rpc_method_handler",
           "unary_stream_rpc_method_handler",
           "stream_unary_rpc_method_handler",
           "stream_stream_rpc_method_handler"]


# ---------------------------------------------------------------------------
# Handler factories: same taxonomy, async behaviors.
# ---------------------------------------------------------------------------

class _AioHandler:
    """Marker wrapper: an async behavior + codecs, adapted at registration."""

    __slots__ = ("kind", "behavior", "request_deserializer",
                 "response_serializer")

    def __init__(self, kind: str, behavior: Callable,
                 request_deserializer: Deserializer = _identity,
                 response_serializer: Serializer = _identity):
        self.kind = kind
        self.behavior = behavior
        self.request_deserializer = request_deserializer
        self.response_serializer = response_serializer


def unary_unary_rpc_method_handler(behavior, request_deserializer=_identity,
                                   response_serializer=_identity):
    return _AioHandler("unary_unary", behavior, request_deserializer,
                       response_serializer)


def unary_stream_rpc_method_handler(behavior, request_deserializer=_identity,
                                    response_serializer=_identity):
    return _AioHandler("unary_stream", behavior, request_deserializer,
                       response_serializer)


def stream_unary_rpc_method_handler(behavior, request_deserializer=_identity,
                                    response_serializer=_identity):
    return _AioHandler("stream_unary", behavior, request_deserializer,
                       response_serializer)


def stream_stream_rpc_method_handler(behavior, request_deserializer=_identity,
                                     response_serializer=_identity):
    return _AioHandler("stream_stream", behavior, request_deserializer,
                       response_serializer)


class _LoopRef:
    """The server's event loop, captured at ``await server.start()``; sync
    adapters read it at call time (registration happens before start)."""

    __slots__ = ("loop",)

    def __init__(self):
        self.loop: Optional[asyncio.AbstractEventLoop] = None


# ---------------------------------------------------------------------------
# Blocking↔async bridging primitives.
#
# NEVER the loop's default executor for indefinite waits: it is a small
# shared pool (min(32, cpu+4) threads), and N concurrent streams parking
# blocking reads there deadlock the whole loop once N exceeds it. Every
# indefinitely-blocking wait below gets a DEDICATED daemon thread, and
# every cross-thread future wait is guarded against the loop stopping
# underneath it.
# ---------------------------------------------------------------------------

class _Raise:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


def _guarded_result(fut, loop, what: str):
    """``concurrent.futures.Future.result()`` that cannot outlive the loop:
    polls in short slices and bails (cancelling the work) if the loop closed
    — otherwise a stopped ``asyncio.run()`` strands the waiting thread
    forever."""
    import concurrent.futures as cf

    while True:
        try:
            return fut.result(timeout=0.5)
        except cf.TimeoutError:
            if loop.is_closed() or not loop.is_running():
                fut.cancel()
                raise RuntimeError(f"event loop stopped while awaiting {what}")


async def _call_in_thread(fn):
    """Run a blocking callable on its own daemon thread; await the outcome."""
    loop = asyncio.get_running_loop()
    fut: asyncio.Future = loop.create_future()

    def _deliver(setter, value):
        if not fut.cancelled():
            setter(value)

    def work():
        try:
            res = fn()
        except BaseException as exc:
            try:
                loop.call_soon_threadsafe(_deliver, fut.set_exception, exc)
            except RuntimeError:
                pass  # loop closed: nobody is waiting anymore
        else:
            try:
                loop.call_soon_threadsafe(_deliver, fut.set_result, res)
            except RuntimeError:
                pass

    threading.Thread(target=work, daemon=True, name="tpurpc-aio-call").start()
    return await fut


def _sync_to_async_iter(make_iter: Callable[[], Any]) -> AsyncIterator:
    """Blocking iterable → async iterator via ONE dedicated pump thread.

    The pump owns the sync iterator's frame, so abandonment cleanup is safe
    and complete: when the async consumer drops the generator, the pump
    cancels the underlying Call (if the source has ``cancel``) and closes
    the iterator, releasing transport credits instead of leaking a parked
    thread. Bounded queue = backpressure toward the producer."""
    _DONE = object()

    async def gen():
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue(8)
        state = {"dropped": False}

        def put_item(item) -> bool:
            import concurrent.futures as cf

            fut = asyncio.run_coroutine_threadsafe(q.put(item), loop)
            while True:
                try:
                    fut.result(timeout=0.5)
                    return True
                except cf.TimeoutError:
                    if (state["dropped"] or loop.is_closed()
                            or not loop.is_running()):
                        fut.cancel()
                        return False

        def pump():
            src = None
            it = None
            try:
                src = make_iter()  # may block (opens the call)
                it = iter(src)
                for item in it:
                    if state["dropped"] or not put_item(item):
                        break
                else:
                    put_item(_DONE)
                    return
            except BaseException as exc:  # delivered to the consumer
                put_item(_Raise(exc))
                return
            # abandoned mid-stream: free the server + transport credits
            for obj, meth in ((src, "cancel"), (it, "close")):
                fn = getattr(obj, meth, None)
                if fn is not None:
                    try:
                        fn()
                    except Exception:
                        pass

        threading.Thread(target=pump, daemon=True,
                         name="tpurpc-aio-pump").start()
        try:
            while True:
                item = await q.get()
                if item is _DONE:
                    return
                if isinstance(item, _Raise):
                    raise item.exc
                yield item
        finally:
            state["dropped"] = True
            while not q.empty():  # unblock a pump parked on a full queue
                q.get_nowait()

    return gen()


def _aiter_requests(sync_iter: Iterator, loop) -> AsyncIterator:
    """Thread-fed sync request iterator → async iterator for the handler.
    (loop is implicit in the returned generator; parameter kept for the
    server adapters' call shape.)"""
    return _sync_to_async_iter(lambda: sync_iter)


def _adapt(handler: _AioHandler, loop_ref: _LoopRef):
    """Async behavior → sync RpcMethodHandler the threaded server can run.

    The pool worker parks on ``Future.result()`` while the coroutine runs on
    the loop; async-generator responses are pulled one item per
    ``run_coroutine_threadsafe`` so the worker writes each response with the
    existing (blocking, flow-controlled) writer."""
    ab = handler.behavior

    def _loop() -> asyncio.AbstractEventLoop:
        loop = loop_ref.loop
        if loop is None:
            raise RuntimeError("aio.Server not started")
        return loop

    def _pump_agen(agen, loop):
        """Drive an async generator from the worker thread, one item per
        loop round-trip; on EARLY CLOSE (client cancel/disconnect throws
        GeneratorExit at our yield) aclose() the agen ON THE LOOP so the
        handler's finally/async-with cleanup actually runs — a GC'd
        un-aclosed asyncgen from a non-loop thread silently never runs it."""
        try:
            while True:
                try:
                    yield _guarded_result(
                        asyncio.run_coroutine_threadsafe(
                            agen.__anext__(), loop),
                        loop, "handler response")
                except StopAsyncIteration:
                    return
        finally:
            try:
                _guarded_result(
                    asyncio.run_coroutine_threadsafe(agen.aclose(), loop),
                    loop, "handler aclose")
            except Exception:
                pass

    if handler.kind == "unary_unary":
        def behavior(req, ctx):
            loop = _loop()
            return _guarded_result(
                asyncio.run_coroutine_threadsafe(ab(req, ctx), loop),
                loop, "handler result")
        factory = _server_mod.unary_unary_rpc_method_handler
    elif handler.kind == "unary_stream":
        def behavior(req, ctx):
            loop = _loop()
            yield from _pump_agen(ab(req, ctx), loop)
        factory = _server_mod.unary_stream_rpc_method_handler
    elif handler.kind == "stream_unary":
        def behavior(req_iter, ctx):
            loop = _loop()
            return _guarded_result(
                asyncio.run_coroutine_threadsafe(
                    ab(_aiter_requests(req_iter, loop), ctx), loop),
                loop, "handler result")
        factory = _server_mod.stream_unary_rpc_method_handler
    elif handler.kind == "stream_stream":
        def behavior(req_iter, ctx):
            loop = _loop()
            yield from _pump_agen(ab(_aiter_requests(req_iter, loop), ctx),
                                  loop)
        factory = _server_mod.stream_stream_rpc_method_handler
    else:
        raise ValueError(f"bad handler kind {handler.kind}")
    return factory(behavior, handler.request_deserializer,
                   handler.response_serializer)


class Server:
    """grpc.aio-shaped server: async handlers over the threaded transport."""

    def __init__(self, max_workers: int = 32,
                 max_receive_message_length: Optional[int] = None,
                 interceptors=()):
        self._sync = _server_mod.Server(
            max_workers=max_workers, interceptors=interceptors,
            max_receive_message_length=max_receive_message_length)
        self._loop_ref = _LoopRef()

    # registration (sync, like grpc.aio) -------------------------------------

    def add_method(self, path: str, handler) -> None:
        if isinstance(handler, _AioHandler):
            handler = _adapt(handler, self._loop_ref)
        self._sync.add_method(path, handler)

    def add_service(self, service: str, method_handlers) -> None:
        for name, h in dict(method_handlers).items():
            self.add_method(f"/{service}/{name}", h)

    # grpcio-generated-code surface (sync-behavior handlers pass straight
    # through to the threaded server's adaptation; see rpc/server.py)
    def add_generic_rpc_handlers(self, generic_handlers) -> None:
        self._sync.add_generic_rpc_handlers(generic_handlers)

    def add_registered_method_handlers(self, service, method_handlers) -> None:
        self._sync.add_registered_method_handlers(service, method_handlers)

    def add_insecure_port(self, address: str) -> int:
        return self._sync.add_insecure_port(address)

    def add_secure_port(self, address: str, server_credentials) -> int:
        return self._sync.add_secure_port(address, server_credentials)

    # lifecycle (async, like grpc.aio) ----------------------------------------

    async def start(self) -> None:
        self._loop_ref.loop = asyncio.get_running_loop()
        self._sync.start()

    async def stop(self, grace: Optional[float] = None) -> None:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, lambda: self._sync.stop(grace=grace or 0))

    async def wait_for_termination(self,
                                   timeout: Optional[float] = None) -> bool:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: self._sync.wait_for_termination(timeout=timeout))


def server(migration_thread_pool=None, handlers=None, interceptors=None,
           options=None, maximum_concurrent_rpcs=None, compression=None, *,
           max_workers: int = 32, **kw) -> Server:
    """grpc.aio.server-shaped: the stock call (executor first, options
    list, advisory kwargs) runs verbatim — same mapping as the sync
    :func:`tpurpc_torch.rpc.server.server`, interceptors included."""
    if isinstance(migration_thread_pool, int):  # legacy server(N)
        max_workers = migration_thread_pool
    elif migration_thread_pool is not None:
        workers = getattr(migration_thread_pool, "_max_workers", None)
        if workers:
            max_workers = workers
    if options:
        kw.setdefault("max_receive_message_length",
                      dict(options).get("grpc.max_receive_message_length"))
    srv = Server(max_workers=max_workers, interceptors=interceptors or (),
                 **kw)
    if handlers:
        for gh in handlers:
            srv.add_generic_rpc_handlers((gh,))
    return srv


# ---------------------------------------------------------------------------
# Client.
# ---------------------------------------------------------------------------

class _SyncedAsyncIterator:
    """Feed a SYNC request iterator (consumed by the blocking call machinery
    in a worker thread) from an ASYNC source running on the caller's loop."""

    def __init__(self, async_iterable, loop: asyncio.AbstractEventLoop):
        self._ait = async_iterable.__aiter__()
        self._loop = loop

    def __iter__(self):
        return self

    def __next__(self):
        fut = asyncio.run_coroutine_threadsafe(self._ait.__anext__(),
                                               self._loop)
        try:
            return _guarded_result(fut, self._loop, "request item")
        except StopAsyncIteration:
            raise StopIteration from None
        except RuntimeError:
            # loop stopped (deadline fired, asyncio.run returned): end the
            # stream instead of stranding the sender thread forever
            raise StopIteration from None


class Channel:
    """grpc.aio-shaped channel: awaitable calls over the threaded client."""

    def __init__(self, target: str, *, credentials=None, **kw):
        self._sync = _channel_mod.Channel(target, credentials=credentials,
                                          **kw)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    async def close(self) -> None:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._sync.close)

    async def ping(self, timeout: float = 5.0) -> float:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: self._sync.ping(timeout))

    def unary_unary(self, method: str, request_serializer=_identity,
                    response_deserializer=_identity, **grpcio_kwargs):
        mc = self._sync.unary_unary(method, request_serializer,
                                    response_deserializer, **grpcio_kwargs)

        async def call(request, timeout: Optional[float] = None,
                       metadata: Optional[Metadata] = None):
            return await _call_in_thread(
                lambda: mc(request, timeout=timeout, metadata=metadata))

        return call

    def unary_stream(self, method: str, request_serializer=_identity,
                     response_deserializer=_identity, **grpcio_kwargs):
        mc = self._sync.unary_stream(method, request_serializer,
                                     response_deserializer, **grpcio_kwargs)

        def call(request, timeout: Optional[float] = None,
                 metadata: Optional[Metadata] = None) -> AsyncIterator:
            return _sync_to_async_iter(
                lambda: mc(request, timeout=timeout, metadata=metadata))

        return call

    def stream_unary(self, method: str, request_serializer=_identity,
                     response_deserializer=_identity, **grpcio_kwargs):
        mc = self._sync.stream_unary(method, request_serializer,
                                     response_deserializer, **grpcio_kwargs)

        async def call(request_iterator, timeout: Optional[float] = None,
                       metadata: Optional[Metadata] = None):
            loop = asyncio.get_running_loop()
            if hasattr(request_iterator, "__aiter__"):
                request_iterator = _SyncedAsyncIterator(request_iterator,
                                                        loop)
            return await _call_in_thread(
                lambda: mc(request_iterator, timeout=timeout,
                           metadata=metadata))

        return call

    def stream_stream(self, method: str, request_serializer=_identity,
                      response_deserializer=_identity, **grpcio_kwargs):
        mc = self._sync.stream_stream(method, request_serializer,
                                      response_deserializer, **grpcio_kwargs)

        def call(request_iterator, timeout: Optional[float] = None,
                 metadata: Optional[Metadata] = None) -> AsyncIterator:
            async def gen():
                loop = asyncio.get_running_loop()
                reqs = request_iterator
                if hasattr(reqs, "__aiter__"):
                    reqs = _SyncedAsyncIterator(reqs, loop)
                async for item in _sync_to_async_iter(
                        lambda: mc(reqs, timeout=timeout,
                                   metadata=metadata)):
                    yield item

            return gen()

        return call


def insecure_channel(target: str, **kw) -> Channel:
    return Channel(target, **kw)


def secure_channel(target: str, credentials, **kw) -> Channel:
    return Channel(target, credentials=credentials, **kw)

