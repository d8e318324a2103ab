"""Tensor services: serve torch callables over tpurpc_torch.

The port of ``tpurpc/jaxshim/service.py``:

* :func:`add_tensor_method` / :class:`TensorClient` — unary, server-streaming
  and bidi tensor RPCs, and pipelined unary calls (``call_async``). With
  ``device=True`` on the TPU platform the request payloads land in the
  connection's device ring and the handler gets lease-backed device tensors.
* :class:`FanInBatcher` — cross-connection request batching: requests
  landing on independent connections are stacked into one leading batch
  axis, moved to the device in ONE host→device copy, and dispatched as a
  single model call; replies leave in ONE device→host copy per output leaf.
* :class:`DeviceMerger` / :class:`ShardedFanIn` — independent batcher shards
  that meet only at the device boundary, through a lock-free handoff ring.
* :func:`serve_torch` — one call that stands a tensor server up, batched or
  not.
* :func:`serve_torch_sharded` — N worker processes on one port
  (:class:`tpurpc_torch.rpc.shard.ShardedServer`), each a full
  :func:`serve_torch` stack around its own replica.

Observability, under the reference's names: the ``fanin_batch`` histogram,
the ``batcher_batches``, ``batcher_rows`` and ``batcher_flush_<reason>``
counters, the ``batcher_queue_depth`` fleet gauge (the watchdog's
``batcher-wait`` evidence), a ``BATCH_FLUSH`` flight event per dispatched
batch, each request's ``batch-wait`` (enqueue to dispatch) and ``infer``
(dispatch to materialized replies: :attr:`FanInBatcher.stage_s`'s four
stages) spans under the trace context its handler thread carried at
enqueue, :class:`DeviceMerger`'s ``merge_subbatches``,
``merge_dispatches`` and ``merge_isolated_failures``, the ``batcher`` and
``device-dispatch`` profiler stages, and the ``jaxshim`` trace flag (the
reference's name). :class:`TensorClient` runs over a port ``Channel`` or a
``NativeChannel`` (the C core's client); ``duplex(..., native=True)``
takes the channel's native fast path where the channel is eligible.
"""

from __future__ import annotations

import functools
import itertools
import json
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator, List, Optional, Sequence

import torch

from tpurpc_torch.core.handoff import HandoffRing
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import profiler as _profiler
from tpurpc_torch.obs import tracing as _tracing
from tpurpc_torch.rpc.health import add_health_servicer
from tpurpc_torch.rpc.server import (Server, stream_stream_rpc_method_handler,
                                     unary_stream_rpc_method_handler,
                                     unary_unary_rpc_method_handler)
from tpurpc_torch.rpc.shard import ShardedServer
from tpurpc_torch.torchshim import codec
from tpurpc_torch.tpu import ledger, serialize
from tpurpc_torch.utils.config import resolve_device
from tpurpc_torch.utils.trace import TraceFlag

trace_jax = TraceFlag("jaxshim")

# batching control flow is `batcher`; running a gathered batch on the model
# (and the merged cross-shard dispatch) is `device-dispatch`
_LENS_STAGES = {
    "_loop": "batcher",
    "_split_compatible": "batcher",
    "_concat_pad": "batcher",
    "_complete_loop": "batcher",
    "_run": "device-dispatch",
    "_merge_loop": "batcher",
    "_dispatch_group": "device-dispatch",
    "_run_one": "device-dispatch",
}
_profiler.register_stages(__file__, _LENS_STAGES)

# one histogram record and one counter add per dispatched batch; the flush
# reasons say why batches went out
_FANIN_BATCH = _metrics.histogram("fanin_batch")
_BATCHER_BATCHES = _metrics.counter("batcher_batches")
_BATCHER_ROWS = _metrics.counter("batcher_rows")
_FLUSH_REASONS = {
    reason: _metrics.counter(f"batcher_flush_{reason}")
    for reason in ("size", "timer", "drained", "close")
}
#: live batcher queue depth at scrape time: the watchdog's batcher-wait
#: evidence
_BATCHER_DEPTH = _metrics.fleet("batcher_queue_depth",
                                lambda b: len(b._queue))

TENSOR_SERVICE = "tpurpc.Tensor"


def _method_path(name: str) -> str:
    return f"/{TENSOR_SERVICE}/{name}"


def _device_decoder(ctx):
    """Per-call request decoder: device-ring placement when the transport is
    the TPU platform, host-aliasing decode otherwise.

    Returns ``(decode(buf) -> tree, finish())``. Each ``decode`` releases the
    PREVIOUS message's leases (advancing the request iterator means the
    handler is done with it); ``finish`` releases the last message's when the
    handler returns — the leases gate the ring's credit."""
    ring = getattr(ctx, "device_ring", None)
    if ring is None:
        return codec.tree_deserializer, lambda: None
    from tpurpc_torch.tpu.endpoint import decode_tree_to_ring

    held = []

    def decode(buf):
        for lease in held:
            lease.release()
        held.clear()
        tree, leases = decode_tree_to_ring(ring, buf)
        held.extend(leases)
        return tree

    def finish():
        for lease in held:
            lease.release()
        held.clear()

    return decode, finish


def _decoded(decode, raw_iter):
    """``decode`` each raw message; the raw body (on rendezvous, a view of
    its landing region) is dropped as soon as it is decoded, so the region
    recycles while the handler works on the tree."""
    for raw in raw_iter:
        tree = decode(raw)
        raw = None
        yield tree


def add_tensor_method(server: Server, name: str,
                      fn: Callable[..., Any],
                      kind: str = "unary_unary",
                      device: bool = False) -> None:
    """Register ``fn(tree) -> tree`` as a tensor-typed method.

    ``fn`` receives the decoded request pytree (CPU tensors aliasing the
    receive buffer) and returns a pytree of tensors, encoded the same way.
    With ``device=True`` and the TPU platform (``GRPC_PLATFORM_TYPE=TPU``)
    the request payloads are placed into the connection's device ring and
    ``fn`` gets lease-backed device tensors; the leases (ring credit) are
    released when ``fn`` returns. On other platforms ``device=True``
    degrades to the host decode.
    """
    if kind not in ("unary_unary", "unary_stream", "stream_stream"):
        raise ValueError(f"unsupported tensor method kind {kind}")
    if not device:
        if kind == "unary_unary":
            def behavior(req, ctx):
                return fn(req)
            make = unary_unary_rpc_method_handler
        elif kind == "unary_stream":
            def behavior(req, ctx):
                yield from fn(req)
            make = unary_stream_rpc_method_handler
        else:
            def behavior(req_iter, ctx):
                yield from fn(req_iter)
            make = stream_stream_rpc_method_handler
        server.add_method(_method_path(name), make(
            behavior, codec.tree_deserializer, codec.tree_serializer))
        return

    # Device mode: raw message bytes reach the behavior, which decodes them
    # where ctx exposes the connection's ring. Responses are serialized
    # INSIDE the behavior, before finish(): unwrapped views ALIAS ring
    # memory, so a passthrough response read after the lease release could
    # see the span overwritten by the next request on the connection. The
    # serialization copies the reply to the host, on the same CUDA stream as
    # the placement and the model, before the credit returns.
    if kind == "unary_unary":
        def behavior(raw, ctx):
            decode, finish = _device_decoder(ctx)
            try:
                return codec.tree_serializer(fn(decode(raw)))
            finally:
                finish()
        make = unary_unary_rpc_method_handler
    elif kind == "unary_stream":
        def behavior(raw, ctx):
            decode, finish = _device_decoder(ctx)
            try:
                for item in fn(decode(raw)):
                    yield codec.tree_serializer(item)
            finally:
                finish()
        make = unary_stream_rpc_method_handler
    else:
        def behavior(raw_iter, ctx):
            decode, finish = _device_decoder(ctx)
            try:
                for item in fn(_decoded(decode, raw_iter)):
                    yield codec.tree_serializer(item)
            finally:
                finish()
        make = stream_stream_rpc_method_handler
    # identity serializer: responses arrive already encoded
    server.add_method(_method_path(name), make(
        behavior, codec.raw_view, lambda b: b))


class TensorClient:
    """Client for tensor methods over a :class:`tpurpc_torch.rpc.channel.Channel`.

    ``depth`` bounds the per-method in-flight window ``call_async`` uses —
    the serving pipeline's client half: one connection sustains ``depth``
    outstanding unary calls, demuxed by stream id, which is what lets the
    server's :class:`FanInBatcher` see real batches instead of a lockstep of
    ones."""

    def __init__(self, channel, depth: int = 16):
        self._channel = channel
        self.depth = max(1, depth)
        self._pipelines: dict = {}
        self._pl_lock = threading.Lock()

    def call(self, name: str, tree: Any, timeout: Optional[float] = None) -> Any:
        mc = self._channel.unary_unary(
            _method_path(name), codec.tree_serializer, codec.tree_deserializer)
        return mc(tree, timeout=timeout)

    def pipeline(self, name: str, depth: Optional[int] = None):
        """A bounded multi-in-flight caller for ``name``: an object whose
        ``call_async(tree, timeout=None)`` returns a Future. On the Python
        channel a :class:`~tpurpc_torch.rpc.channel.PipelinedUnary`; on a
        ``NativeChannel`` its ``.future()`` (the completion queue, or the
        bounded worker window on inline-read channels) behind the same
        bounded window."""
        depth = self.depth if depth is None else max(1, depth)
        mc = self._channel.unary_unary(
            _method_path(name), codec.tree_serializer, codec.tree_deserializer)
        pl = getattr(mc, "pipeline", None)
        if pl is not None:  # Python channel: stream-id-demuxed window
            return pl(depth)
        return _NativePipeline(mc.future, depth)

    def call_async(self, name: str, tree: Any,
                   timeout: Optional[float] = None):
        """Pipelined unary call: returns a Future of the response tree.
        At most ``depth`` calls per method are in flight; the next
        ``call_async`` blocks until a slot frees (window backpressure)."""
        with self._pl_lock:
            pl = self._pipelines.get(name)
            if pl is None:
                pl = self._pipelines[name] = self.pipeline(name)
        return pl.call_async(tree, timeout=timeout)

    def call_device(self, name: str, tree: Any,
                    timeout: Optional[float] = None):
        """Unary call whose RESPONSE decodes into the channel's device ring.

        Returns a :class:`tpurpc_torch.tpu.endpoint.DeviceMessage` — use it as
        a context manager (or call ``.release()``) so the ring credit
        returns. Off the TPU platform the response decodes on the host,
        still wrapped in a DeviceMessage with no leases."""
        from tpurpc_torch.tpu.endpoint import DeviceMessage, decode_tree_to_ring

        mc = self._channel.unary_unary(
            _method_path(name), codec.tree_serializer, codec.raw_view)
        raw, call = mc.with_call(tree, timeout=timeout)
        # the call's OWN connection carried the response
        ring = call.device_ring()
        if ring is None:
            return DeviceMessage(codec.decode_tree(raw), [])
        out, leases = decode_tree_to_ring(ring, raw)
        return DeviceMessage(out, leases)

    def stream(self, name: str, tree: Any,
               timeout: Optional[float] = None) -> Iterator[Any]:
        mc = self._channel.unary_stream(
            _method_path(name), codec.tree_serializer, codec.tree_deserializer)
        return mc(tree, timeout=timeout)

    def duplex(self, name: str, trees: Iterator[Any],
               timeout: Optional[float] = None,
               native: bool = True) -> Iterator[Any]:
        """Bidi tensor stream. ``native=True`` (the default) rides the C
        core's loop on eligible channels; ineligible ones (the ``TPU``
        device-ring platform, TLS, compression, several addresses) take
        the Python transport by themselves. ``native=False`` forces the
        instrumented Python plane: the native plane bills no copies to
        the copy ledger."""
        mc = self._channel.stream_stream(
            _method_path(name), codec.tree_serializer,
            codec.tree_deserializer, tpurpc_native=native)
        return mc(trees, timeout=timeout)


class _NativePipeline:
    """A window-bounded wrapper over a native ``.future``: the native side
    already pipelines (the completion queue or the inline worker window);
    this adds the caller-facing backpressure ``PipelinedUnary`` has, so
    serving code treats the two planes alike."""

    def __init__(self, future_fn, depth: int):
        self._future_fn = future_fn
        self._window = threading.BoundedSemaphore(max(1, depth))

    def call_async(self, tree: Any, timeout: Optional[float] = None):
        self._window.acquire()
        try:
            fut = self._future_fn(tree, timeout=timeout)
        except BaseException:
            self._window.release()
            raise
        fut.add_done_callback(lambda _f: self._window.release())
        return fut

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Fan-in batching
# ---------------------------------------------------------------------------

def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _rows(leaves: Sequence, treedef, s: slice) -> Any:
    """The tree of leading-axis rows ``s`` of every leaf (views)."""
    return codec.tree_unflatten(treedef, [x[s] for x in leaves])


def _bind_thread(device: torch.device) -> None:
    """The current CUDA device is per thread: a batcher's own threads run
    on the batcher's device."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


class _Pending:
    __slots__ = ("tree", "event", "result", "error", "tctx", "t_enq")

    def __init__(self, tree):
        self.tree = tree
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        #: the calling RPC's trace context (the handler thread's ambient one)
        #: and the enqueue stamp: the batcher turns them into the request's
        #: "batch-wait" and "infer" spans
        self.tctx = _tracing.current() if _tracing.LIVE else None
        self.t_enq = time.monotonic_ns() if self.tctx is not None else 0


class FanInBatcher:
    """Stack concurrent requests from many connections into one model call.

    ``fn`` must accept tensors with a leading batch axis. Batches are padded
    to a bucket (the next power of two ≤ ``max_batch``, or always
    ``max_batch`` with ``fixed_bucket``), so the model sees few distinct
    shapes. Each request contributes leading-axis rows; replies are split
    back out.

    Dispatch fires when ``max_batch`` rows are waiting, when ``max_delay_s``
    elapsed since the first queued request, or — with ``inflight_fn`` —
    when every request the transport has admitted is already queued.

    Requests arrive from the wire as CPU tensors aliasing receive buffers:
    they are concatenated and padded on the host, into a pinned staging
    tensor when ``device`` is a card (cast to ``transfer_dtype`` if set), and
    moved in ONE non-blocking host→device copy. Device-resident inputs are
    concatenated on the device.

    Reply delivery is a two-stage pipeline: the batcher thread only
    *dispatches* — stacks, copies, calls ``fn`` (CUDA work is enqueued, not
    waited for) and enqueues each output leaf's device→host copy into
    pinned memory behind a recorded event — and hands the in-flight batch
    to a completion thread, which waits for the event and splits replies as
    host views. So there is one D2H per output leaf per batch, batch N+1's
    stacking overlaps batch N's device time, and ``d2h_workers`` completion
    threads retire batches concurrently (bounded: backpressure still reaches
    callers).

    ``device`` (resolved by :func:`~tpurpc_torch.utils.config.resolve_device`)
    is where batches run; a CUDA device with no card raises.
    """

    #: lock map (the reference linter's rule `lock`) + shard contract (rule
    #: `shard`): the request queue and close flag are SHARD-LOCAL — only
    #: this batcher's own threads mutate them; cross-shard access is
    #: confined to the device merger's declared ``_MERGE_BOUNDARY``
    _GUARDED_BY = {"_queue": "_lock", "_closed": "_lock"}

    def __init__(self, fn: Callable[[Any], Any], max_batch: int = 8,
                 max_delay_s: float = 0.002, pad_to_bucket: bool = True,
                 fixed_bucket: bool = False, d2h_workers: int = 4,
                 transfer_dtype: Optional[torch.dtype] = None,
                 inflight_fn: Optional[Callable[[], int]] = None,
                 device=None):
        self._device = resolve_device(device)
        #: depth-aware flush: how many requests are in flight at the
        #: transport (Server.inflight_requests). When every one is already
        #: queued here, no further arrival can happen until responses go
        #: out, so waiting out max_delay_s is pure latency: flush now.
        self._inflight_fn = inflight_fn
        #: recent dispatched batch sizes — the depth-aware flush's
        #: hysteresis floor is their max (see _drained_inflight)
        self._recent_batches: "deque[int]" = deque(maxlen=8)
        #: cast host-side batches to this dtype before the H2D (e.g.
        #: ``torch.bfloat16`` when the model computes in bf16 anyway): it
        #: halves the transfer. None = ship requests in their wire dtype.
        self.transfer_dtype = transfer_dtype
        self._fn = fn
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.pad_to_bucket = pad_to_bucket
        #: always pad to max_batch: ONE batch shape for single-row requests.
        #: A dispatch whose requests total MORE than max_batch rows still
        #: pads to that larger total.
        self.fixed_bucket = fixed_bucket
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._kick = threading.Condition(self._lock)
        self._closed = False
        self.batches_run = 0
        self.rows_run = 0
        #: host seconds per stage, summed over batches: ``stack`` (concat,
        #: cast, pad, H2D enqueue), ``model`` (``fn``'s call: on a card, its
        #: dispatch), ``d2h`` (the replies' D2H enqueue) on the batcher
        #: thread; ``split`` (the wait for the D2H excluded: the replies'
        #: views) on the completion threads
        self.stage_s = dict.fromkeys(("stack", "model", "d2h", "split"), 0.0)
        #: in-flight (dispatched, not yet materialized) batches; the bound is
        #: the pipeline depth — blocking put() backpressures the batcher
        #: thread, and through it the callers, when the device falls behind
        self._inflight: "queue.Queue" = queue.Queue(maxsize=max(2, d2h_workers))
        self._reaped = False  # set by close() after the workers are gone
        _BATCHER_DEPTH.track(self)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tpurpc-batcher")
        self._completers = [
            threading.Thread(target=self._complete_loop, daemon=True,
                             name=f"tpurpc-batcher-d2h-{i}")
            for i in range(max(1, d2h_workers))]
        self._thread.start()
        for c in self._completers:
            c.start()

    def queue_depth(self) -> int:
        """Requests parked behind the transport (queued here + dispatched
        batches not yet materialized)."""
        with self._lock:
            queued = len(self._queue)
        return queued + self._inflight.qsize()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._kick.notify_all()
        self._thread.join(timeout=5)
        for _ in self._completers:   # one sentinel per completion worker,
            try:                      # after the last dispatched batch.
                # Generous timeout: a merely-backlogged (healthy) queue
                # drains and takes the sentinel; only a truly wedged
                # consumer set makes us give up so close() stays bounded.
                self._inflight.put(None, timeout=10)
            except queue.Full:
                break
        for c in self._completers:
            c.join(timeout=5)
        if any(c.is_alive() for c in self._completers):
            # Workers are wedged in device work but still hold the queue's
            # consumer role — if they ever unwedge they will drain the
            # remaining batches, so failing those now would be both
            # premature and racy. Leave the daemon threads to their fate.
            return
        self._reaped = True  # a still-blocked dispatch put now fails its batch
        # Shutdown race sweep: if the batcher thread outlived its join
        # timeout its final batch can land after the workers exited on
        # sentinels — fail those callers instead of stranding them on
        # p.event forever. (A put racing this sweep is covered by the
        # _reaped check in the dispatch loop: either the sweep sees the
        # item, or the put times out and fails the batch itself.)
        while True:
            try:
                item = self._inflight.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            for p in item[0]:
                p.error = RuntimeError("batcher closed")
                p.event.set()

    def __call__(self, tree: Any) -> Any:
        p = _Pending(tree)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.append(p)
            self._kick.notify_all()
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    # -- batcher thread ------------------------------------------------------

    def _loop(self) -> None:
        _bind_thread(self._device)
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._kick.wait()
                if self._closed and not self._queue:
                    return
                deadline = time.monotonic() + self.max_delay_s
                reason = None
                while (len(self._queue) < self.max_batch and not self._closed):
                    if self._drained_inflight():
                        reason = "drained"  # nobody else is coming
                        break
                    left = deadline - time.monotonic()
                    if left <= 0:
                        reason = "timer"
                        break
                    self._kick.wait(timeout=left)
                if reason is None:
                    reason = ("size" if len(self._queue) >= self.max_batch
                              else "close")
                batch, self._queue = (self._queue[:self.max_batch],
                                      self._queue[self.max_batch:])
                if batch:
                    self._recent_batches.append(len(batch))
            if batch:
                _FLUSH_REASONS[reason].inc()
                _FANIN_BATCH.record(len(batch))
                # one event per dispatched batch: the flush decision
                _flight.emit(_flight.BATCH_FLUSH, 0,
                             _flight.FLUSH_REASON_CODE[reason], len(batch))
                self._run(batch)

    def _drained_inflight(self) -> bool:
        """True when the transport says every arrived-and-unanswered
        request is already in our queue — the depth-aware flush signal
        (runs under self._lock via the _loop wait).

        Hysteresis: the early flush also requires the queue to have
        reached the max RECENT batch size. "Every in-flight request is
        queued" is trivially true in the stagger gap of a closed-loop
        client set (responses written, next requests still on the wire) —
        flushing there degenerates to batches of one. Demanding
        recently-proven occupancy first keeps steady-state batching intact;
        the max over a sliding window (not just the last batch) means one
        small ramp-up batch can't drag the floor into a sticky batch-of-one
        fixed point, while a genuinely quiet batcher decays to immediate
        flushes within a window. A stale snapshot only flushes early or
        late; it never hangs."""
        if self._inflight_fn is None or not self._queue:
            return False
        try:
            pending = self._inflight_fn()
        except Exception:
            return False  # a broken probe degrades to the timer, never hangs
        q = len(self._queue)
        floor = min(self.max_batch, max(self._recent_batches, default=1))
        return q >= max(1, pending) and q >= floor

    def _split_compatible(self, batch: List[_Pending]) -> List[_Pending]:
        """Fail (individually) requests whose pytree structure or leaf
        row-shape/dtype can't stack with the batch's first valid row —
        one bad request must not poison its siblings' futures."""
        good: List[_Pending] = []
        ref = None
        for p in batch:
            err: Optional[Exception] = None
            sig = None
            try:
                leaves, treedef = codec.tree_flatten(p.tree)
                if not leaves:
                    raise ValueError("empty request tree")
                leaves = [_as_tensor(x) for x in leaves]
                for x in leaves:
                    if x.dim() < 1:
                        raise ValueError(
                            "batched request leaves need a leading batch axis")
                sig = (treedef, tuple((tuple(x.shape[1:]), x.dtype)
                                      for x in leaves))
            except Exception as exc:
                err = exc
            if err is None:
                if ref is None or sig == ref:
                    ref = ref or sig
                    good.append(p)
                    continue
                err = ValueError(
                    "request incompatible with batch: leaf shapes/dtypes "
                    f"{sig[1]} vs {ref[1]} (or differing tree structure)")
            p.error = err
            p.event.set()
        return good

    def _bucket(self, n: int) -> int:
        if self.fixed_bucket:
            return self.max_batch
        if not self.pad_to_bucket:
            return n
        b = 1
        while b < n:
            b <<= 1
        return min(b, self.max_batch)

    def _run(self, batch: List[_Pending]) -> None:
        """Stage 1 (batcher thread): stack, pad, copy, dispatch, start the
        D2H, enqueue in-flight. Does NOT wait for the device."""
        batch = self._split_compatible(batch)
        if not batch:
            return
        t_disp = time.monotonic_ns()
        for p in batch:
            if p.tctx is not None:
                # enqueue -> dispatch: the request's "batch-wait" span
                _tracing.record("batch-wait", p.tctx, p.t_enq,
                                t_disp - p.t_enq)
        #: pinned staging tensors of the non-blocking H2D: held with the
        #: in-flight batch until its event proves the copies done
        staged: list = []
        try:
            t0 = time.perf_counter()
            flat = [codec.tree_flatten(p.tree) for p in batch]
            sizes = [int(_as_tensor(leaves[0]).shape[0]) for leaves, _ in flat]
            total = sum(sizes)
            bucket = max(self._bucket(total), total)
            cols = zip(*(leaves for leaves, _ in flat))
            stacked = codec.tree_unflatten(
                flat[0][1], [self._concat_pad(xs, bucket, staged)
                             for xs in cols])
            t1 = time.perf_counter()
            out = self._fn(stacked)
            t2 = time.perf_counter()
            host = serialize.start_host_copy(out)
            t3 = time.perf_counter()
            with self._lock:
                self.stage_s["stack"] += t1 - t0
                self.stage_s["model"] += t2 - t1
                self.stage_s["d2h"] += t3 - t2
        except Exception as e:  # deliver failure to every caller in the batch
            for p in batch:
                p.error = e
                p.event.set()
            return

        # Bounded-backpressure put that stays shutdown-safe: once close()
        # has reaped the completion workers (_reaped), nobody will ever
        # drain the queue — fail this batch's callers instead of parking
        # them behind a put that can no longer complete.
        def fail_batch(b):
            for p in b:
                p.error = RuntimeError("batcher closed")
                p.event.set()

        while True:
            if self._reaped:
                fail_batch(batch)
                return
            try:
                self._inflight.put((batch, sizes, total, host, staged,
                                    t_disp), timeout=0.25)
                break
            except queue.Full:
                continue
        if self._reaped:
            # Reaping raced our successful put and close()'s sweep may have
            # already drained: self-sweep so no batch is ever stranded.
            while True:
                try:
                    item = self._inflight.get_nowait()
                except queue.Empty:
                    return
                if item is not None:
                    fail_batch(item[0])

    def _complete_loop(self) -> None:
        """Stage 2: wait for the whole-batch D2H, split replies as views."""
        _bind_thread(self._device)
        while True:
            item = self._inflight.get()
            if item is None:
                return
            (batch, sizes, total, (leaves, treedef, event), _staged,
             t_disp) = item
            try:
                if event is not None:
                    event.synchronize()
                t_done = time.monotonic_ns()
                for p in batch:
                    if p.tctx is not None:
                        # dispatch -> materialized: the "infer" span (stack,
                        # model, D2H; shared by the batch)
                        _tracing.record("infer", p.tctx, t_disp,
                                        t_done - t_disp, rows=total)
                _BATCHER_BATCHES.inc()
                _BATCHER_ROWS.inc(total)
                t0 = time.perf_counter()
                with self._lock:
                    self.batches_run += 1
                    self.rows_run += total
                off = 0
                for p, n in zip(batch, sizes):
                    p.result = _rows(leaves, treedef, slice(off, off + n))
                    off += n
                    p.event.set()
                with self._lock:
                    self.stage_s["split"] += time.perf_counter() - t0
            except Exception as e:
                for p in batch:
                    p.error = e
                    p.event.set()

    def _concat_pad(self, xs: Sequence, bucket: int, staged: list):
        ts = [_as_tensor(x) for x in xs]
        rows = sum(t.shape[0] for t in ts)
        if all(t.device.type == "cpu" for t in ts):
            # Host rows (from the wire): concatenate, cast and pad into one
            # staging tensor — pinned when bound for a card — and ship the
            # batch in ONE copy. N per-request H2Ds plus a device concat
            # would turn one bulk transfer into N small ones and a launch.
            dtype = ts[0].dtype
            if self.transfer_dtype is not None and dtype.is_floating_point:
                dtype = self.transfer_dtype
            card = self._device.type == "cuda"
            cat = torch.empty((max(bucket, rows), *ts[0].shape[1:]),
                              dtype=dtype, pin_memory=card)
            torch.cat(ts, dim=0, out=cat[:rows])  # casts as it writes
            cat[rows:].zero_()
            if self._device.type == "cpu":
                return cat
            staged.append(cat)
            ledger.dma_h2d(cat.numel() * cat.element_size())
            return cat.to(self._device, non_blocking=True)
        # device-resident inputs (in-process callers): keep them on device
        cat = torch.cat([t.to(self._device) for t in ts], dim=0)
        if bucket > rows:
            cat = torch.cat([cat, cat.new_zeros((bucket - rows,
                                                 *cat.shape[1:]))])
        return cat


# ---------------------------------------------------------------------------
# Device-boundary merge
# ---------------------------------------------------------------------------

class _SubBatch:
    """One shard's stacked-and-padded batch, in flight across the merge
    boundary. The shard's batcher thread parks on ``done`` while the merger
    dispatches; ``out``/``err`` come back resolved."""

    __slots__ = ("stacked", "rows", "done", "out", "err")

    #: shard contract (rule `shard`): a sub-batch belongs to ITS shard; its
    #: out/err may only be written across the shard boundary inside the
    #: merger's declared ``_MERGE_BOUNDARY`` functions
    _GUARDED_BY = {"out": "done", "err": "done"}

    def __init__(self, stacked, rows: int):
        self.stacked = stacked
        self.rows = rows
        self.done = threading.Event()
        self.out = None
        self.err: Optional[Exception] = None


_MERGE_SUBS = _metrics.histogram("merge_subbatches")
_MERGE_DISPATCH = _metrics.counter("merge_dispatches")
_MERGE_ISOLATED = _metrics.counter("merge_isolated_failures")


class DeviceMerger:
    """Gather compatible sub-batches from per-shard batchers into ONE
    device dispatch.

    Shards batch independently — each :class:`FanInBatcher` keeps its own
    lock, queue and flush policy — and meet the single device only here:
    sub-batches are published through a lock-free
    :class:`~tpurpc_torch.core.handoff.HandoffRing`, and the one merger
    thread gathers whatever the other shards already committed,
    concatenates shape-compatible sub-batches along the batch axis (on the
    device, where they already are), and dispatches once.

    Failure isolation: a merged dispatch that fails is retried per
    sub-batch, so a mis-shaped (or poisoned) sub-batch fails ALONE — its
    siblings' requests complete. Incompatible signatures never co-dispatch
    in the first place (grouped by pytree structure + row shape/dtype).

    Merging two bucket-B sub-batches dispatches 2B rows, a new batch shape;
    callers who need one shape keep one shard (plain FanInBatcher).
    """

    #: the ONLY functions allowed to mutate another shard's `_GUARDED_BY`
    #: state (rule `shard`): the merge loop and its resolve/fail arms
    _MERGE_BOUNDARY = ("_merge_loop", "_dispatch_group", "_resolve_sub",
                       "_fail_sub")

    def __init__(self, fn: Callable[[Any], Any], capacity: int = 64,
                 max_merge_subs: int = 8, gather_window_s: float = 0.0005,
                 device=None):
        self._device = resolve_device(device)
        self._fn = fn
        self.max_merge_subs = max(1, max_merge_subs)
        self.gather_window_s = gather_window_s
        self._ring = HandoffRing(capacity)
        self._closed = False
        self.dispatches = 0
        self.subs_merged = 0
        self._thread = threading.Thread(target=self._merge_loop, daemon=True,
                                        name="tpurpc-merge")
        self._thread.start()

    # -- shard-facing ---------------------------------------------------------

    def entry(self) -> Callable[[Any], Any]:
        """An ``fn``-shaped callable for one shard's FanInBatcher: publishes
        the stacked sub-batch across the boundary and parks until the
        merger resolves it. Returns HOST-side results (the merger owns the
        D2H), so the shard's completion stage only splits."""

        def dispatch(stacked):
            leaves, _ = codec.tree_flatten(stacked)
            sub = _SubBatch(stacked, int(_as_tensor(leaves[0]).shape[0]))
            if not self._ring.publish(sub):
                raise RuntimeError("device merger closed")
            sub.done.wait()
            if sub.err is not None:
                raise sub.err
            return sub.out

        return dispatch

    def close(self) -> None:
        self._closed = True
        self._ring.close()
        self._thread.join(timeout=5)

    # -- the merge boundary (single consumer thread) --------------------------

    def _merge_loop(self) -> None:
        _bind_thread(self._device)
        while True:
            first = self._ring.take(timeout=0.25)
            if first is None:
                if self._closed:
                    return
                continue
            group = [first]
            # gather pass: drain what the other shards ALREADY committed,
            # then one brief window for shards mid-publish — bounded so a
            # lone sub-batch never waits on shards with nothing to say
            deadline = time.monotonic() + self.gather_window_s
            while len(group) < self.max_merge_subs:
                nxt = self._ring.take_ready()
                if nxt is not None:
                    group.append(nxt)
                    continue
                if time.monotonic() >= deadline:
                    break
                time.sleep(self.gather_window_s / 4)
            for sig_group in self._partition(group):
                self._dispatch_group(sig_group)

    @staticmethod
    def _signature(sub: _SubBatch):
        leaves, treedef = codec.tree_flatten(sub.stacked)
        return (json.dumps(treedef),
                tuple((tuple(_as_tensor(x).shape[1:]),
                       str(_as_tensor(x).dtype)) for x in leaves))

    def _partition(self, group: List[_SubBatch]) -> List[List[_SubBatch]]:
        """Group sub-batches that can legally concatenate (same pytree
        structure, row shape, dtype); order-preserving within a group."""
        buckets: dict = {}
        order: List[List[_SubBatch]] = []
        for sub in group:
            try:
                sig = self._signature(sub)
            except Exception:
                sig = ("bad", id(sub))
            lst = buckets.get(sig)
            if lst is None:
                lst = buckets[sig] = []
                order.append(lst)
            lst.append(sub)
        return order

    def _dispatch_group(self, group: List[_SubBatch]) -> None:
        self.dispatches += 1
        _MERGE_DISPATCH.inc()
        _MERGE_SUBS.record(len(group))
        if len(group) == 1:
            sub = group[0]
            try:
                self._resolve_sub(sub, self._run_one(sub.stacked))
            except Exception as exc:
                self._fail_sub(sub, exc)
            return
        try:
            flat = [codec.tree_flatten(s.stacked) for s in group]
            merged = codec.tree_unflatten(
                flat[0][1], [self._concat(xs)
                             for xs in zip(*(leaves for leaves, _ in flat))])
            leaves, treedef = codec.tree_flatten(self._run_one(merged))
            self.subs_merged += len(group)
            off = 0
            for sub in group:
                self._resolve_sub(
                    sub, _rows(leaves, treedef, slice(off, off + sub.rows)))
                off += sub.rows
        except Exception:
            # merged dispatch failed: isolate — each sub-batch dispatches
            # alone so a poisoned shard cannot fail its siblings
            _MERGE_ISOLATED.inc()
            for sub in group:
                try:
                    self._resolve_sub(sub, self._run_one(sub.stacked))
                except Exception as exc:
                    self._fail_sub(sub, exc)

    def _run_one(self, stacked):
        """Dispatch + materialize to host: ONE D2H per output leaf for the
        merged batch; the shards' split stages see host tensors."""
        leaves, treedef, event = serialize.start_host_copy(self._fn(stacked))
        if event is not None:
            event.synchronize()
        return codec.tree_unflatten(treedef, leaves)

    @staticmethod
    def _resolve_sub(sub: _SubBatch, result) -> None:
        sub.out = result
        sub.done.set()

    @staticmethod
    def _fail_sub(sub: _SubBatch, exc: Exception) -> None:
        sub.err = exc
        sub.done.set()

    @staticmethod
    def _concat(xs):
        return torch.cat([_as_tensor(x) for x in xs], dim=0)


class ShardedFanIn:
    """N independent FanInBatcher shards merging at the device boundary.

    Callers are striped round-robin across shards (one GIL-atomic
    ``next()`` — no shared lock on the request path); each shard batches
    under its OWN lock and publishes through the merger's handoff ring.
    Drop-in for FanInBatcher where serve_torch wires one (``__call__``,
    ``queue_depth``, ``batches_run``, ``rows_run``, ``close``)."""

    def __init__(self, fn: Callable[[Any], Any], n_shards: int = 2,
                 max_batch: int = 8, max_delay_s: float = 0.002,
                 inflight_fn: Optional[Callable[[], int]] = None,
                 device=None, **kw):
        self.merger = DeviceMerger(fn, capacity=max(8, 4 * n_shards),
                                   device=device)
        self.shards = [
            FanInBatcher(self.merger.entry(), max_batch=max_batch,
                         max_delay_s=max_delay_s, inflight_fn=inflight_fn,
                         device=device, **kw)
            for _ in range(max(1, n_shards))]
        self._rr = itertools.count()

    def __call__(self, tree: Any) -> Any:
        return self.shards[next(self._rr) % len(self.shards)](tree)

    def queue_depth(self) -> int:
        return sum(s.queue_depth() for s in self.shards)

    @property
    def batches_run(self) -> int:
        return sum(s.batches_run for s in self.shards)

    @property
    def rows_run(self) -> int:
        return sum(s.rows_run for s in self.shards)

    def close(self) -> None:
        for s in self.shards:
            s.close()
        self.merger.close()


def serve_torch(fn: Callable[[Any], Any], address: str = "127.0.0.1:0", *,
                name: str = "Call", device: bool = False,
                batching: bool = False, max_batch: int = 8,
                max_delay_s: float = 0.002, max_workers: int = 32,
                batch_shards: int = 1):
    """One call: stand up a tensor server around ``fn``.

    Returns ``(server, port, batcher_or_None)``; the caller stops the server
    (and closes the batcher). ``device=True`` decodes requests into the
    connection's device ring on the TPU platform (:func:`add_tensor_method`).

    With ``batching`` a :class:`FanInBatcher` on the config's device is
    wired to the server's in-flight request count (depth-aware flush): when
    every request the transport has admitted is already queued, the batch
    dispatches immediately instead of waiting out ``max_delay_s`` —
    pipelined clients (``TensorClient.call_async``) fill batches, lockstep
    clients stop paying the delay. ``batch_shards > 1`` splits the batcher
    into that many independent shards merging only at the device boundary
    (:class:`ShardedFanIn`). A request parks a server worker inside the
    batcher until its batch completes, so ``max_workers`` bounds how many
    requests can fill a batch. The batcher's queue depth rides the
    server's per-response load report (``Server.set_load_provider``), so a
    ``least_loaded`` client sees model-side queueing that the transport's
    in-flight count alone would miss.
    """
    srv = Server(max_workers=max_workers)
    batcher = _add_served(srv, fn, name, device, batching, max_batch,
                          max_delay_s, batch_shards)
    srv.start()
    port = srv.add_insecure_port(address)  # after start: returns the bound port
    return srv, port, batcher


def _add_served(srv: Server, fn, name: str, device: bool, batching: bool,
                max_batch: int, max_delay_s: float, batch_shards: int):
    """Register ``fn`` on ``srv`` as :func:`serve_torch` does; returns the
    batcher, or None."""
    if not batching:
        add_tensor_method(srv, name, fn, device=device)
        return None
    if batch_shards > 1:
        batcher = ShardedFanIn(fn, n_shards=batch_shards,
                               max_batch=max_batch, max_delay_s=max_delay_s,
                               inflight_fn=srv.inflight_requests)
    else:
        batcher = FanInBatcher(fn, max_batch=max_batch,
                               max_delay_s=max_delay_s,
                               inflight_fn=srv.inflight_requests)
    add_tensor_method(srv, name, batcher, device=device)
    srv.set_load_provider(batcher.queue_depth)
    return batcher


def _sharded_build(build_fn: Callable[[], Callable[[Any], Any]], name: str,
                   batching: bool, max_batch: int, max_delay_s: float,
                   max_workers: int, batch_shards: int, shard_id: int):
    """One worker's server for :func:`serve_torch_sharded`: a module-level
    function, so that ``functools.partial`` of it crosses into a spawned
    worker by name."""
    srv = Server(max_workers=max_workers)
    _add_served(srv, build_fn(), name, False, batching, max_batch,
                max_delay_s, batch_shards)
    add_health_servicer(srv)
    return srv


def serve_torch_sharded(build_fn: Callable[[], Callable[[Any], Any]],
                        address: str = "127.0.0.1:0", *,
                        workers: int = 2, name: str = "Call",
                        batching: bool = True, max_batch: int = 8,
                        max_delay_s: float = 0.002, max_workers: int = 32,
                        batch_shards: int = 1, listener: str = "reuseport",
                        handoff_policy: str = "round_robin"):
    """N worker processes on ONE port, each a full :func:`serve_torch`
    stack (its own poller, rings, thread pool and batcher; with
    ``batch_shards > 1`` a :class:`ShardedFanIn`).

    ``build_fn()`` constructs the model callable IN EACH WORKER: model and
    CUDA state never cross a process boundary, so each shard owns a replica
    built in its own process. Workers start by spawn, so ``build_fn`` must
    be importable by name (a module-level function, or a
    ``functools.partial`` of one); a closure raises ``TypeError``. Each
    worker also carries the health service, so that the supervisor's
    ``drain`` shows as NOT_SERVING to a fleet's probes (the reference's
    workers carry none). Returns the started
    :class:`tpurpc_torch.rpc.shard.ShardedServer`; ``.port`` is the serving
    port, ``.stop()`` tears the fleet down.
    """
    build = functools.partial(_sharded_build, build_fn, name, batching,
                              max_batch, max_delay_s, max_workers,
                              batch_shards)
    return ShardedServer(build, workers=workers, address=address,
                         listener=listener,
                         handoff_policy=handoff_policy).start()
