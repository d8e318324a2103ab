"""Streaming generation over tpurpc_torch: the scheduler's transport face.

A copy of ``tpurpc/serving/api.py``; the server's load report carries the
scheduler's ``load_depth``. ``add_generation_method`` registers a
server-streaming tensor method whose handler submits to the
:class:`~tpurpc_torch.serving.scheduler.DecodeScheduler`, then forwards
tokens from the sequence's queue to the RPC stream with bounded waits that
interleave client-liveness checks: a client that cancels or dies makes the
handler cancel the sequence, which the scheduler retires at the next step
boundary. The sequence inherits the RPC's trace context and the caller's
``tpurpc-account`` metadata at admission, where its journey and ledger
start (:mod:`tpurpc_torch.obs.odyssey`); :class:`GenerationClient` sends
that key when given an ``account``.

Wire shapes (all int32), byte-equal to the reference's:

* request: ``{"prompt": [L], "max_tokens": scalar, "slo": scalar}``
  (slo: 0 = interactive, 1 = batch);
* response, one per token: ``{"token": scalar, "index": scalar}``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from tpurpc_torch.obs import odyssey as _odyssey
from tpurpc_torch.obs import tracing as _tracing
from tpurpc_torch.rpc.server import (PUSHBACK_KEY, AdmissionGate, Server,
                                     unary_stream_rpc_method_handler)
from tpurpc_torch.rpc.status import StatusCode
from tpurpc_torch.serving.scheduler import (SLO_BATCH, SLO_INTERACTIVE,
                                            DecodeScheduler, DrainingError,
                                            ShedError)
from tpurpc_torch.torchshim import codec

__all__ = ["GEN_SERVICE", "add_generation_method", "serve_generation",
           "GenerationClient"]

GEN_SERVICE = "tpurpc.Generate"

_SLO_BY_CODE = {0: SLO_INTERACTIVE, 1: SLO_BATCH}
_CODE_BY_SLO = {v: k for k, v in _SLO_BY_CODE.items()}

#: how often the token bridge re-checks client liveness while no token is
#: ready: the bound on leave detection
_POLL_S = 0.05


def _method_path(name: str) -> str:
    return f"/{GEN_SERVICE}/{name}"


def _scalar(x) -> int:
    """int() of a wire scalar, 0-d or shape (1,)."""
    arr = np.asarray(x)
    return int(arr if arr.ndim == 0 else arr.ravel()[0])


def _account_from(ctx) -> Optional[str]:
    """The caller's ``tpurpc-account`` metadata value, if it sent one."""
    try:
        for key, value in ctx.invocation_metadata():
            if key == _odyssey.ACCOUNT_KEY:
                return _odyssey.sanitize_account(value)
    except Exception:
        pass
    return None


def add_generation_method(server: Server, scheduler: DecodeScheduler,
                          name: str = "Generate") -> None:
    """Register ``/tpurpc.Generate/<name>`` streaming tokens from
    ``scheduler``. A shed is UNAVAILABLE with the pushback trailer, a
    draining scheduler refuses with UNAVAILABLE, a failed sequence ends
    INTERNAL with the model's reason; no sibling stream is touched."""

    def behavior(req, ctx):
        prompt = np.asarray(req["prompt"], dtype=np.int32).reshape(-1)
        max_tokens = _scalar(req.get("max_tokens", 32))
        slo = _SLO_BY_CODE.get(_scalar(req.get("slo", 0)),
                               SLO_INTERACTIVE)
        try:
            # the sequence inherits this RPC's trace context (the server
            # installed it as ambient) and the caller's accounting
            # identity: the journey and the ledger start here
            stream = scheduler.submit(prompt, max_tokens=max_tokens,
                                      slo=slo, trace=_tracing.current(),
                                      account=_account_from(ctx))
        except ShedError as exc:
            ctx.set_trailing_metadata([(PUSHBACK_KEY,
                                        str(exc.pushback_ms))])
            ctx.abort(StatusCode.UNAVAILABLE, f"generation shed: {exc}")
        except DrainingError as exc:
            ctx.abort(StatusCode.UNAVAILABLE, str(exc))
        idx = 0
        try:
            while True:
                if not ctx.is_active():
                    return  # client left: finally cancels the sequence
                try:
                    tok = stream.next(timeout=_POLL_S)
                except StopIteration:
                    return
                except (ShedError, DrainingError) as exc:
                    ctx.abort(StatusCode.UNAVAILABLE, str(exc))
                except Exception as exc:
                    ctx.abort(StatusCode.INTERNAL,
                              f"sequence failed: {exc}")
                if tok is None:
                    continue
                yield {"token": np.int32(tok), "index": np.int32(idx)}
                idx += 1
        finally:
            stream.cancel()

    server.add_method(
        _method_path(name),
        unary_stream_rpc_method_handler(behavior, codec.tree_deserializer,
                                        codec.tree_serializer))


def serve_generation(model, address: str = "127.0.0.1:0", *,
                     name: str = "Generate", max_batch: int = 8,
                     prefill_budget: int = 128, max_waiting: int = 32,
                     batch_shed_depth: Optional[int] = None,
                     step_slo_ms: Optional[float] = None,
                     admission: "bool | AdmissionGate" = True,
                     kv=None, max_workers: int = 32,
                     ) -> Tuple[Server, int, DecodeScheduler]:
    """Stand up a continuous-batching generation server around a step
    model. Returns ``(server, port, scheduler)``; the caller stops the
    server and closes the scheduler. The scheduler refuses new prefills
    while ``server.draining``; ``admission=True`` puts an
    :class:`AdmissionGate` sized to the scheduler in front (hard limit =
    batch + queue + 8, latency signal = the scheduler's step-time p99
    against ``step_slo_ms``)."""
    srv_box = []

    def draining() -> bool:
        return bool(srv_box and srv_box[0].draining)

    sched = DecodeScheduler(
        model, max_batch=max_batch, prefill_budget=prefill_budget,
        max_waiting=max_waiting, batch_shed_depth=batch_shed_depth,
        step_slo_ms=step_slo_ms, draining_fn=draining, kv=kv, name=name)
    gate: Optional[AdmissionGate]
    if admission is True:
        gate = AdmissionGate(
            sched.max_batch + sched.max_waiting + 8,
            soft_limit=sched.max_batch + sched.batch_shed_depth,
            latency_slo_ms=step_slo_ms,
            latency_ms_fn=sched.step_p99_ms)
    elif admission is False:
        gate = None
    else:
        gate = admission
    srv = Server(max_workers=max_workers, admission=gate)
    srv_box.append(srv)
    add_generation_method(srv, sched, name=name)
    # the load report carries waiting AND swapped work: queue depth alone
    # makes a server holding preempted sequences look idle
    srv.set_load_provider(sched.load_depth)
    srv.start()
    port = srv.add_insecure_port(address)
    return srv, port, sched


class GenerationClient:
    """Per-token streaming client of generation methods over a
    :class:`~tpurpc_torch.rpc.channel.Channel`. ``account=`` (constructor
    or per call) sends the ``tpurpc-account`` identity the server's
    ledgers roll up under."""

    def __init__(self, channel, name: str = "Generate",
                 account: Optional[str] = None):
        self._channel = channel
        self._name = name
        self._account = account

    def call(self, prompt, *, max_tokens: int = 32,
             slo: str = SLO_INTERACTIVE, timeout: Optional[float] = None,
             account: Optional[str] = None):
        """The raw streaming call: an iterator of response trees (a Call
        underneath: ``.cancel()`` it to leave mid-stream)."""
        mc = self._channel.unary_stream(
            _method_path(self._name), codec.tree_serializer,
            codec.tree_deserializer)
        req = {"prompt": np.asarray(prompt, dtype=np.int32).reshape(-1),
               "max_tokens": np.int32(max_tokens),
               "slo": np.int32(_CODE_BY_SLO[slo])}
        acct = account if account is not None else self._account
        md = [(_odyssey.ACCOUNT_KEY, acct)] if acct else None
        return mc(req, timeout=timeout, metadata=md)

    def generate(self, prompt, *, max_tokens: int = 32,
                 slo: str = SLO_INTERACTIVE,
                 timeout: Optional[float] = None,
                 account: Optional[str] = None) -> Iterator[int]:
        """Iterate generated token ids, in order, as they stream."""
        for item in self.call(prompt, max_tokens=max_tokens, slo=slo,
                              timeout=timeout, account=account):
            yield _scalar(item["token"])

    def generate_with_meta(self, prompt, *, max_tokens: int = 32,
                           slo: str = SLO_INTERACTIVE,
                           timeout: Optional[float] = None,
                           account: Optional[str] = None
                           ) -> Iterator[Tuple[int, int]]:
        """Like :meth:`generate` but yields ``(index, token)``."""
        for item in self.call(prompt, max_tokens=max_tokens, slo=slo,
                              timeout=timeout, account=account):
            yield (_scalar(item["index"]), _scalar(item["token"]))
