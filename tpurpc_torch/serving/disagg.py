"""Disaggregated prefill/decode serving over the KV plane.

A copy of ``tpurpc/serving/disagg.py``. PREFILL servers fold prompts into KV
entries and ship the blocks to DECODE servers, where the
:class:`~tpurpc_torch.serving.scheduler.DecodeScheduler` steps them. The
blocks move over the rendezvous plane's block grants
(:class:`~tpurpc_torch.core.rendezvous.BlockGrant`): the framed connection
carries only small control RPCs and every KV byte lands one-sided in the
decode server's arena (billed to the ledger's ``rdma_write``).

The handoff (all methods on the decode server, service ``tpurpc.Kv``):

    prefill/source                          decode/target
    OfferKv(seq_key, prompt, n_tokens) ──►  prefix-cache probe; allocate the
                                            block table; register PENDING
                       ◄──────────────────  grant, resume_pos/resume_hash
    one-sided write of each fresh block
    CompleteKv(handoff, last_token, …) ──►  entries live; sequence PARKED
    … the client re-attaches: ResumeSeq(seq_key) streams tokens from the
    scheduler (submit_adopted), continuing the index where prefill left.

The same protocol is live migration: :func:`migrate` detaches a running
sequence (KV intact), ships it to a peer decode server and ends the source
stream with a ``migrated`` record the client follows.

Failure contract: a peer that dies mid-handoff fails that sequence alone
with UNAVAILABLE. A PENDING handoff whose sender vanished is reaped after
``pending_ttl_s`` and its blocks QUARANTINED (a straggling one-sided write
must land in dead memory); a PARKED sequence nobody resumed is reaped and
freed.

Observability, under the reference's names: the sequence's trace context
and accounting identity ride each ``OfferKv`` as fields (``trace``,
``account``), so the decode side parks and adopts it under the same
journey and ledger; the receiver records the ``seq-ship`` span (offer ->
complete) and the ``KV_SHIP_OFFER``/``KV_SHIP_COMPLETE`` edges (tag
``disagg:<name>``); :func:`migrate` brackets each sequence in
``MIG_BEGIN``/``MIG_END`` (the watchdog's ``migration`` stage) and settles
its source ledger (``seq_migrated`` or ``seq_done``); counters
``kv_handoffs``, ``kv_handoff_bytes``, ``kv_migrations``,
``kv_migrations_failed`` and ``kv_handoffs_reaped``. :class:`DisaggClient`
sends its account as the ``tpurpc-account`` metadata key.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tpurpc_torch.analysis.locks import make_lock
from tpurpc_torch.core.rendezvous import BlockGrant, GrantWriter
from tpurpc_torch.obs import flight as _flight
from tpurpc_torch.obs import metrics as _metrics
from tpurpc_torch.obs import odyssey as _odyssey
from tpurpc_torch.obs import tracing as _tracing
from tpurpc_torch.rpc.server import (PUSHBACK_KEY, Server,
                                     unary_stream_rpc_method_handler,
                                     unary_unary_rpc_method_handler)
from tpurpc_torch.rpc.status import StatusCode
from tpurpc_torch.serving.kv import ENTRY_BYTES, HostKv, KvBlockManager
from tpurpc_torch.serving.scheduler import (SLO_INTERACTIVE,
                                            DecodeScheduler, DrainingError,
                                            ShedError, _SLO_CODE)
from tpurpc_torch.torchshim import codec

__all__ = [
    "KV_SERVICE", "DisaggDecode", "DisaggPrefill", "DisaggClient",
    "add_kv_methods", "add_prefill_methods",
    "serve_decode", "serve_prefill", "migrate", "SeqMigrated",
    "MigrationFailed", "TEST_HOOKS",
]

KV_SERVICE = "tpurpc.Kv"

_SLO_BY_CODE = {v: k for k, v in _SLO_CODE.items()}

#: how often the resume bridge re-checks client liveness
_POLL_S = 0.05

#: chaos seam: ``wedge_before_complete`` (an Event) parks every shipper
#: between its one-sided block writes and the COMPLETE until it fires
TEST_HOOKS: Dict[str, object] = {}

_HANDOFFS = _metrics.counter("kv_handoffs")
_HANDOFF_BYTES = _metrics.counter("kv_handoff_bytes")
_MIGRATIONS = _metrics.counter("kv_migrations")
_MIG_FAILED = _metrics.counter("kv_migrations_failed")
_REAPED = _metrics.counter("kv_handoffs_reaped")


class SeqMigrated(Exception):
    """Stream signal: the sequence now lives at ``address`` under
    ``seq_key``; the client re-attaches and continues at ``next_index``.
    The resume bridge turns it into a final ``migrated`` record."""

    def __init__(self, address: str, seq_key: int, next_index: int):
        super().__init__(f"migrated to {address}")
        self.address = address
        self.seq_key = int(seq_key)
        self.next_index = int(next_index)


class MigrationFailed(RuntimeError):
    """The peer died (or refused) mid-migration: the sequence fails alone
    with UNAVAILABLE."""


def _method(name: str) -> str:
    return f"/{KV_SERVICE}/{name}"


def _scalar(x) -> int:
    arr = np.asarray(x)
    return int(arr if arr.ndim == 0 else arr.ravel()[0])


def _u64(x) -> int:
    return int(np.asarray(x).astype(np.uint64).ravel()[0])


def _b(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8).copy()


def _s(arr) -> str:
    return bytes(np.asarray(arr, dtype=np.uint8)).decode()


def _uu(behavior):
    return unary_unary_rpc_method_handler(behavior, codec.tree_deserializer,
                                          codec.tree_serializer)


class _Pending:
    """A handoff between CLAIM and COMPLETE: expiry quarantines.
    ``trace``/``account`` are the sender's journey context and accounting
    identity, carried in the OfferKv request."""

    __slots__ = ("kv", "seq_key", "prompt", "deadline", "trace",
                 "account", "t0_ns")

    def __init__(self, kv, seq_key: int, prompt: np.ndarray,
                 deadline: float, trace=None, account: str = "anon"):
        self.kv = kv
        self.seq_key = seq_key
        self.prompt = prompt
        self.deadline = deadline
        self.trace = trace
        self.account = account
        self.t0_ns = time.monotonic_ns()


class _Parked:
    """A completed handoff awaiting its client's ResumeSeq: expiry
    frees."""

    __slots__ = ("kv", "prompt", "last_token", "emitted", "deadline",
                 "trace", "account", "nbytes")

    def __init__(self, kv, prompt: np.ndarray, last_token: int,
                 emitted: int, deadline: float, trace=None,
                 account: str = "anon", nbytes: int = 0):
        self.kv = kv
        self.prompt = prompt
        self.last_token = last_token
        self.emitted = emitted
        self.deadline = deadline
        self.trace = trace
        self.account = account
        self.nbytes = nbytes


class _ClosedError(Exception):
    """A registry insert lost the race against ``close()``."""


# ---------------------------------------------------------------------------
# Decode side: the handoff receiver + resume/park registry.
# ---------------------------------------------------------------------------

class DisaggDecode:
    """The decode server's KV-plane state: pending handoffs, parked
    sequences, and the OfferKv/CompleteKv/ReleaseKv/ResumeSeq handlers."""

    def __init__(self, sched: DecodeScheduler, mgr: KvBlockManager,
                 address: str = "", pending_ttl_s: float = 30.0,
                 parked_ttl_s: float = 60.0):
        self.sched = sched
        self.mgr = mgr
        self.address = address
        self.pending_ttl_s = float(pending_ttl_s)
        self.parked_ttl_s = float(parked_ttl_s)
        self._lock = make_lock("DisaggDecode._lock")
        self._pending: Dict[int, _Pending] = {}
        self._parked: Dict[int, _Parked] = {}
        self._closed = False
        self._handoff_ids = itertools.count(1)
        self._tag = _flight.tag_for(f"disagg:{sched.name}")
        self.handoffs_in = 0
        self.prefix_hits = 0
        self.quarantined_handoffs = 0

    def reap(self, now: Optional[float] = None) -> Tuple[int, int]:
        """Expire overdue entries: pending => quarantine, parked => free.
        Returns (blocks quarantined, parked freed)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            dead_p = [h for h, p in self._pending.items()
                      if p.deadline <= now]
            pend = [self._pending.pop(h) for h in dead_p]
            dead_k = [k for k, p in self._parked.items()
                      if p.deadline <= now]
            parked = [self._parked.pop(k) for k in dead_k]
        nq = 0
        for p in pend:
            nq += self.mgr.quarantine(p.kv)
            self.quarantined_handoffs += 1
            _REAPED.inc()
        for p in parked:
            self.mgr.free_blocks(p.kv, cache_prefix=True)
            _REAPED.inc()
        return nq, len(parked)

    def close(self) -> None:
        """Teardown: pending handoffs quarantine, parked sequences free;
        ``_closed`` refuses inserts that race it."""
        with self._lock:
            self._closed = True
            pend = list(self._pending.values())
            self._pending.clear()
            parked = list(self._parked.values())
            self._parked.clear()
        for p in pend:
            self.mgr.quarantine(p.kv)
        for p in parked:
            self.mgr.free_blocks(p.kv)

    def on_offer(self, req, ctx):
        self.reap()
        seq_key = _scalar(req["seq_key"])
        prompt = np.asarray(req["prompt"], dtype=np.int32).reshape(-1)
        n_tokens = _scalar(req["n_tokens"])
        if self.sched.state_str() == "draining":
            ctx.abort(StatusCode.UNAVAILABLE,
                      "decode server draining: handoff refused")
        handoff = next(self._handoff_ids)
        try:
            kv, hit = self.mgr.alloc_for_prompt(
                seq_key, prompt, reserve_entries=n_tokens)
        except Exception as exc:
            return {"ok": np.int32(0), "reason": _b(f"arena: {exc}")}
        try:
            bt = self.mgr.block_tokens
            fresh = kv.blocks[hit // bt:]
            grant = BlockGrant(
                handoff, self.mgr.kind, self.mgr.region_handle,
                self.mgr.block_bytes,
                [self.mgr.block_offset(b) for b in fresh],
                self.mgr.window_bytes, self.mgr.nonce, self.mgr.nonce_off)
            resume_hash = resume_flags = 0
            if hit:
                resume_hash, _tok, resume_flags = kv.entry(hit - 1)
                self.prefix_hits += 1
            # the sender's journey context and account ride the offer;
            # adopt() opens this process's tail buffer for the trace, so
            # the decode side's spans join the same commit
            tr = req.get("trace")
            trace = _tracing.adopt(bytes(np.asarray(tr, np.uint8))) \
                if tr is not None else _tracing.current()
            account = _odyssey.sanitize_account(
                _s(req["account"]) if "account" in req else None)
            with self._lock:
                if self._closed:
                    raise _ClosedError()
                self._pending[handoff] = _Pending(
                    kv, seq_key, prompt,
                    time.monotonic() + self.pending_ttl_s,
                    trace=trace, account=account)
        except _ClosedError:
            self.mgr.free_blocks(kv)
            ctx.abort(StatusCode.UNAVAILABLE,
                      "decode server closed: handoff refused")
        except BaseException:
            self.mgr.free_blocks(kv)
            raise
        nbytes = (n_tokens - hit) * ENTRY_BYTES
        _flight.emit(_flight.KV_SHIP_OFFER, self._tag, handoff, nbytes)
        return {
            "ok": np.int32(1),
            "handoff": np.int64(handoff),
            "grant": np.frombuffer(grant.to_wire(), np.uint8).copy(),
            "resume_pos": np.int32(hit),
            "resume_hash": np.uint64(resume_hash),
            "resume_flags": np.int32(resume_flags),
        }

    def on_complete(self, req, ctx):
        handoff = _scalar(req["handoff"])
        n_tokens = _scalar(req["n_tokens"])
        last_token = _scalar(req["last_token"])
        emitted = _scalar(req["emitted"])
        with self._lock:
            pend = self._pending.pop(handoff, None)
        if pend is None:
            ctx.abort(StatusCode.FAILED_PRECONDITION,
                      f"unknown/expired handoff {handoff} (blocks "
                      "quarantined; offer again)")
        try:
            pend.kv.set_length(n_tokens)
        except Exception as exc:
            self.mgr.quarantine(pend.kv)
            ctx.abort(StatusCode.INVALID_ARGUMENT, str(exc))
        nbytes = n_tokens * ENTRY_BYTES
        with self._lock:
            parked_ok = not self._closed
            if parked_ok:
                self._parked[pend.seq_key] = _Parked(
                    pend.kv, pend.prompt, last_token, emitted,
                    time.monotonic() + self.parked_ttl_s,
                    trace=pend.trace, account=pend.account, nbytes=nbytes)
        if not parked_ok:
            # close() swept the registries after our pop: the bytes landed,
            # so free (not quarantine) and tell the sender
            self.mgr.free_blocks(pend.kv, cache_prefix=True)
            ctx.abort(StatusCode.UNAVAILABLE,
                      "decode server closed: handoff not parked")
        self.handoffs_in += 1
        _HANDOFFS.inc()
        _HANDOFF_BYTES.inc(nbytes)
        _flight.emit(_flight.KV_SHIP_COMPLETE, self._tag, handoff, nbytes)
        # the journey's receive side of the ship, offer -> complete, under
        # the sequence's own trace (the sender records its write side)
        if pend.trace is not None:
            now = time.monotonic_ns()
            _tracing.record("seq-ship", pend.trace, pend.t0_ns,
                            now - pend.t0_ns, handoff=handoff,
                            nbytes=nbytes, account=pend.account)
        return {"ok": np.int32(1)}

    def on_release(self, req, ctx):
        """The sender abandons a claimed handoff cleanly: blocks free."""
        handoff = _scalar(req["handoff"])
        with self._lock:
            pend = self._pending.pop(handoff, None)
        if pend is not None:
            self.mgr.free_blocks(pend.kv)
        return {"ok": np.int32(1)}

    def on_resume(self, req, ctx):
        """Stream re-attach: park -> scheduler -> per-token stream,
        continuing the client-visible index. A migration ends the stream
        with a ``migrated`` record."""
        seq_key = _scalar(req["seq_key"])
        max_tokens = _scalar(req.get("max_tokens", 32))
        slo = _SLO_BY_CODE.get(_scalar(req.get("slo", 0)), SLO_INTERACTIVE)
        with self._lock:
            parked = self._parked.pop(seq_key, None)
        if parked is None:
            ctx.abort(StatusCode.NOT_FOUND,
                      f"no parked sequence {seq_key} (expired or already "
                      "resumed)")
        try:
            stream = self.sched.submit_adopted(
                parked.kv, parked.prompt, last_token=parked.last_token,
                emitted=parked.emitted, max_tokens=max_tokens, slo=slo,
                trace=parked.trace, account=parked.account,
                shipped_bytes=parked.nbytes)
        except ShedError as exc:
            self.mgr.free_blocks(parked.kv, cache_prefix=True)
            ctx.set_trailing_metadata([(PUSHBACK_KEY,
                                        str(exc.pushback_ms))])
            ctx.abort(StatusCode.UNAVAILABLE, f"resume shed: {exc}")
        except Exception as exc:
            self.mgr.free_blocks(parked.kv, cache_prefix=True)
            code = (StatusCode.UNAVAILABLE
                    if isinstance(exc, DrainingError)
                    else StatusCode.INTERNAL)
            ctx.abort(code, str(exc))
        idx = parked.emitted
        try:
            while True:
                if not ctx.is_active():
                    return
                try:
                    tok = stream.next(timeout=_POLL_S)
                except StopIteration:
                    return
                except SeqMigrated as mig:
                    yield {"migrated": _b(mig.address),
                           "seq_key": np.int64(mig.seq_key),
                           "next_index": np.int32(mig.next_index)}
                    return
                except MigrationFailed as exc:
                    ctx.abort(StatusCode.UNAVAILABLE,
                              f"migration failed: {exc}")
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

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "pending": len(self._pending),
                "parked": len(self._parked),
                "handoffs_in": self.handoffs_in,
                "prefix_hits": self.prefix_hits,
                "quarantined_handoffs": self.quarantined_handoffs,
            }


def add_kv_methods(server: Server, state: DisaggDecode) -> None:
    server.add_method(_method("OfferKv"), _uu(state.on_offer))
    server.add_method(_method("CompleteKv"), _uu(state.on_complete))
    server.add_method(_method("ReleaseKv"), _uu(state.on_release))
    server.add_method(
        _method("ResumeSeq"),
        unary_stream_rpc_method_handler(state.on_resume,
                                        codec.tree_deserializer,
                                        codec.tree_serializer))


# ---------------------------------------------------------------------------
# The shipper: one handoff over the grant plane (prefill AND migration).
# ---------------------------------------------------------------------------

def _offer_req(seq_key: int, prompt: np.ndarray, n_tokens: int, trace,
               account: Optional[str]) -> dict:
    """One OfferKv request. The sequence's journey context and accounting
    identity cross the split IN the offer: call metadata would bind to the
    RPC, and a burst carries a different sequence per request."""
    req = {"seq_key": np.int64(seq_key), "prompt": prompt,
           "n_tokens": np.int32(n_tokens)}
    if trace is not None:
        req["trace"] = _b(trace.encode())
    if account:
        req["account"] = _b(account)
    return req


class _KvShipper:
    """Sender-side handoff driver shared by the prefill server and the
    migration path: OfferKv -> one-sided block writes -> CompleteKv; a
    clean local failure releases the claim so the peer frees."""

    def __init__(self, channel):
        self._channel = channel
        self._offer = channel.unary_unary(_method("OfferKv"),
                                          codec.tree_serializer,
                                          codec.tree_deserializer)
        self._complete = channel.unary_unary(_method("CompleteKv"),
                                             codec.tree_serializer,
                                             codec.tree_deserializer)
        self._release = channel.unary_unary(_method("ReleaseKv"),
                                            codec.tree_serializer,
                                            codec.tree_deserializer)
        self.writer = GrantWriter()

    def _burst(self, mc, reqs, timeout: float):
        """Issue a burst of small control RPCs pipelined on one connection,
        their fused sends coalesced into ONE writev (``Channel.batch_calls``
        over ``FrameWriter.batch``); one result-or-exception per request,
        in order."""
        import contextlib

        if len(reqs) == 1:
            try:
                return [mc(reqs[0], timeout=timeout)]
            except Exception as exc:
                return [exc]
        pipe = mc.pipeline(depth=max(1, len(reqs)))
        batcher = getattr(self._channel, "batch_calls", None)
        cm = batcher() if batcher is not None else contextlib.nullcontext()
        with cm:
            futs = [pipe.call_async(r, timeout=timeout) for r in reqs]
        out = []
        for fut in futs:
            try:
                out.append(fut.result(timeout=timeout + 1))
            except Exception as exc:
                out.append(exc)
        return out

    def offer(self, seq_key: int, prompt: np.ndarray, n_tokens: int,
              timeout: float, trace=None, account: Optional[str] = None):
        resp = self._offer(_offer_req(seq_key, prompt, n_tokens, trace,
                                      account), timeout=timeout)
        if not _scalar(resp["ok"]):
            raise MigrationFailed(
                f"handoff refused: {_s(resp.get('reason', b''))}")
        grant = BlockGrant.from_wire(bytes(
            np.asarray(resp["grant"], np.uint8)))
        return (grant, _scalar(resp["handoff"]),
                _scalar(resp["resume_pos"]), _u64(resp["resume_hash"]),
                _scalar(resp["resume_flags"]))

    def ship(self, grant: BlockGrant, handoff: int, payload: memoryview,
             n_tokens: int, last_token: int, emitted: int,
             timeout: float) -> None:
        chunks = [payload[o:o + grant.block_bytes]
                  for o in range(0, len(payload), grant.block_bytes)]
        try:
            self.writer.write_blocks(grant, chunks)
        except BaseException:
            # clean local failure: tell the peer to free
            try:
                self._release({"handoff": np.int64(handoff)}, timeout=2)
            except Exception:
                pass  # peer unreachable: its TTL reap quarantines
            raise
        wedge = TEST_HOOKS.get("wedge_before_complete")
        if wedge is not None:
            wedge.wait(10)
        self._complete({"handoff": np.int64(handoff),
                        "n_tokens": np.int32(n_tokens),
                        "last_token": np.int32(last_token),
                        "emitted": np.int32(emitted)}, timeout=timeout)

    def close(self) -> None:
        self.writer.close()


# ---------------------------------------------------------------------------
# Prefill side.
# ---------------------------------------------------------------------------

class DisaggPrefill:
    """The prefill server's engine: fold prompts into KV entries in host
    scratch, ship them over the grant plane, answer with the re-attach key
    and the first token."""

    def __init__(self, model, decode_channel, decode_address: str,
                 timeout_s: float = 10.0):
        if not hasattr(model, "prefill_paged"):
            raise ValueError("prefill serving needs the explicit-KV model "
                             "contract (prefill_paged)")
        self.model = model
        self.decode_address = decode_address
        self._shipper = _KvShipper(decode_channel)
        self.timeout_s = float(timeout_s)
        base = int.from_bytes(os.urandom(4), "big") << 20
        self._keys = itertools.count(base + 1)
        self.prefills = 0
        self.shipped_bytes = 0
        self.prefix_skipped_entries = 0

    def on_prefill(self, req, ctx):
        prompt = np.asarray(req["prompt"], dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            ctx.abort(StatusCode.INVALID_ARGUMENT, "empty prompt")
        seq_key = next(self._keys)
        n_tokens = int(prompt.size) + 1  # prompt entries + first sample
        # this RPC's ambient trace and the caller's account ride the
        # offer, so the decode side parks the sequence under the journey
        # and identity the client started
        trace = _tracing.current()
        account = None
        try:
            for key, value in ctx.invocation_metadata():
                if key == _odyssey.ACCOUNT_KEY:
                    account = _odyssey.sanitize_account(value)
                    break
        except Exception:
            pass
        try:
            grant, handoff, pos, rhash, rflags = self._shipper.offer(
                seq_key, prompt, n_tokens, self.timeout_s,
                trace=trace, account=account)
            host = HostKv(base_pos=pos, base_hash=rhash, base_flags=rflags)
            first = int(self.model.prefill_paged([prompt], [host])[0])
            payload = host.payload()
            self._shipper.ship(grant, handoff, payload, n_tokens, first,
                               1, self.timeout_s)
        except MigrationFailed as exc:
            ctx.abort(StatusCode.UNAVAILABLE, str(exc))
        except Exception as exc:
            ctx.abort(StatusCode.UNAVAILABLE,
                      f"handoff to {self.decode_address} failed: {exc}")
        self.prefills += 1
        self.shipped_bytes += len(payload)
        self.prefix_skipped_entries += pos
        return {"seq_key": np.int64(seq_key),
                "first_token": np.int32(first),
                "decode_address": _b(self.decode_address)}

    def on_stats(self, req, ctx):
        from tpurpc_torch.tpu import ledger

        snap = ledger.snapshot()
        return {"prefills": np.int64(self.prefills),
                "shipped_bytes": np.int64(self.shipped_bytes),
                "prefix_skipped_entries":
                    np.int64(self.prefix_skipped_entries),
                "rdma_write": np.int64(snap["rdma_write"]),
                "host_copy": np.int64(snap["host_copy"])}

    def close(self) -> None:
        self._shipper.close()


def add_prefill_methods(server: Server, state: DisaggPrefill) -> None:
    server.add_method(_method("Prefill"), _uu(state.on_prefill))
    server.add_method(_method("PrefillStats"), _uu(state.on_stats))


# ---------------------------------------------------------------------------
# Live migration (source side).
# ---------------------------------------------------------------------------

def migrate(state: DisaggDecode, peer_channel, peer_address: str,
            sids: Optional[List[int]] = None,
            timeout_s: float = 10.0) -> Tuple[int, int]:
    """Move live sequences (KV + stream) from ``state``'s scheduler to the
    decode server at ``peer_channel``/``peer_address``: detach at a step
    boundary, OfferKv/ship/CompleteKv (offers and completes each pipelined
    as one burst), then end the source stream with the re-attach record.
    Any failure fails that sequence alone with UNAVAILABLE. Returns
    ``(moved, failed)``."""
    sched = state.sched
    shipper = _KvShipper(peer_channel)
    moved = failed = 0

    def fail_one(s, exc) -> None:
        nonlocal failed
        sid = s.sid
        _flight.emit(_flight.MIG_END, state._tag, sid, 0)
        _MIG_FAILED.inc()
        # our blocks saw no foreign writer: free locally; the peer's TTL
        # reap quarantines ITS claimed blocks
        state.mgr.free_blocks(s.kv)
        s.kv = None
        _odyssey.seq_done(s.led, "failed")
        s.q.put(MigrationFailed(str(exc)))
        failed += 1

    try:
        live = []
        for sid in (sids if sids is not None else sched.live_sids()):
            s = sched.detach(sid)
            if s is None:
                continue
            if s.kv is None or s.cancelled:
                _odyssey.seq_done(s.led, "failed")
                s.q.put(MigrationFailed("sequence had no shippable KV"))
                failed += 1
                continue
            n_entries = s.kv.length
            _flight.emit(_flight.MIG_BEGIN, state._tag, sid, n_entries)
            seq_key = (int(time.monotonic_ns()) << 8 | (sid & 0xFF)) \
                & 0x7FFFFFFFFFFFFFFF
            live.append((s, n_entries, seq_key, time.monotonic_ns()))
        # each migrating sequence carries its own journey context and
        # account across the hop
        resps = shipper._burst(
            shipper._offer,
            [_offer_req(k, s.prompt, n, s.trace, s.account)
             for s, n, k, _t0 in live],
            timeout_s) if live else []
        pending = []  # (s, seq_key, t0, shipped, CompleteKv request)
        for (s, n_entries, seq_key, t0), resp in zip(live, resps):
            try:
                if isinstance(resp, Exception):
                    raise resp
                if not _scalar(resp["ok"]):
                    raise MigrationFailed(
                        f"handoff refused: {_s(resp.get('reason', b''))}")
                grant = BlockGrant.from_wire(bytes(
                    np.asarray(resp["grant"], np.uint8)))
                handoff = _scalar(resp["handoff"])
                pos = _scalar(resp["resume_pos"])
                chunks = [v for _bi, v in s.kv.chunks(pos, n_entries)]
                shipper.writer.write_blocks(grant, chunks)
            except Exception as exc:
                fail_one(s, exc)
                continue
            pending.append((s, seq_key, t0,
                            (n_entries - pos) * ENTRY_BYTES,
                            {"handoff": np.int64(handoff),
                             "n_tokens": np.int32(n_entries),
                             "last_token": np.int32(s.last_token),
                             "emitted": np.int32(s.emitted)}))
        wedge = TEST_HOOKS.get("wedge_before_complete")
        if wedge is not None and pending:
            wedge.wait(10)
        cresps = shipper._burst(shipper._complete,
                                [req for *_x, req in pending],
                                timeout_s) if pending else []
        for (s, seq_key, t0, shipped, _req), resp in zip(pending, cresps):
            if isinstance(resp, Exception):
                fail_one(s, resp)
                continue
            state.mgr.free_blocks(s.kv, cache_prefix=True)
            s.kv = None
            sid = s.sid
            _flight.emit(_flight.MIG_END, state._tag, sid, 1)
            _MIGRATIONS.inc()
            # settle the source ledger: the migration count, the hop's
            # bytes and the seq-migrate span (a migrated journey always
            # commits its trace)
            _odyssey.seq_migrated(s.led, shipped, t0)
            s.q.put(SeqMigrated(peer_address, seq_key, s.emitted))
            moved += 1
    finally:
        shipper.close()
    return moved, failed


# ---------------------------------------------------------------------------
# One-liners + the re-attaching client.
# ---------------------------------------------------------------------------

def serve_decode(model, address: str = "127.0.0.1:0", *,
                 kv_blocks: int = 512, block_bytes: int = 2048,
                 kv_kind: str = "shm", name: str = "decode",
                 max_batch: int = 8, max_waiting: int = 32,
                 prefill_budget: int = 128,
                 batch_shed_depth: Optional[int] = None,
                 step_slo_ms: Optional[float] = None,
                 pending_ttl_s: float = 30.0, parked_ttl_s: float = 60.0,
                 migrate_to: Optional[Callable[[], Tuple[object, str]]]
                 = None,
                 max_workers: int = 32,
                 ) -> Tuple[Server, int, DecodeScheduler, DisaggDecode]:
    """A decode server: paged scheduler over a ``kv_kind`` arena, the
    handoff/resume methods and the standard Generate method; with
    ``migrate_to`` returning ``(channel, address)``, a drain hook that
    migrates every live sequence before the drain waits."""
    from tpurpc_torch.serving.api import add_generation_method

    mgr = KvBlockManager(n_blocks=kv_blocks, block_bytes=block_bytes,
                         kind=kv_kind, name=name)
    srv_box: list = []

    def draining() -> bool:
        return bool(srv_box and srv_box[0].draining)

    sched = DecodeScheduler(
        model, kv=mgr, max_batch=max_batch, max_waiting=max_waiting,
        prefill_budget=prefill_budget, batch_shed_depth=batch_shed_depth,
        step_slo_ms=step_slo_ms, draining_fn=draining, name=name)
    srv = Server(max_workers=max_workers)
    srv_box.append(srv)
    state = DisaggDecode(sched, mgr, pending_ttl_s=pending_ttl_s,
                         parked_ttl_s=parked_ttl_s)
    add_kv_methods(srv, state)
    add_generation_method(srv, sched, name="Generate")
    srv.set_load_provider(sched.load_depth)
    if migrate_to is not None:
        def _drain_migrate() -> None:
            try:
                ch, addr = migrate_to()
            except Exception:
                return
            try:
                migrate(state, ch, addr)
            except Exception:
                pass  # drain continues; unmigrated streams finish here
        srv.add_drain_hook(_drain_migrate)
    srv.start()
    port = srv.add_insecure_port(address)
    state.address = f"127.0.0.1:{port}"
    return srv, port, sched, state


def serve_prefill(model, decode_channel, decode_address: str,
                  address: str = "127.0.0.1:0", *,
                  max_workers: int = 16,
                  ) -> Tuple[Server, int, DisaggPrefill]:
    """A prefill server shipping into ``decode_address``'s arena."""
    state = DisaggPrefill(model, decode_channel, decode_address)
    srv = Server(max_workers=max_workers)
    add_prefill_methods(srv, state)
    srv.start()
    port = srv.add_insecure_port(address)
    return srv, port, state


class DisaggClient:
    """The re-attaching generation client: Prefill on the prefill tier,
    ResumeSeq on the decode tier, following ``migrated`` records; the
    caller sees one ordered token stream."""

    def __init__(self, prefill_channel, decode_address: str,
                 channel_factory: Optional[Callable[[str], object]]
                 = None, account: Optional[str] = None):
        self._prefill = prefill_channel.unary_unary(
            _method("Prefill"), codec.tree_serializer,
            codec.tree_deserializer)
        self._decode_address = decode_address
        #: the accounting identity, sent on every control RPC as the
        #: ``tpurpc-account`` metadata key
        self._account = account
        if channel_factory is None:
            from tpurpc_torch.rpc.channel import Channel

            channel_factory = Channel
        self._factory = channel_factory
        self._channels: Dict[str, object] = {}

    def _md(self):
        return [(_odyssey.ACCOUNT_KEY, self._account)] \
            if self._account else None

    def _channel(self, address: str):
        ch = self._channels.get(address)
        if ch is None:
            ch = self._channels[address] = self._factory(address)
        return ch

    def generate_with_meta(self, prompt, *, max_tokens: int = 32,
                           slo: str = SLO_INTERACTIVE,
                           timeout: Optional[float] = None):
        """Yield ``(index, token)`` pairs, indices 0..n-1 across prefill,
        decode and any number of migrations."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        resp = self._prefill({"prompt": prompt}, timeout=timeout,
                             metadata=self._md())
        seq_key = _scalar(resp["seq_key"])
        address = _s(resp["decode_address"]) or self._decode_address
        yield 0, _scalar(resp["first_token"])
        emitted = 1
        while emitted < max_tokens:
            mc = self._channel(address).unary_stream(
                _method("ResumeSeq"), codec.tree_serializer,
                codec.tree_deserializer)
            call = mc({"seq_key": np.int64(seq_key),
                       "max_tokens": np.int32(max_tokens),
                       "slo": np.int32(_SLO_CODE[slo])}, timeout=timeout,
                      metadata=self._md())
            migrated = None
            for item in call:
                if "migrated" in item:
                    migrated = (_s(item["migrated"]),
                                _scalar(item["seq_key"]))
                    break
                yield _scalar(item["index"]), _scalar(item["token"])
                emitted += 1
            if migrated is None:
                return
            address, seq_key = migrated

    def generate(self, prompt, *, max_tokens: int = 32,
                 slo: str = SLO_INTERACTIVE,
                 timeout: Optional[float] = None):
        for _i, tok in self.generate_with_meta(prompt,
                                               max_tokens=max_tokens,
                                               slo=slo, timeout=timeout):
            yield tok

    def close(self) -> None:
        for ch in self._channels.values():
            try:
                ch.close()
            except Exception:
                pass
        self._channels.clear()
