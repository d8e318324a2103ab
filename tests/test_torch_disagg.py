"""The port's disaggregated prefill/decode plane against the reference's.

Each scenario stands up one package's prefill tier and decode tier(s) on
loopback and drives them through that package's ``DisaggClient``; the
observations must be equal: exact tokens and indices, the bytes shipped
over block grants (as ``ledger.track()`` deltas of ``rdma_write``), prefix
hits, the registry's reaping (pending => quarantine, parked => free), live
migration and its failure when the target dies mid-handoff. The port's
models run on the CPU. Moments that the reference's tests reach with
sleeps (a migration while a stream decodes) are reached here by parking
the source's decode step until the migration has asked for the sequence.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import tpurpc.serving.disagg as ref_disagg
from tpurpc.core import _native as ref_native
from tpurpc.jaxshim import codec as ref_codec
from tpurpc.jaxshim import generate as ref_gen
from tpurpc.obs import flight as ref_flight
from tpurpc.rpc.channel import Channel as RefChannel
from tpurpc.rpc.status import RpcError as RefRpcError
from tpurpc.serving import scheduler as ref_sched
from tpurpc.tpu import ledger as ref_ledger
from tpurpc.utils import config as ref_config
from tpurpc_torch.core.poller import PairPool, Poller
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.rpc.status import RpcError
from tpurpc_torch.serving import disagg as port_disagg
from tpurpc_torch.serving import scheduler as port_sched
from tpurpc_torch.torchshim import codec as port_codec
from tpurpc_torch.torchshim import generate as port_gen
from tpurpc_torch.tpu import ledger as port_ledger
from tpurpc_torch.utils import config as torch_config

#: every wait on a stream, thread or RPC, seconds
WAIT = 30.0

REF = SimpleNamespace(
    name="ref", disagg=ref_disagg, sched=ref_sched, codec=ref_codec,
    ledger=ref_ledger, channel=RefChannel, error=RefRpcError,
    model=ref_gen.ToyDecodeModel)
PORT = SimpleNamespace(
    name="port", disagg=port_disagg, sched=port_sched, codec=port_codec,
    ledger=port_ledger, channel=Channel, error=RpcError,
    model=lambda **kw: port_gen.ToyDecodeModel(device="cpu", **kw))
BOTH = (REF, PORT)
ref_decode = port_gen.reference_decode


@pytest.fixture(autouse=True)
def _clean():
    """Bounded streams; afterwards no chaos hook, and the reference's
    flight ring emptied so that a later test in this process does not read
    this test's handoff events."""
    saved = [m.sched.TokenStream.MAX_IDLE_S for m in BOTH]
    for m in BOTH:
        m.sched.TokenStream.MAX_IDLE_S = WAIT
    yield
    for m, old in zip(BOTH, saved):
        m.sched.TokenStream.MAX_IDLE_S = old
        m.disagg.TEST_HOOKS.clear()
    ref_flight.RECORDER.reset()


def _same(run):
    got = {m.name: run(m) for m in BOTH}
    assert got["ref"] == got["port"], got
    return got["port"]


def _wait(pred, what):
    ev = threading.Event()
    for _ in range(int(WAIT / 0.005)):
        if pred():
            return
        ev.wait(0.005)
    raise AssertionError(f"timed out waiting for {what}")


class _Held:
    """Parks a model's decode steps (paged contract) until allowed."""

    def __init__(self, model):
        self.model = model
        self._cv = threading.Condition()
        self._credits = 0
        self.steps = 0
        inner = model.step_paged

        def step_paged(kvs, tokens):
            with self._cv:
                self.steps += 1
                deadline = time.monotonic() + WAIT
                while self._credits == 0:
                    left = deadline - time.monotonic()
                    assert left > 0, "held step never released"
                    self._cv.wait(left)
                if self._credits is not None:
                    self._credits -= 1
            return inner(kvs, tokens)
        model.step_paged = step_paged

    def allow(self, n):
        with self._cv:
            self._credits += n
            self._cv.notify_all()

    def release(self):
        with self._cv:
            self._credits = None
            self._cv.notify_all()


class _Stack:
    """One prefill + N decode servers of one package, torn down in order.
    ``held`` parks the first decode server's steps."""

    def __init__(self, m, n_decode=1, held=False, **decode_kw):
        decode_kw.setdefault("kv_blocks", 128)
        decode_kw.setdefault("block_bytes", 256)
        self.m = m
        self.held = None
        self.decodes = []
        for i in range(n_decode):
            model = m.model()
            if held and i == 0:
                self.held = _Held(model)
            self.decodes.append(m.disagg.serve_decode(
                model, name=f"dec{i}", **decode_kw))
        self.addr = [f"127.0.0.1:{d[1]}" for d in self.decodes]
        self.d_ch = m.channel(self.addr[0])
        self.p_srv, self.p_port, self.p_state = m.disagg.serve_prefill(
            m.model(), self.d_ch, self.addr[0])
        self.p_ch = m.channel(f"127.0.0.1:{self.p_port}")
        self.client = m.disagg.DisaggClient(self.p_ch, self.addr[0])

    def stream(self, out, key, prompt, n):
        """Run one client stream on a thread into ``out[key]``."""
        def go():
            try:
                out[key] = ("ok", list(self.client.generate_with_meta(
                    prompt, max_tokens=n, timeout=WAIT)))
            except self.m.error as exc:
                out[key] = ("err", exc.code().name)
        t = threading.Thread(target=go, daemon=True)
        t.start()
        return t

    def close(self):
        if self.held is not None:
            self.held.release()
        self.client.close()
        self.p_srv.stop(grace=0)
        self.p_state.close()
        for srv, _port, sched, state in self.decodes:
            srv.stop(grace=0)
            sched.close()
            state.close()
            state.mgr.close()
        self.p_ch.close()
        self.d_ch.close()


# -- the handoff end to end ---------------------------------------------------

@pytest.mark.parametrize("prompt_len", [1, 20, 47])
def test_disagg_stream_exact_tokens_and_ship_accounting(prompt_len):
    prompt = list(range(3, 3 + prompt_len))

    def run(m):
        st = _Stack(m)
        try:
            with m.ledger.track() as w:
                pairs = list(st.client.generate_with_meta(
                    prompt, max_tokens=12, timeout=WAIT))
            return (pairs, w["rdma_write"], w["rdma_write_ops"],
                    st.p_state.shipped_bytes, st.decodes[0][3].stats())
        finally:
            st.close()
    pairs, billed, ops, shipped, stats = _same(run)
    assert [i for i, _ in pairs] == list(range(12))
    assert [t for _, t in pairs] == ref_decode(prompt, 12)
    # the prompt's entries and the first sample's went one-sided
    assert billed == shipped == (prompt_len + 1) * 16 and ops == 1
    assert stats["handoffs_in"] == 1 and stats["parked"] == 0


def test_disagg_repeated_prompt_scores_prefix_hit_and_ships_less():
    prompt = list(range(32))   # 33 entries; aligned span = 32

    def run(m):
        st = _Stack(m)
        try:
            a = list(st.client.generate(prompt, max_tokens=4, timeout=WAIT))
            cold = st.p_state.shipped_bytes
            with m.ledger.track() as w:
                b = list(st.client.generate(prompt, max_tokens=4,
                                            timeout=WAIT))
            warm = st.p_state.shipped_bytes - cold
            state = st.decodes[0][3]
            return (a, b, cold, warm, w["rdma_write"], state.prefix_hits,
                    st.p_state.prefix_skipped_entries)
        finally:
            st.close()
    a, b, cold, warm, billed, hits, skipped = _same(run)
    assert a == b == ref_decode(prompt, 4)
    assert (cold, warm, billed, hits, skipped) == (33 * 16, 16, 16, 1, 32)


def test_disagg_concurrent_streams_no_crosstalk():
    def run(m):
        st = _Stack(m)
        try:
            out = {}
            threads = [st.stream(out, i, [i, i], 10) for i in range(5)]
            for t in threads:
                t.join(WAIT)
            return [out.get(i) for i in range(5)]
        finally:
            st.close()
    got = _same(run)
    assert got == [("ok", list(enumerate(ref_decode([i, i], 10))))
                   for i in range(5)]


def test_resume_unknown_seq_is_not_found():
    def run(m):
        st = _Stack(m)
        try:
            mc = st.client._channel(st.addr[0]).unary_stream(
                "/tpurpc.Kv/ResumeSeq", m.codec.tree_serializer,
                m.codec.tree_deserializer)
            try:
                list(mc({"seq_key": np.int64(424242),
                         "max_tokens": np.int32(4)}, timeout=WAIT))
                return "no error"
            except m.error as exc:
                return exc.code().name
        finally:
            st.close()
    assert _same(run) == "NOT_FOUND"


def test_reap_pending_quarantines_parked_frees():
    """A parked sequence nobody resumes and a pending handoff nobody
    completes; a reap past both deadlines frees the first and quarantines
    the second."""
    def run(m):
        st = _Stack(m)
        try:
            state = st.decodes[0][3]
            mgr = state.mgr
            pre = st.p_ch.unary_unary("/tpurpc.Kv/Prefill",
                                      m.codec.tree_serializer,
                                      m.codec.tree_deserializer)
            pre({"prompt": np.asarray([1, 2, 3], np.int32)}, timeout=WAIT)
            obs = [state.stats()["parked"], mgr.used_count()]
            omc = st.client._channel(st.addr[0]).unary_unary(
                "/tpurpc.Kv/OfferKv", m.codec.tree_serializer,
                m.codec.tree_deserializer)
            resp = omc({"seq_key": np.int64(777),
                        "prompt": np.asarray([9, 9], np.int32),
                        "n_tokens": np.int32(3)}, timeout=WAIT)
            obs += [int(np.asarray(resp["ok"]).ravel()[0]),
                    int(np.asarray(resp["resume_pos"]).ravel()[0]),
                    state.stats()["pending"], mgr.used_count()]
            nq, nf = state.reap(now=time.monotonic() + 3600)
            obs += [nq, nf, mgr.quarantined_count(), mgr.used_count(),
                    mgr.free_count(), state.stats()]
            return obs
        finally:
            st.close()
    obs = _same(run)
    assert obs[:6] == [1, 1, 1, 0, 1, 2]
    assert obs[6:11] == [1, 1, 1, 0, 127]


def test_complete_of_unknown_handoff_fails_precondition():
    def run(m):
        st = _Stack(m)
        try:
            cmc = st.client._channel(st.addr[0]).unary_unary(
                "/tpurpc.Kv/CompleteKv", m.codec.tree_serializer,
                m.codec.tree_deserializer)
            try:
                cmc({"handoff": np.int64(99), "n_tokens": np.int32(2),
                     "last_token": np.int32(1), "emitted": np.int32(1)},
                    timeout=WAIT)
                return "no error"
            except m.error as exc:
                return exc.code().name
        finally:
            st.close()
    assert _same(run) == "FAILED_PRECONDITION"


def test_offer_to_a_full_arena_is_refused_not_raised():
    def run(m):
        st = _Stack(m, kv_blocks=2, block_bytes=64)
        try:
            omc = st.client._channel(st.addr[0]).unary_unary(
                "/tpurpc.Kv/OfferKv", m.codec.tree_serializer,
                m.codec.tree_deserializer)
            resp = omc({"seq_key": np.int64(5),
                        "prompt": np.arange(20, dtype=np.int32),
                        "n_tokens": np.int32(21)}, timeout=WAIT)
            reason = bytes(np.asarray(resp["reason"], np.uint8)).decode()
            return (int(np.asarray(resp["ok"]).ravel()[0]),
                    reason.startswith("arena:"),
                    st.decodes[0][3].mgr.used_count())
        finally:
            st.close()
    assert _same(run) == (0, True, 0)


# -- live migration -----------------------------------------------------------

def _migrate_when_asked(m, st, peer, **kw):
    """Start ``migrate`` from decode 0 to ``peer`` on a thread, let the
    held step go once the migration has asked for its sequences, then let
    every step run. Returns (thread, result box)."""
    box = {}
    sched = st.decodes[0][2]
    a_ch = m.channel(st.addr[peer])

    def go():
        try:
            box["r"] = m.disagg.migrate(st.decodes[0][3], a_ch,
                                        st.addr[peer], **kw)
        finally:
            a_ch.close()
    t = threading.Thread(target=go, daemon=True)
    t.start()
    _wait(lambda: sched._detach_req, "the migration's detach request")
    st.held.release()
    return t, box


def test_migration_continues_stream_exact_on_peer():
    def run(m):
        st = _Stack(m, n_decode=2, held=True)
        try:
            a, b = st.decodes
            out = {}
            t = st.stream(out, "s", [5, 6], 50)
            _wait(lambda: st.held.steps >= 1, "the stream's first step")
            mt, box = _migrate_when_asked(m, st, 1)
            mt.join(WAIT)
            t.join(WAIT)
            _wait(lambda: a[3].mgr.used_count() == 0, "the source freed")
            return (box.get("r"), out.get("s"), b[2].tokens_out > 0,
                    a[3].mgr.used_count(), b[3].stats()["handoffs_in"])
        finally:
            st.close()
    r, (kind, pairs), stepped, used, handoffs = _same(run)
    assert r == (1, 0) and kind == "ok" and stepped
    assert pairs == list(enumerate(ref_decode([5, 6], 50)))
    assert (used, handoffs) == (0, 1)


def test_drain_hook_migrates_live_streams():
    """``Server.drain`` on a decode server wired with ``migrate_to`` moves
    its live stream to the peer, which finishes it exactly."""
    def run(m):
        b_srv, b_port, b_sched, b_state = m.disagg.serve_decode(
            m.model(), name="drainB", kv_blocks=128, block_bytes=256)
        b_ch = m.channel(f"127.0.0.1:{b_port}")
        held = _Held(m.model())
        a_srv, a_port, a_sched, a_state = m.disagg.serve_decode(
            held.model, name="drainA", kv_blocks=128, block_bytes=256,
            migrate_to=lambda: (b_ch, f"127.0.0.1:{b_port}"))
        a_ch = m.channel(f"127.0.0.1:{a_port}")
        p_srv, p_port, p_state = m.disagg.serve_prefill(
            m.model(), a_ch, f"127.0.0.1:{a_port}")
        p_ch = m.channel(f"127.0.0.1:{p_port}")
        cli = m.disagg.DisaggClient(p_ch, f"127.0.0.1:{a_port}")
        try:
            out = {}

            def go():
                out["pairs"] = list(cli.generate_with_meta(
                    [3, 3], max_tokens=40, timeout=WAIT))
            t = threading.Thread(target=go, daemon=True)
            t.start()
            _wait(lambda: held.steps >= 1, "the stream's first step")
            drained = []
            d = threading.Thread(target=lambda: drained.append(
                a_srv.drain(linger=WAIT)), daemon=True)
            d.start()
            _wait(lambda: a_sched._detach_req, "the drain's migration")
            held.release()
            t.join(WAIT)
            d.join(WAIT)
            return out.get("pairs"), b_sched.tokens_out > 0, drained
        finally:
            held.release()
            cli.close()
            p_srv.stop(grace=0)
            p_state.close()
            for srv, sched, state in ((a_srv, a_sched, a_state),
                                      (b_srv, b_sched, b_state)):
                srv.stop(grace=0)
                sched.close()
                state.close()
                state.mgr.close()
            for ch in (p_ch, a_ch, b_ch):
                ch.close()
    pairs, moved, drained = _same(run)
    assert pairs == list(enumerate(ref_decode([3, 3], 40)))
    assert moved and drained == [True]


# -- chaos: the target dies mid-migration -------------------------------------

@pytest.fixture
def platform(monkeypatch):
    # The reference loads its native library on a ring's first use and,
    # in a checkout without native/build, first builds it with g++ under
    # an exclusive lock that every other process waits on for the whole
    # compile. Take that wait here, not inside a call that has a deadline.
    ref_native.load()

    def use(name):
        monkeypatch.setenv("GRPC_PLATFORM_TYPE", name)
        monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
        ref_config.set_config(None)
        torch_config.set_config(None)
    yield use
    ref_config.set_config(None)
    torch_config.set_config(None)
    Poller.reset()
    PairPool.reset()


@pytest.mark.parametrize("name", ["TCP", "RDMA_BPEV"])
def test_decode_death_mid_migration_fails_alone_and_quarantines(platform,
                                                                name):
    """The migration target dies between the one-sided block writes and
    the COMPLETE: the migrating sequence fails alone with UNAVAILABLE, its
    sibling on the source finishes exactly, and the dead handoff's blocks
    are quarantined, never freed."""
    platform(name)

    def run(m):
        st = _Stack(m, n_decode=2, held=True)
        try:
            a, b = st.decodes
            out = {}
            t1 = st.stream(out, "victim", [5, 6], 200)
            _wait(lambda: st.held.steps >= 1, "the victim's first step")
            t2 = st.stream(out, "sibling", [7], 30)
            _wait(lambda: a[2].queue_depth() >= 1, "the sibling queued")
            wedge = threading.Event()
            m.disagg.TEST_HOOKS["wedge_before_complete"] = wedge
            mt, box = _migrate_when_asked(m, st, 1, sids=[1], timeout_s=5.0)
            _wait(lambda: b[3].stats()["pending"] >= 1, "the pending offer")
            pending_blocks = b[3].mgr.used_count()
            b[0].stop(grace=0)
            wedge.set()
            mt.join(WAIT)
            t1.join(WAIT)
            t2.join(WAIT)
            nq, _nf = b[3].reap(now=time.monotonic() + 3600)
            mgr = b[3].mgr
            return (pending_blocks > 0, mt.is_alive(), box.get("r"),
                    out.get("victim"), out.get("sibling"), nq >= 1,
                    mgr.quarantined_count() >= 1,
                    mgr.free_count() + mgr.used_count()
                    + mgr.quarantined_count() == mgr.n_blocks)
        finally:
            st.close()
    got = _same(run)
    assert got[:4] == (True, False, (0, 1), ("err", "UNAVAILABLE"))
    assert got[4] == ("ok", list(enumerate(ref_decode([7], 30))))
    assert got[5:] == (True, True, True)
