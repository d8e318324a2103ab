"""The port's decode scheduler, admission gate and streaming Generate
against the reference's.

Each scenario runs on both packages (scheduler, model, server, channel)
with the same prompts and returns what it saw; the two observations must be
equal, and the tokens equal ``reference_decode``. The port's model runs on
the CPU. Batch composition is made deterministic without sleeps: a probe
wraps the model, logs every call, and can park the next decode step until
the test has queued what it needs (the batcher tests' ``_run_ordered``
discipline). Every wait is bounded. Left out with the reference's obs plane:
the watchdog's decode-step stage, ``/healthz`` gen lines and the load
provider."""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tpurpc.jaxshim import codec as ref_codec
from tpurpc.jaxshim import generate as ref_gen
from tpurpc.obs import flight as ref_flight
from tpurpc.rpc import channel as ref_channel
from tpurpc.rpc import status as ref_status
from tpurpc.serving import api as ref_api
from tpurpc.serving import kv as ref_kv
from tpurpc.serving import scheduler as ref_sched
from tpurpc_torch.rpc import channel as port_channel
from tpurpc_torch.rpc import server as port_server
from tpurpc_torch.rpc import status as port_status
from tpurpc_torch.serving import api as port_api
from tpurpc_torch.serving import kv as port_kv
from tpurpc_torch.serving import scheduler as port_sched
from tpurpc_torch.torchshim import codec as port_codec
from tpurpc_torch.torchshim import generate as port_gen

#: the module (``tpurpc.rpc`` exports a ``server()`` function by its name)
ref_server = importlib.import_module("tpurpc.rpc.server")

#: every wait on a stream, thread or condition, seconds
WAIT = 30.0

REF = SimpleNamespace(
    name="ref", sched=ref_sched, kv=ref_kv, api=ref_api, server=ref_server,
    channel=ref_channel.Channel, status=ref_status, codec=ref_codec,
    model=ref_gen.ToyDecodeModel)
PORT = SimpleNamespace(
    name="port", sched=port_sched, kv=port_kv, api=port_api,
    server=port_server, channel=port_channel.Channel, status=port_status,
    codec=port_codec,
    model=lambda **kw: port_gen.ToyDecodeModel(device="cpu", **kw))
BOTH = (REF, PORT)
ref_decode = port_gen.reference_decode


@pytest.fixture(autouse=True)
def _bounded_streams():
    """Bounded streams; afterwards the reference's flight ring emptied, so
    that a later test in this process does not read this test's events."""
    saved = [m.sched.TokenStream.MAX_IDLE_S for m in BOTH]
    for m in BOTH:
        m.sched.TokenStream.MAX_IDLE_S = WAIT
    yield
    for m, old in zip(BOTH, saved):
        m.sched.TokenStream.MAX_IDLE_S = old
    ref_flight.RECORDER.reset()


def _same(run):
    """``run(pkg)`` on both packages; the observations must be equal."""
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


class _Probe:
    """Wraps a model's contract methods: logs ``(method, rows)`` per call
    (``(method, prompts)`` for prefills). Every decode step takes a credit
    and parks while there is none; it starts with none, so the first step
    parks until the test has queued what it needs. :meth:`allow` grants
    steps, :meth:`release` lets every step run."""

    def __init__(self, model):
        self.model = model
        self.log = []
        self._cv = threading.Condition()
        self._credits = 0          # None: steps run freely
        self._steps = 0            # decode steps that reached the gate
        self._parked = 0           # the step (1-based) parked now, or 0
        for name in ("prefill", "step", "prefill_paged", "step_paged"):
            setattr(model, name, self._wrap(name, getattr(model, name)))

    def _wrap(self, name, inner):
        def call(*args):
            with self._cv:
                if name.startswith("prefill"):
                    self.log.append((name, [tuple(int(t) for t in p)
                                            for p in args[0]]))
                else:
                    self.log.append((name, len(args[0])))
                    self._steps += 1
                    if self._credits == 0:
                        self._parked = self._steps
                        self._cv.notify_all()
                        self._wait_locked(lambda: self._credits != 0,
                                          "parked step never released")
                        self._parked = 0
                    if self._credits is not None:
                        self._credits -= 1
            return inner(*args)
        return call

    def _wait_locked(self, pred, what):
        deadline = time.monotonic() + WAIT
        while not pred():
            left = deadline - time.monotonic()
            assert left > 0, what
            self._cv.wait(left)

    def wait_parked(self, nth: int) -> int:
        """Wait until the ``nth`` decode step sits at the gate; returns the
        log's length then."""
        with self._cv:
            self._wait_locked(lambda: self._parked == nth,
                              f"step {nth} never parked")
            return len(self.log)

    def allow(self, n: int) -> None:
        with self._cv:
            self._credits += n
            self._cv.notify_all()

    def release(self) -> None:
        with self._cv:
            self._credits = None
            self._cv.notify_all()

    def last_step_rows(self) -> int:
        with self._cv:
            return [r for name, r in self.log if name.startswith("step")][-1]

    def prefills(self):
        return [p for name, p in self.log if name.startswith("prefill")]


def _sched(m, model=None, **kw):
    kw.setdefault("idle_wait_s", 0.01)
    return m.sched.DecodeScheduler(model or m.model(), **kw)


# -- basic streaming ----------------------------------------------------------

def test_single_sequence_streams_reference_tokens():
    def run(m):
        s = _sched(m)
        try:
            return list(s.submit([1, 2, 3], max_tokens=16))
        finally:
            s.close()
    assert _same(run) == ref_decode([1, 2, 3], 16)


def test_eos_stops_early():
    full = ref_decode([7], 64)
    eos = full[5]

    def run(m):
        s = _sched(m, m.model(eos=eos))
        try:
            return list(s.submit([7], max_tokens=64))
        finally:
            s.close()
    assert _same(run) == full[:full.index(eos) + 1]


@pytest.mark.parametrize("seed", [0, 1])
def test_many_concurrent_sequences_no_crosstalk(seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 251, int(rng.integers(1, 40))).tolist()
               for _ in range(10)]

    def run(m):
        s = _sched(m, max_batch=4)
        try:
            handles = [s.submit(p, max_tokens=24) for p in prompts]
            outs = [list(h) for h in handles]
            _wait(lambda: s.tokens_out >= 240, "the last step's count")
            return outs, s.tokens_out
        finally:
            s.close()
    outs, total = _same(run)
    assert outs == [ref_decode(p, 24) for p in prompts]
    assert total == 240


def test_opaque_states_are_stacked_on_the_models_device():
    """The port's scheduler hands the model one stacked int64 tensor per
    step (``torch.stack`` on its device), never per-row host arrays."""
    import torch

    seen = []
    model = port_gen.ToyDecodeModel(device="cpu")
    inner = model.step

    def step(states, tokens):
        seen.append((type(states), states.dtype, states.device,
                     tuple(states.shape)))
        return inner(states, tokens)
    model.step = step
    s = _sched(PORT, model, max_batch=4)
    try:
        a, b = s.submit([1], max_tokens=4), s.submit([2], max_tokens=4)
        assert (list(a), list(b)) == (ref_decode([1], 4), ref_decode([2], 4))
    finally:
        s.close()
    assert seen and all(t[:3] == (torch.Tensor, torch.int64,
                                  torch.device("cpu")) for t in seen)
    assert {t[3][1] for t in seen} == {3}


# -- continuous batching: joins ------------------------------------------------

def test_join_mid_decode_streams_first_token_before_batch_drains():
    """A request submitted while a long sequence decodes joins at the next
    boundary: its prefill sits between two steps of the long one, the step
    after it carries both rows, and its first token streams long before
    the long sequence ends."""
    def run(m):
        probe = _Probe(m.model())
        s = _sched(m, probe.model, max_batch=4)
        try:
            a = s.submit([1], max_tokens=400)
            probe.allow(9)
            n = probe.wait_parked(10)
            head = [a.next(timeout=WAIT) for _ in range(10)]
            b = s.submit([2], max_tokens=4)
            probe.release()
            first_b = b.next(timeout=WAIT)
            rest = [a.next(timeout=WAIT) for _ in range(10)]
            a_before = a.emitted
            a.cancel()
            tail_b = list(b)
            after = probe.log[n:n + 2]
            return (head + rest, first_b, tail_b, a_before < 400, after,
                    probe.log[n - 1])
        finally:
            probe.release()
            s.close()
    a, first_b, tail_b, early, after, before = _same(run)
    assert a == ref_decode([1], 400)[:20]
    assert [first_b] + tail_b == ref_decode([2], 4) and early
    assert before[0] == "step" and before[1] == 1
    assert after == [("prefill", [(2,)]), ("step", 2)]


def test_join_during_step_lands_next_boundary():
    def run(m):
        probe = _Probe(m.model())
        s = _sched(m, probe.model, max_batch=4)
        try:
            a = s.submit([1], max_tokens=6)
            first = a.next(timeout=WAIT)
            probe.wait_parked(1)
            b = s.submit([2], max_tokens=6)   # joins while a step runs
            probe.release()
            return [first] + list(a), list(b)
        finally:
            probe.release()
            s.close()
    a, b = _same(run)
    assert a == ref_decode([1], 6) and b == ref_decode([2], 6)


# -- leave / idle / poison / drain -------------------------------------------

def test_leave_mid_stream_retires_at_boundary_without_stalling_siblings():
    def run(m):
        s = _sched(m, max_batch=4)
        try:
            a = s.submit([1], max_tokens=5000)
            b = s.submit([2], max_tokens=40)
            head = [a.next(timeout=WAIT) for _ in range(5)]
            a.cancel()
            got_b = list(b)
            list(a)                     # ends (no error) once retired
            _wait(lambda: s.running_depth() == 0, "a retired")
            return head, got_b, s.running_depth()
        finally:
            s.close()
    head, got_b, depth = _same(run)
    assert head == ref_decode([1], 5) and got_b == ref_decode([2], 40)
    assert depth == 0


def test_idle_scheduler_wakes_on_submit():
    """An idle loop parks for ``idle_wait_s`` (30 s here); a submit must
    wake it at once: the whole stream comes back well inside that slice,
    after exactly its own two steps."""
    def run(m):
        s = _sched(m, idle_wait_s=30.0)
        try:
            first = list(s.submit([1], max_tokens=2))
            _wait(lambda: s.steps == 1, "the first stream's step")
            h = s.submit([2], max_tokens=3)
            tok = h.next(timeout=10.0)
            rest = list(h)
            _wait(lambda: s.steps >= 3, "the second stream's steps")
            return first, [tok] + rest, s.steps - 1
        finally:
            s.close()
    first, second, steps = _same(run)
    assert first == ref_decode([1], 2) and second == ref_decode([2], 3)
    assert steps == 2


@pytest.mark.parametrize("where", [0, 1, 2])
def test_poisoned_sequence_fails_alone(where):
    prompts = [[3], [4], [5]]
    prompts[where] = [7, 666]

    def run(m):
        s = _sched(m, m.model(poison_token=666), max_batch=4)
        try:
            hs = [s.submit(p, max_tokens=20) for p in prompts]
            out = []
            for h in hs:
                try:
                    out.append(list(h))
                except ValueError as exc:
                    out.append(str(exc))
            return out
        finally:
            s.close()
    out = _same(run)
    for i, (p, got) in enumerate(zip(prompts, out)):
        if i == where:
            assert "poison" in got
        else:
            assert got == ref_decode(p, 20)


def test_drain_finishes_inflight_and_refuses_new():
    def run(m):
        s = _sched(m, max_batch=4)
        try:
            a = s.submit([1], max_tokens=60)
            head = [a.next(timeout=WAIT) for _ in range(3)]
            s.drain()
            try:
                s.submit([2], max_tokens=5)
                refused = "no raise"
            except m.sched.DrainingError:
                refused = "DrainingError"
            return head + list(a), refused, s.state_str()
        finally:
            s.close()
    toks, refused, state = _same(run)
    assert toks == ref_decode([1], 60)
    assert (refused, state) == ("DrainingError", "draining")


def test_drain_refuses_already_queued_prefills():
    def run(m):
        probe = _Probe(m.model())
        s = _sched(m, probe.model, max_batch=1)
        try:
            a = s.submit([1], max_tokens=50)
            a.next(timeout=WAIT)
            probe.wait_parked(1)
            b = s.submit([2], max_tokens=5)    # parked waiting
            s.drain()
            probe.release()
            try:
                list(b)
                out = "no raise"
            except m.sched.DrainingError:
                out = "DrainingError"
            a.cancel()
            list(a)
            return out, probe.prefills()
        finally:
            probe.release()
            s.close()
    assert _same(run) == ("DrainingError", [[(1,)]])


# -- SLO classes: priority, preemption, shedding ------------------------------

def test_interactive_admitted_before_earlier_batch_submit():
    def run(m):
        probe = _Probe(m.model())
        s = _sched(m, probe.model, max_batch=1)
        try:
            a = s.submit([1], max_tokens=2)
            probe.wait_parked(1)
            b_batch = s.submit([2], max_tokens=2, slo="batch")
            c_inter = s.submit([3], max_tokens=2, slo="interactive")
            probe.release()
            return list(a), list(b_batch), list(c_inter), probe.prefills()
        finally:
            probe.release()
            s.close()
    a, b, c, order = _same(run)
    assert (a, b, c) == (ref_decode([1], 2), ref_decode([2], 2),
                         ref_decode([3], 2))
    assert order == [[(1,)], [(3,)], [(2,)]]


def test_preemption_makes_room_and_preempted_resumes_exact():
    def run(m):
        probe = _Probe(m.model())
        s = _sched(m, probe.model, max_batch=2)
        try:
            b1 = s.submit([1], max_tokens=300, slo="batch")
            b2 = s.submit([2], max_tokens=300, slo="batch")
            nth = 1
            probe.wait_parked(nth)
            while probe.last_step_rows() < 2:   # until both rows run
                probe.allow(1)
                nth += 1
                probe.wait_parked(nth)
            inter = s.submit([3], max_tokens=6, slo="interactive")
            probe.release()
            got = list(inter)
            pre = s.preempted_total
            r1, r2 = list(b1), list(b2)
            return got, pre, r1, r2
        finally:
            probe.release()
            s.close()
    got, pre, r1, r2 = _same(run)
    assert got == ref_decode([3], 6) and pre == 1
    assert r1 == ref_decode([1], 300) and r2 == ref_decode([2], 300)


def test_preempted_stream_values_survive_resume():
    def run(m):
        probe = _Probe(m.model())
        s = _sched(m, probe.model, max_batch=1)
        try:
            long = s.submit([9], max_tokens=50, slo="batch")
            probe.allow(4)
            probe.wait_parked(5)
            quick = s.submit([4], max_tokens=4, slo="interactive")
            probe.release()
            return list(quick), list(long), s.preempted_total
        finally:
            probe.release()
            s.close()
    quick, long, pre = _same(run)
    assert quick == ref_decode([4], 4) and long == ref_decode([9], 50)
    assert pre == 1


def test_shed_batch_first_interactive_still_admitted():
    def run(m):
        probe = _Probe(m.model())
        s = _sched(m, probe.model, max_batch=1, max_waiting=6,
                   batch_shed_depth=2)
        try:
            running = s.submit([1], max_tokens=50)
            probe.wait_parked(1)
            waiting = [s.submit([2], max_tokens=2),
                       s.submit([3], max_tokens=2)]
            obs = []
            try:
                s.submit([4], max_tokens=2, slo="batch")
                obs.append("no shed")
            except m.sched.ShedError as exc:
                obs.append((exc.slo, exc.pushback_ms, str(exc)))
            waiting.append(s.submit([5], max_tokens=2, slo="interactive"))
            obs += [s.shed_total, s.state_str()]
            for i in range(6, 20):
                try:
                    waiting.append(s.submit([i], max_tokens=2))
                except m.sched.ShedError as exc:
                    obs.append((i, exc.slo, exc.pushback_ms, str(exc)))
                    break
            running.cancel()
            probe.release()
            obs.append([list(w) for w in waiting])
            return obs
        finally:
            probe.release()
            s.close()
    obs = _same(run)
    assert obs[0] == ("batch", 25, "batch-class queue bar (2/2 waiting)")
    assert obs[1:3] == [1, "shedding"]
    assert obs[3] == (9, "interactive", 25, "queue full (6/6 waiting)")
    assert obs[4] == [ref_decode(p, 2) for p in ([2], [3], [5], [6], [7],
                                                 [8])]


def test_step_time_slo_sheds_batch_class():
    def run(m):
        s = _sched(m, m.model(step_delay_s=0.02), max_batch=1,
                   max_waiting=64, batch_shed_depth=64, step_slo_ms=1.0)
        try:
            a = s.submit([1], max_tokens=100000)
            _wait(lambda: s.steps >= 3, "three slow steps")
            w = s.submit([2], max_tokens=2)       # one waiter
            try:
                s.submit([3], max_tokens=2, slo="batch")
                out = "no shed"
            except m.sched.ShedError as exc:
                out = (str(exc).startswith("step time over SLO"),
                       exc.pushback_ms)
            a.cancel()
            return out, list(w)
        finally:
            s.close()
    assert _same(run) == ((True, 50), ref_decode([2], 2))


def test_prefill_budget_staggers_joins_but_all_complete():
    def run(m):
        probe = _Probe(m.model())
        probe.release()
        s = _sched(m, probe.model, max_batch=8, prefill_budget=8)
        try:
            handles = [s.submit([i] * 6, max_tokens=10) for i in range(4)]
            outs = [list(h) for h in handles]
            return outs, [len(p) for p in probe.prefills()]
        finally:
            s.close()
    outs, rows = _same(run)
    assert outs == [ref_decode([i] * 6, 10) for i in range(4)]
    assert rows == [1, 1, 1, 1]


def test_oversized_prompt_still_admitted_alone():
    def run(m):
        s = _sched(m, prefill_budget=4)
        try:
            return list(s.submit([1] * 64, max_tokens=5))
        finally:
            s.close()
    assert _same(run) == ref_decode([1] * 64, 5)


def test_step_p99_and_load_signals():
    def run(m):
        s = _sched(m, max_batch=2)
        try:
            obs = [s.step_p99_ms(), s.load_depth(), s.swapped_depth()]
            list(s.submit([1], max_tokens=12))
            p99 = s.step_p99_ms()
            obs += [p99 is not None and p99 >= 0, s.queue_depth(),
                    s.state_str()]
            return obs
        finally:
            s.close()
    assert _same(run) == [None, 0, 0, True, 0, "ok"]


def test_load_depth_counts_preempted_swapped_rows():
    def run(m):
        mgr = m.kv.KvBlockManager(n_blocks=64, block_bytes=256,
                                  kind="local", name="loadsig")
        probe = _Probe(m.model())
        s = _sched(m, probe.model, kv=mgr, max_batch=1)
        try:
            long = s.submit([9], max_tokens=4000, slo="batch")
            probe.wait_parked(1)
            quick = s.submit([4], max_tokens=50, slo="interactive")
            probe.allow(1)     # the boundary after it preempts the batch row
            probe.wait_parked(2)          # the interactive row's first step
            obs = (s.swapped_depth(), s.load_depth(), s.queue_depth(),
                   s.preempted_total)
            quick.cancel()
            long.cancel()
            probe.release()
            return obs
        finally:
            probe.release()
            s.close()
            mgr.close()
    assert _same(run) == (1, 1, 0, 1)


def test_unknown_slo_and_closed_scheduler_refuse():
    def run(m):
        s = _sched(m)
        obs = []
        try:
            s.submit([1], slo="bulk")
        except ValueError as exc:
            obs.append("unknown slo" in str(exc))
        s.close()
        try:
            s.submit([1])
        except RuntimeError as exc:
            obs.append(str(exc))
        return obs
    assert _same(run) == [True, "scheduler closed"]


# -- AdmissionGate --------------------------------------------------------------

def test_admission_gate_latency_fn_overrides_latency_signal():
    def run(m):
        sig = [0.5]
        gate = m.server.AdmissionGate(8, soft_limit=2, latency_slo_ms=10.0,
                                      latency_ms_fn=lambda: sig[0])
        obs = [gate.try_admit() for _ in range(3)]
        sig[0] = 50.0
        obs.append(gate.try_admit())
        sig[0] = 0.5
        obs.append(gate.try_admit())
        return obs, gate.inflight(), gate.rejected
    assert _same(run) == ([None, None, None, 50, None], 4, 1)


def test_admission_gate_latency_fn_failure_never_blocks():
    def broken():
        raise RuntimeError("probe died")

    def run(m):
        gate = m.server.AdmissionGate(4, soft_limit=1, latency_slo_ms=1.0,
                                      latency_ms_fn=broken)
        return [gate.try_admit() for _ in range(2)]
    assert _same(run) == [None, None]


@pytest.mark.parametrize("limits", [(4, 2), (8, 8), (10, 3)])
def test_admission_gate_pushback_and_release_match_reference(limits):
    hard, soft = limits

    def run(m):
        gate = m.server.AdmissionGate(hard, soft_limit=soft,
                                      base_pushback_ms=30,
                                      max_pushback_ms=200)
        obs = [gate.try_admit() for _ in range(hard + 6)]
        for _ in range(3):
            gate.release()
        obs += [gate.inflight(), gate.try_admit(), gate.rejected]
        return obs
    _same(run)


def test_admission_gate_rejects_bad_limits():
    for m in BOTH:
        with pytest.raises(ValueError):
            m.server.AdmissionGate(0)
        with pytest.raises(ValueError):
            m.server.AdmissionGate(4, soft_limit=5)


# -- the transport face -------------------------------------------------------

def test_wire_trees_are_byte_equal():
    req = {"prompt": np.arange(7, dtype=np.int32),
           "max_tokens": np.int32(12), "slo": np.int32(1)}
    resp = {"token": np.int32(200), "index": np.int32(3)}
    for tree in (req, resp):
        assert port_codec.encode_tree_bytes(tree) == \
            ref_codec.encode_tree_bytes(tree)
    assert port_api.GEN_SERVICE == ref_api.GEN_SERVICE
    assert port_server.PUSHBACK_KEY == ref_server.PUSHBACK_KEY


def _serve(m, model, **kw):
    return m.api.serve_generation(model, **kw)


def test_rpc_stream_tokens_in_order_and_exact():
    def run(m):
        srv, port, sched = _serve(m, m.model(), max_batch=4)
        try:
            with m.channel(f"127.0.0.1:{port}") as ch:
                gen = m.api.GenerationClient(ch)
                return list(gen.generate_with_meta([1, 2], max_tokens=12,
                                                   timeout=WAIT))
        finally:
            srv.stop(grace=0)
            sched.close()
    pairs = _same(run)
    assert [i for i, _ in pairs] == list(range(12))
    assert [t for _, t in pairs] == ref_decode([1, 2], 12)


def test_rpc_concurrent_streams_interleave_without_crosstalk():
    def run(m):
        srv, port, sched = _serve(m, m.model(step_delay_s=0.001),
                                  max_batch=4)
        try:
            with m.channel(f"127.0.0.1:{port}") as ch:
                gen = m.api.GenerationClient(ch)
                out = {}

                def go(i):
                    out[i] = list(gen.generate([i], max_tokens=16,
                                               timeout=WAIT))

                threads = [threading.Thread(target=go, args=(i,))
                           for i in range(6)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(WAIT)
                return [out.get(i) for i in range(6)], sched.steps < 96
        finally:
            srv.stop(grace=0)
            sched.close()
    outs, merged = _same(run)
    assert outs == [ref_decode([i], 16) for i in range(6)] and merged


def test_rpc_client_cancel_is_a_leave():
    def run(m):
        srv, port, sched = _serve(m, m.model(step_delay_s=0.002),
                                  max_batch=4)
        try:
            with m.channel(f"127.0.0.1:{port}") as ch:
                call = m.api.GenerationClient(ch).call(
                    [1], max_tokens=10000, timeout=WAIT * 2)
                it = iter(call)
                first = next(it)
                call.cancel()
            _wait(lambda: sched.running_depth() == 0, "the leave")
            return int(np.asarray(first["token"]).ravel()[0]), \
                sched.running_depth()
        finally:
            srv.stop(grace=0)
            sched.close()
    assert _same(run) == (ref_decode([1], 1)[0], 0)


def test_rpc_shed_maps_to_unavailable_with_pushback():
    def run(m):
        probe = _Probe(m.model())
        srv, port, sched = _serve(m, probe.model, max_batch=1,
                                  max_waiting=4, batch_shed_depth=1)
        try:
            with m.channel(f"127.0.0.1:{port}") as ch:
                gen = m.api.GenerationClient(ch)
                first = gen.call([0], max_tokens=5, timeout=WAIT)
                it0 = iter(first)
                next(it0)
                probe.wait_parked(1)
                calls = [gen.call([i], max_tokens=5, timeout=WAIT)
                         for i in (1, 2)]
                _wait(lambda: sched.queue_depth() == 2, "two waiters")
                try:
                    list(gen.generate([9], max_tokens=5, slo="batch",
                                      timeout=WAIT))
                    out = "no error"
                except m.status.RpcError as exc:
                    md = dict(exc.trailing_metadata() or ())
                    out = (exc.code().name, int(md[m.server.PUSHBACK_KEY]))
                probe.release()
                for c in [first] + calls:
                    c.cancel()
                return out
        finally:
            probe.release()
            srv.stop(grace=0)
            sched.close()
    assert _same(run) == ("UNAVAILABLE", 50)


def test_rpc_poisoned_stream_fails_alone():
    def run(m):
        srv, port, sched = _serve(m, m.model(poison_token=666), max_batch=4)
        try:
            with m.channel(f"127.0.0.1:{port}") as ch:
                gen = m.api.GenerationClient(ch)
                good = {}
                t = threading.Thread(target=lambda: good.update(v=list(
                    gen.generate([5], max_tokens=12, timeout=WAIT))))
                t.start()
                try:
                    list(gen.generate([666], max_tokens=12, timeout=WAIT))
                    bad = "no error"
                except m.status.RpcError as exc:
                    bad = (exc.code().name, "poison" in exc.details())
                t.join(WAIT)
                return bad, good.get("v")
        finally:
            srv.stop(grace=0)
            sched.close()
    bad, good = _same(run)
    assert bad == ("INTERNAL", True) and good == ref_decode([5], 12)


def test_rpc_drain_finishes_streams_refuses_new():
    def run(m):
        srv, port, sched = _serve(m, m.model(step_delay_s=0.005),
                                  max_batch=4)
        try:
            with m.channel(f"127.0.0.1:{port}") as ch:
                call = m.api.GenerationClient(ch).call([1], max_tokens=60,
                                                       timeout=WAIT * 2)
                it = iter(call)
                toks = [next(it)]
                drained = []
                t = threading.Thread(
                    target=lambda: drained.append(srv.drain(linger=WAIT)))
                t.start()
                _wait(lambda: srv.draining, "the drain")
                try:
                    with m.channel(f"127.0.0.1:{port}") as ch2:
                        list(m.api.GenerationClient(ch2).generate(
                            [2], max_tokens=3, timeout=WAIT))
                    new = "no error"
                except m.status.RpcError as exc:
                    new = exc.code().name
                toks += list(it)
                t.join(WAIT)
                return ([int(np.asarray(x["token"]).ravel()[0])
                         for x in toks], new, drained)
        finally:
            srv.stop(grace=0)
            sched.close()
    toks, new, drained = _same(run)
    assert toks == ref_decode([1], 60)
    assert (new, drained) == ("UNAVAILABLE", [True])


def test_server_drain_hooks_run_once():
    def run(m):
        srv = m.server.Server(max_workers=2)
        calls = []
        srv.add_drain_hook(lambda: calls.append("a"))
        srv.add_drain_hook(lambda: 1 / 0)     # a failing hook is swallowed
        srv.add_drain_hook(lambda: calls.append("b"))
        srv.start()
        srv.add_insecure_port("127.0.0.1:0")
        try:
            obs = [srv.draining, srv.drain(linger=1.0), srv.draining,
                   srv.drain(linger=1.0), list(calls)]
        finally:
            srv.stop(grace=0)
        obs.append(srv.draining)
        return obs
    assert _same(run) == [False, True, True, True, ["a", "b"], False]
