"""The port's device-boundary merge (``DeviceMerger``, ``ShardedFanIn``) and
its ``HandoffRing`` against the reference's, on the CPU.

Each case runs both packages on the same numpy inputs from a seed: the
merged dispatch shapes, every caller's rows, and the per-sub-batch failures
must agree. The models are exact in float32 (adds and power-of-two scales),
so replies must be equal. The handoff ring is held step by step against the
reference's on seeded operation sequences, and under concurrent producers.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tpurpc.core.handoff import HandoffRing as JaxRing
from tpurpc.jaxshim import service as jsvc
from tpurpc_torch.core.handoff import HandoffRing
from tpurpc_torch.torchshim import service as tsvc

WAIT = 10.0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mergers():
    """(name, merger factory, array constructor) of both packages."""
    return (("jax", jsvc.DeviceMerger, lambda a: a),
            ("torch", lambda fn: tsvc.DeviceMerger(fn, device="cpu"),
             torch.from_numpy))


def _gathered(make_merger, wrap, compute, subs):
    """Park the merger inside a first ('warm') dispatch, publish ``subs``
    (name → numpy array) in order while it is parked, release it, and
    return the dispatched shapes after the warm one and each sub's
    outcome."""
    gate, first_in = threading.Event(), threading.Event()
    shapes = []

    def fn(tree):
        a = tree["a"]
        shapes.append(tuple(a.shape))
        if len(shapes) == 1:
            first_in.set()
            gate.wait(WAIT)
        return compute(a)

    merger = make_merger(fn)
    out = {}

    def sub(name, a):
        try:
            res = merger.entry()({"a": wrap(a)})
            out[name] = ("ok", {k: _np(v) for k, v in res.items()})
        except Exception as exc:
            out[name] = ("err", str(exc))

    try:
        warm = threading.Thread(
            target=sub, args=("warm", np.zeros((1, 2), np.float32)))
        warm.start()
        assert first_in.wait(WAIT)
        ts = []
        for i, (k, v) in enumerate(subs.items()):
            ts.append(threading.Thread(target=sub, args=(k, v)))
            ts[-1].start()
            deadline = time.monotonic() + WAIT
            while len(merger._ring) < i + 1:   # committed, in this order
                assert time.monotonic() < deadline
                time.sleep(0.002)
        gate.set()
        for t in [warm, *ts]:
            t.join(WAIT)
            assert not t.is_alive()
        return shapes[1:], out, merger.subs_merged
    finally:
        gate.set()
        merger.close()


@pytest.mark.parametrize("rows", [(3, 1), (2, 2, 2), (1, 4, 1, 2)])
def test_device_merger_gathers_concurrent_subbatches(rows):
    rng = np.random.default_rng(sum(rows))
    subs = {f"s{i}": rng.standard_normal((r, 2)).astype(np.float32)
            for i, r in enumerate(rows)}
    res = {name: _gathered(make, wrap, lambda a: {"y": a * 2}, subs)
           for name, make, wrap in _mergers()}
    (jshapes, jout, jmerged), (tshapes, tout, tmerged) = (res["jax"],
                                                          res["torch"])
    # every sub committed before the release: ONE merged dispatch
    assert jshapes == tshapes == [(sum(rows), 2)]
    assert jmerged == tmerged == len(rows)
    for k, a in subs.items():
        assert jout[k][0] == tout[k][0] == "ok"
        np.testing.assert_array_equal(tout[k][1]["y"], jout[k][1]["y"])
        np.testing.assert_array_equal(tout[k][1]["y"], a * 2)


def test_device_merger_misshaped_subbatch_dispatches_alone():
    """Incompatible signatures never co-dispatch: each shape group gets its
    own call, and both succeed."""
    subs = {"wide": np.full((2, 4), 1.0, np.float32),
            "narrow": np.full((2, 2), 1.0, np.float32)}
    res = {name: _gathered(make, wrap, lambda a: {"y": a.sum(axis=1)}, subs)
           for name, make, wrap in _mergers()}
    for shapes, out, _ in res.values():
        assert sorted(shapes) == [(2, 2), (2, 4)], shapes
        assert list(out["wide"][1]["y"]) == [4.0, 4.0]
        assert list(out["narrow"][1]["y"]) == [2.0, 2.0]


@pytest.mark.parametrize("poisoned", [("p",), ("p", "q")])
def test_device_merger_poison_subbatch_fails_alone(poisoned):
    """A merged dispatch that fails is retried per sub-batch: only the
    poisoned subs' callers see the error, in both packages."""
    subs = {"good": np.full((2, 2), 5.0, np.float32),
            "also_good": np.full((1, 2), 7.0, np.float32)}
    for k in poisoned:
        subs[k] = np.full((2, 2), 666.0, np.float32)

    def compute(a):
        if bool((a == 666.0).any()):
            raise ValueError("poison row")
        return {"y": a + 1}

    res = {name: _gathered(make, wrap, compute, subs)
           for name, make, wrap in _mergers()}
    (jshapes, jout, _), (tshapes, tout, _) = res["jax"], res["torch"]
    assert jshapes == tshapes  # merged try, then one dispatch per sub
    for k in subs:
        assert jout[k][0] == tout[k][0] == ("err" if k in poisoned else "ok")
        if k in poisoned:
            assert "poison" in jout[k][1] and "poison" in tout[k][1]
        else:
            np.testing.assert_array_equal(tout[k][1]["y"], subs[k] + 1)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_fanin_end_to_end(n_shards):
    rng = np.random.default_rng(n_shards)
    xs = [rng.standard_normal((1, 3)).astype(np.float32) for _ in range(12)]
    for make, wrap in (
            (lambda fn: jsvc.ShardedFanIn(fn, n_shards=n_shards, max_batch=4,
                                          max_delay_s=0.001), lambda a: a),
            (lambda fn: tsvc.ShardedFanIn(fn, n_shards=n_shards, max_batch=4,
                                          max_delay_s=0.001, device="cpu"),
             torch.from_numpy)):
        fan = make(lambda t: {"y": t["a"] * 4.0})
        outs = [None] * 12
        try:
            def caller(i):
                outs[i] = _np(fan({"a": wrap(xs[i])})["y"])

            ts = [threading.Thread(target=caller, args=(i,))
                  for i in range(12)]
            [t.start() for t in ts]
            [t.join(WAIT) for t in ts]
            assert not any(t.is_alive() for t in ts)
            for i in range(12):
                np.testing.assert_array_equal(outs[i], xs[i] * 4.0)
            assert fan.rows_run == 12 and fan.batches_run >= 1
            assert fan.queue_depth() == 0
        finally:
            fan.close()


def test_sharded_fanin_close_fails_pending_cleanly():
    for make, wrap in (
            (lambda fn: jsvc.ShardedFanIn(fn, n_shards=2, max_batch=2,
                                          max_delay_s=0.001), lambda a: a),
            (lambda fn: tsvc.ShardedFanIn(fn, n_shards=2, max_batch=2,
                                          max_delay_s=0.001, device="cpu"),
             torch.from_numpy)):
        hold = threading.Event()

        def fn(t):
            hold.wait(5)
            return {"y": t["a"]}

        fan = make(fn)
        outs = []

        def caller():
            try:
                outs.append(("ok", fan({"a": wrap(np.zeros((1, 2),
                                                          np.float32))})))
            except Exception as exc:
                outs.append(("err", exc))

        ts = [threading.Thread(target=caller) for _ in range(4)]
        [t.start() for t in ts]
        time.sleep(0.2)
        hold.set()
        fan.close()
        [t.join(15) for t in ts]
        assert not any(t.is_alive() for t in ts)
        assert len(outs) == 4  # nobody stranded on a closed merge boundary


# -- the handoff ring ----------------------------------------------------------

@pytest.mark.parametrize("capacity,seed", [(2, 0), (3, 1), (4, 2), (8, 3)])
def test_handoff_ring_matches_reference_step_by_step(capacity, seed):
    """One thread drives both rings through the same seeded sequence of
    publish (non-blocking when full), take_ready, len and take; every
    return value agrees."""
    rng = np.random.default_rng(seed)
    ours, ref = HandoffRing(capacity), JaxRing(capacity)
    for step in range(400):
        op = rng.integers(0, 4)
        if op == 0:
            got = (ours.publish(step, timeout=0), ref.publish(step, timeout=0))
        elif op == 1:
            got = (ours.take_ready(), ref.take_ready())
        elif op == 2:
            got = (len(ours), len(ref))
        else:
            got = (ours.take(timeout=0), ref.take(timeout=0))
        assert got[0] == got[1], (step, op, got)
    ours.close()
    ref.close()
    assert ours.publish("x") is ref.publish("x") is False


@pytest.mark.parametrize("capacity,producers", [(2, 3), (4, 4), (16, 2)])
def test_handoff_ring_mpmc_order_and_completeness(capacity, producers):
    for cls in (HandoffRing, JaxRing):
        ring = cls(capacity=capacity)
        per = 50
        got = []
        done = threading.Event()

        def producer(pid):
            for k in range(per):
                assert ring.publish((pid, k), timeout=WAIT)

        def consumer():
            while len(got) < producers * per:
                item = ring.take(timeout=WAIT)
                if item is None:
                    break
                got.append(item)
            done.set()

        ts = [threading.Thread(target=producer, args=(p,))
              for p in range(producers)]
        tc = threading.Thread(target=consumer)
        tc.start()
        [t.start() for t in ts]
        [t.join(20) for t in ts]
        assert done.wait(20)
        ring.close()
        assert len(got) == producers * per
        assert len(set(got)) == len(got), "duplicate delivery"
        for p in range(producers):  # per-producer FIFO survives the merge
            assert [k for pid, k in got if pid == p] == list(range(per))


def test_handoff_ring_close_unblocks_producer():
    for cls in (HandoffRing, JaxRing):
        ring = cls(capacity=2)
        assert ring.publish("a") and ring.publish("b")
        result = []
        t = threading.Thread(target=lambda: result.append(ring.publish("c")))
        t.start()
        time.sleep(0.1)
        ring.close()
        t.join(5)
        assert not t.is_alive() and result == [False]


def test_handoff_ring_rejects_tiny_capacity():
    for cls in (HandoffRing, JaxRing):
        with pytest.raises(ValueError):
            cls(capacity=1)
