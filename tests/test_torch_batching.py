"""Fan-in batching of the port (``FanInBatcher``, ``serve_torch(batching=
True)``) against the reference's (``tpurpc.jaxshim.service``), on the CPU.

Every case feeds the same numpy inputs, made from a seed, to both packages'
batchers and compares what comes back: the replies, ``rows_run``, the
dispatched batch shapes, and which requests fail. The port runs with
``device="cpu"``; the reference on JAX's CPU backend. Tolerances: the models
here are exact in float32 (scaling by a power of two, identity, adds), so
replies must be equal; ``tanh`` differs between XLA and PyTorch by at most a
few float32 ulps, hence 1e-6.

Batch composition is made deterministic where a case depends on it: a first
request holds the batcher thread inside the model on a gate while the
others queue, one after another, in a known order.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurpc.jaxshim import service as jsvc
from tpurpc.rpc.channel import Channel as JaxChannel
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.torchshim import service as tsvc
from tpurpc_torch.utils import config as torch_config

TANH_TOL = 1e-6
WAIT = 10.0


def _wait_until(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)) if np.ndim(tree) else tree


def _jax_batcher(fn, **kw):
    return jsvc.FanInBatcher(fn, **kw)


def _torch_batcher(fn, **kw):
    return tsvc.FanInBatcher(fn, device="cpu", **kw)


class _Gated:
    """A model whose first call parks on a gate (so requests queue behind
    it) and which records every dispatched batch's leading size."""

    def __init__(self, compute):
        self.compute = compute
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.shapes = []

    def __call__(self, tree):
        if not self.entered.is_set():
            self.entered.set()
            self.gate.wait(WAIT)
        self.shapes.append(int(tree["x"].shape[0]))
        return self.compute(tree)


def _run_ordered(batcher, model: _Gated, trees, warm):
    """Queue ``trees`` in order behind a gated warm-up dispatch, release
    the gate, and return ``(outcomes, shapes after the warm-up)``: each
    outcome is ``("ok", numpy tree)`` or ``("err", message)``."""
    outcomes = [None] * len(trees)

    def call(i, tree):
        try:
            outcomes[i] = ("ok", _tree_np(batcher(tree)))
        except Exception as exc:
            outcomes[i] = ("err", str(exc))

    warm_t = threading.Thread(target=lambda: batcher(warm), daemon=True)
    warm_t.start()
    assert model.entered.wait(WAIT)
    threads = []
    for i, tree in enumerate(trees):
        t = threading.Thread(target=call, args=(i, tree), daemon=True)
        t.start()
        threads.append(t)
        _wait_until(lambda: len(batcher._queue) == i + 1, f"request {i}")
    model.gate.set()
    for t in [warm_t, *threads]:
        t.join(WAIT)
        assert not t.is_alive(), "caller stranded"
    return outcomes, model.shapes[1:]


# -- stacking and results ------------------------------------------------------

@pytest.mark.parametrize("n,max_batch", [(6, 8), (12, 4)])
def test_batcher_stacks_concurrent_requests(n, max_batch):
    rng = np.random.default_rng(n)
    xs = [rng.standard_normal((1, 4)).astype(np.float32) for _ in range(n)]
    got = {}
    for name, make, fn in (
            ("jax", _jax_batcher, lambda x: x @ jnp.eye(4, dtype=x.dtype) * 2.0),
            ("torch", _torch_batcher, lambda x: x @ torch.eye(4) * 2.0)):
        b = make(fn, max_batch=max_batch, max_delay_s=0.05)
        outs = [None] * n
        try:
            def worker(i):
                outs[i] = _np(b(xs[i] if name == "jax"
                                else torch.from_numpy(xs[i])))
            ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
            [t.start() for t in ts]
            [t.join(WAIT) for t in ts]
            assert not any(t.is_alive() for t in ts)
            got[name] = (outs, b.rows_run, b.batches_run)
        finally:
            b.close()
    for name, (outs, rows, batches) in got.items():
        for x, y in zip(xs, outs):
            np.testing.assert_array_equal(y, x * 2.0)
        assert rows == n
        assert batches < n, (name, batches)


def test_batcher_counts_host_time_of_every_stage():
    xs = np.random.default_rng(3).standard_normal((4, 1, 4)).astype(np.float32)
    b = _torch_batcher(lambda x: x * 2.0, max_batch=4, max_delay_s=0.05)
    try:
        outs = [None] * len(xs)
        ts = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, _np(b(torch.from_numpy(xs[i]))))) for i in range(len(xs))]
        [t.start() for t in ts]
        [t.join(WAIT) for t in ts]
        assert not any(t.is_alive() for t in ts)
    finally:
        b.close()
    np.testing.assert_array_equal(np.stack(outs), xs * 2.0)
    assert set(b.stage_s) == {"stack", "model", "d2h", "split"}
    assert all(v > 0 for v in b.stage_s.values()), b.stage_s


def test_batcher_propagates_errors():
    def bad(x):
        raise ValueError("boom")

    for make in (_jax_batcher, _torch_batcher):
        b = make(bad, max_batch=2, max_delay_s=0.01)
        try:
            x = np.zeros((1, 2), np.float32)
            with pytest.raises(ValueError, match="boom"):
                b(x if make is _jax_batcher else torch.from_numpy(x))
        finally:
            b.close()


@pytest.mark.parametrize("rows", [(1, 2, 3), (2, 2), (1, 1, 1, 1, 1)])
def test_multi_leaf_multi_row_requests_split_back(rows):
    """Requests of several rows and two leaves stack in order and each
    gets exactly its own rows back."""
    rng = np.random.default_rng(sum(rows))
    trees = [{"x": rng.standard_normal((r, 3)).astype(np.float32),
              "n": rng.integers(0, 100, (r,)).astype(np.int32)}
             for r in rows]
    warm = {"x": np.zeros((1, 3), np.float32), "n": np.zeros((1,), np.int32)}
    res = {}
    for name, make, compute in (
            ("jax", _jax_batcher,
             lambda t: {"y": t["x"] * 2.0, "m": t["n"] + 1}),
            ("torch", _torch_batcher,
             lambda t: {"y": t["x"] * 2.0, "m": t["n"] + 1})):
        model = _Gated(compute)
        b = make(model, max_batch=16, max_delay_s=0.02)
        try:
            conv = (lambda t: t) if name == "jax" else _to_torch
            out, shapes = _run_ordered(b, model, [conv(t) for t in trees],
                                       conv(warm))
            res[name] = (out, shapes, b.rows_run)
        finally:
            b.close()
    assert res["jax"][1] == res["torch"][1]          # dispatched shapes
    assert res["jax"][2] == res["torch"][2] == sum(rows) + 1
    for t, (jk, jv), (tk, tv) in zip(trees, res["jax"][0], res["torch"][0]):
        assert jk == tk == "ok"
        np.testing.assert_array_equal(tv["y"], jv["y"])
        np.testing.assert_array_equal(tv["m"], jv["m"])
        np.testing.assert_array_equal(tv["y"], t["x"] * 2.0)


def test_transfer_dtype_casts_float_rows_before_dispatch():
    """transfer_dtype=bfloat16: the model sees bf16 rows (float leaves
    only); values round the same way in both packages."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16)).astype(np.float32)
    n = np.arange(3, dtype=np.int32)[None]
    seen = {}

    def jfn(t):
        seen["jax"] = (str(t["x"].dtype), str(t["n"].dtype))
        return {"y": t["x"].astype(jnp.float32), "n": t["n"]}

    def tfn(t):
        seen["torch"] = (str(t["x"].dtype), str(t["n"].dtype))
        return {"y": t["x"].float(), "n": t["n"]}

    jb = _jax_batcher(jfn, max_batch=4, max_delay_s=0.001,
                      transfer_dtype=jnp.bfloat16)
    tb = _torch_batcher(tfn, max_batch=4, max_delay_s=0.001,
                        transfer_dtype=torch.bfloat16)
    try:
        want = jb({"x": x, "n": n})
        got = tb({"x": torch.from_numpy(x), "n": torch.from_numpy(n)})
    finally:
        jb.close()
        tb.close()
    assert seen == {"jax": ("bfloat16", "int32"),
                    "torch": ("torch.bfloat16", "torch.int32")}
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
    np.testing.assert_array_equal(got["n"].numpy(), n)


# -- buckets -------------------------------------------------------------------

@pytest.mark.parametrize("fixed,pad", [(False, True), (True, True),
                                       (False, False)])
def test_bucket_rule_matches(fixed, pad):
    jb = _jax_batcher(lambda t: t, max_batch=8, fixed_bucket=fixed,
                      pad_to_bucket=pad)
    tb = _torch_batcher(lambda t: t, max_batch=8, fixed_bucket=fixed,
                        pad_to_bucket=pad)
    try:
        for n in range(1, 12):
            assert tb._bucket(n) == jb._bucket(n), n
    finally:
        jb.close()
        tb.close()


@pytest.mark.parametrize("rows", [1, 2, 3, 5, 8, 11])
@pytest.mark.parametrize("fixed", [False, True])
def test_dispatched_shape_matches(rows, fixed):
    """One request of ``rows`` rows: the same padded dispatch in both
    packages (fixed_bucket: max_batch, or the larger total); the reply is
    sliced back to the request's rows and the pad rows are zero."""
    x = np.random.default_rng(rows).standard_normal((rows, 2)).astype(np.float32)
    got = {}
    for name, make in (("jax", _jax_batcher), ("torch", _torch_batcher)):
        seen = []

        def fn(tree):
            seen.append(_np(tree["x"]).copy())
            return tree

        b = make(fn, max_batch=8, max_delay_s=0.001, fixed_bucket=fixed)
        try:
            out = b({"x": x if name == "jax" else torch.from_numpy(x)})
        finally:
            b.close()
        got[name] = (seen[0], _np(out["x"]))
    (jin, jout), (tin, tout) = got["jax"], got["torch"]
    assert tin.shape == jin.shape
    assert tin.shape[0] == (max(8, rows) if fixed
                            else max(min(1 << (rows - 1).bit_length(), 8), rows))
    np.testing.assert_array_equal(tin, jin)
    np.testing.assert_array_equal(tin[rows:], 0)
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tout, x)


# -- poison isolation ----------------------------------------------------------

POISONS = {
    "trailing_shape": {"x": np.ones((1, 7), np.float32)},
    "dtype": {"x": np.ones((1, 4), np.int32)},
    "tree_structure": {"z": np.ones((1, 4), np.float32)},
    "zero_dim": {"x": np.float32(1.0)},
    "empty_tree": {},
}


@pytest.mark.parametrize("poison", sorted(POISONS))
def test_bad_request_does_not_poison_siblings(poison):
    """One incompatible request in a batch fails ALONE, in both packages,
    with the same kind of error; its siblings' replies are equal."""
    rng = np.random.default_rng(7)
    trees = [{"x": rng.standard_normal((1, 4)).astype(np.float32)}
             for _ in range(5)]
    trees[2] = POISONS[poison]
    res = {}
    for name, make in (("jax", _jax_batcher), ("torch", _torch_batcher)):
        model = _Gated(lambda t: {"y": t["x"] * 2.0})
        b = make(model, max_batch=8, max_delay_s=0.02)
        try:
            conv = (lambda t: t) if name == "jax" else _to_torch
            res[name] = _run_ordered(
                b, model, [conv(t) for t in trees],
                conv({"x": np.zeros((1, 4), np.float32)}))
        finally:
            b.close()
    (jout, jshapes), (tout, tshapes) = res["jax"], res["torch"]
    assert jshapes == tshapes == [4]   # the four siblings, stacked
    for i, ((jk, jv), (tk, tv)) in enumerate(zip(jout, tout)):
        assert jk == tk, (i, jv, tv)
        if i == 2:
            assert jk == "err"
            for key in ("incompatible", "leading batch axis", "empty"):
                assert (key in jv) == (key in tv), (jv, tv)
        else:
            np.testing.assert_array_equal(tv["y"], jv["y"])
            np.testing.assert_array_equal(tv["y"], trees[i]["x"] * 2.0)


# -- flush policy --------------------------------------------------------------

def test_max_delay_flush_fires_under_single_slow_producer():
    """A lone producer (the batch never fills) is served by the timer."""
    for make in (_jax_batcher, _torch_batcher):
        b = make(lambda t: t, max_batch=64, max_delay_s=0.05)
        try:
            x = np.ones((1, 2), np.float32)
            out = b({"x": x if make is _jax_batcher else torch.from_numpy(x)})
            assert tuple(out["x"].shape) == (1, 2)
            assert b.batches_run == 1 and b.rows_run == 1
        finally:
            b.close()


def test_depth_aware_flush_beats_max_delay():
    """inflight_fn reports every in-flight request queued: the batch goes
    at once instead of after a 30 s max_delay_s."""
    for make in (_jax_batcher, _torch_batcher):
        b = make(lambda t: t, max_batch=64, max_delay_s=30.0,
                 inflight_fn=lambda: 1)
        try:
            t0 = time.monotonic()
            x = np.ones((1, 2), np.float32)
            b({"x": x if make is _jax_batcher else torch.from_numpy(x)})
            assert time.monotonic() - t0 < WAIT
        finally:
            b.close()


@pytest.mark.parametrize("queued,pending,recent", [
    (1, 1, []), (1, 2, []), (3, 3, [8]), (8, 3, [8]), (4, 4, [2, 4, 1]),
    (2, 0, [1]), (5, 5, [9]), (0, 0, [])])
def test_depth_aware_hysteresis_matches(queued, pending, recent):
    """_drained_inflight over one state, both packages: flush when the
    queue holds every in-flight request AND the recent max batch."""
    outs = []
    for make in (_jax_batcher, _torch_batcher):
        b = make(lambda t: t, max_batch=8, inflight_fn=lambda: pending)
        b.close()
        b._queue = [object()] * queued
        b._recent_batches.extend(recent)
        outs.append(b._drained_inflight())
    assert outs[0] == outs[1]


def test_broken_inflight_probe_degrades_to_timer():
    def probe():
        raise RuntimeError("probe down")

    for make in (_jax_batcher, _torch_batcher):
        b = make(lambda t: t, max_batch=8, max_delay_s=0.01,
                 inflight_fn=probe)
        try:
            x = np.ones((1, 2), np.float32)
            b({"x": x if make is _jax_batcher else torch.from_numpy(x)})
            assert b.batches_run == 1
        finally:
            b.close()


# -- shutdown ------------------------------------------------------------------

def test_close_with_pending_requests_resolves_every_caller():
    """close() racing queued requests resolves every caller: a result if
    its batch dispatched, 'batcher closed' otherwise — never stranded."""
    for make in (_jax_batcher, _torch_batcher):
        gate = threading.Event()

        def fn(tree):
            gate.wait(5)
            return tree

        b = make(fn, max_batch=4, max_delay_s=0.01)
        outcomes = []

        def caller(i):
            x = np.full((1, 2), float(i), np.float32)
            try:
                outcomes.append(("ok", b({"x": x if make is _jax_batcher
                                          else torch.from_numpy(x)})))
            except RuntimeError as exc:
                outcomes.append(("err", str(exc)))

        ts = [threading.Thread(target=caller, args=(i,), daemon=True)
              for i in range(6)]
        [t.start() for t in ts]
        _wait_until(lambda: len(b._queue) >= 1, "requests queued")
        gate.set()
        b.close()
        [t.join(WAIT) for t in ts]
        assert not any(t.is_alive() for t in ts), "caller stranded by close()"
        assert len(outcomes) == 6
        for kind, val in outcomes:
            assert kind == "ok" or "closed" in val


def test_call_after_close_raises():
    for make in (_jax_batcher, _torch_batcher):
        b = make(lambda t: t, max_batch=2)
        b.close()
        with pytest.raises(RuntimeError, match="closed"):
            b({"x": np.ones((1, 1), np.float32)})


# -- over real sockets ---------------------------------------------------------

@pytest.fixture
def torch_on_cpu(monkeypatch):
    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    torch_config.set_config(None)
    yield
    torch_config.set_config(None)


def _fanin(serve, channel, client_cls, xs, depth, wrap):
    """8 clients, one connection each, ``len(xs[i])`` requests from client
    i at pipeline ``depth`` (1: lockstep ``call``). Returns the replies and
    the batcher's ``rows_run``/``batches_run``."""
    srv, port, batcher = serve
    target = f"127.0.0.1:{port}"
    results = [[None] * len(x) for x in xs]
    errors = []

    def client(i):
        try:
            with channel(target) as ch:
                cli = client_cls(ch, depth=depth)
                if depth == 1:
                    for k, x in enumerate(xs[i]):
                        results[i][k] = cli.call("Call", {"x": wrap(x)},
                                                 timeout=30)
                    return
                futs = [cli.call_async("Call", {"x": wrap(x)}, timeout=30)
                        for x in xs[i]]
                for k, f in enumerate(futs):
                    results[i][k] = f.result(timeout=30)
        except Exception as exc:
            errors.append(exc)

    try:
        ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        [t.start() for t in ts]
        [t.join(60) for t in ts]
        assert not any(t.is_alive() for t in ts)
        assert not errors, errors
        return results, batcher.rows_run, batcher.batches_run
    finally:
        srv.stop(grace=0)
        batcher.close()


@pytest.mark.parametrize("depth,shards", [(1, 1), (4, 1), (4, 2)])
def test_eight_client_fanin_end_to_end(torch_on_cpu, depth, shards):
    """8 clients fan into one server with batched dispatch, in both
    packages (serve_jax / serve_torch with batching=True): the replies
    agree, every row ran once, and batches stacked rows across
    connections (batches_run < requests)."""
    per = 1 if depth == 1 else 4
    rng = np.random.default_rng(depth * 10 + shards)
    xs = [[rng.standard_normal((2, 3)).astype(np.float32) for _ in range(per)]
          for _ in range(8)]
    kw = dict(batching=True, max_batch=8, max_delay_s=0.02,
              batch_shards=shards)
    want = _fanin(jsvc.serve_jax(lambda t: {"y": jnp.tanh(t["x"]) + 1.0},
                                 "127.0.0.1:0", **kw),
                  JaxChannel, jsvc.TensorClient, xs, depth, lambda x: x)
    got = _fanin(tsvc.serve_torch(lambda t: {"y": torch.tanh(t["x"]) + 1.0},
                                  "127.0.0.1:0", **kw),
                 Channel, tsvc.TensorClient, xs, depth, torch.from_numpy)
    n = 8 * per
    for res, rows, batches in (want, got):
        assert rows == 2 * n
        if depth > 1:
            assert batches < n, batches
    for i in range(8):
        for k in range(per):
            y = got[0][i][k]["y"].numpy()
            np.testing.assert_allclose(y, np.asarray(want[0][i][k]["y"]),
                                       rtol=TANH_TOL, atol=TANH_TOL)
            np.testing.assert_allclose(y, np.tanh(xs[i][k]) + 1.0,
                                       rtol=TANH_TOL, atol=TANH_TOL)


def test_serve_torch_without_batching_returns_no_batcher(torch_on_cpu):
    srv, port, batcher = tsvc.serve_torch(lambda t: {"y": t["x"] + 1})
    try:
        assert batcher is None
        with Channel(f"127.0.0.1:{port}") as ch:
            out = tsvc.TensorClient(ch).call("Call", {"x": torch.ones(2)})
        assert torch.equal(out["y"], torch.full((2,), 2.0))
    finally:
        srv.stop(grace=0)


def test_server_inflight_requests_counts_open_streams(torch_on_cpu):
    """inflight_requests: the requests admitted and not yet answered."""
    gate = threading.Event()
    srv, port, _ = tsvc.serve_torch(lambda t: (gate.wait(WAIT), t)[1],
                                    max_workers=8)
    try:
        assert srv.inflight_requests() == 0
        with Channel(f"127.0.0.1:{port}") as ch:
            pl = tsvc.TensorClient(ch, depth=4).pipeline("Call")
            futs = [pl.call_async({"x": torch.ones(1)}, timeout=30)
                    for _ in range(3)]
            _wait_until(lambda: srv.inflight_requests() == 3, "3 in flight")
            gate.set()
            for f in futs:
                f.result(timeout=WAIT)
            _wait_until(lambda: srv.inflight_requests() == 0, "drained")
    finally:
        gate.set()
        srv.stop(grace=0)
