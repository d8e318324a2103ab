"""The port's device ring (tpurpc_torch.tpu.hbm_ring) against the reference's
(tpurpc.tpu.hbm_ring), on one op script.

The same script — place, place_many across the wrap, views of several
dtypes and shapes, out-of-order release, a poison view, lease_region / fill /
release-without-fill, a full ring — runs on the reference ring under
JAX_PLATFORMS=cpu and on the port's ring with device="cpu". Every step's
bytes, shapes, ``stats()``, lease ``aliased`` flags, exceptions and copy-ledger
deltas (bytes and op counts) must agree, with two stated differences (in
``EXPECTED_DIFF``):

* a bf16 view is an alias in the port and a copy in the reference (the
  reference's aliasing goes through numpy + dlpack, which has no bf16);
* a view whose offset is a multiple of its dtype's size but not of 64 bytes
  (``view_off4``, ``view_N``) is an alias in the port and a copy in the
  reference (XLA's CPU backend copies a dlpack import that is not 64-byte
  aligned).

The ring is 32 KiB (above the reference kernels' capacity floors) and every
other span is 64-byte aligned, so the reference takes its single-landing
Pallas path and both rings book one ``dma_d2d`` per placement.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from tpurpc.tpu import ledger as jax_ledger
from tpurpc.tpu.hbm_ring import HbmRing as JaxRing
from tpurpc_torch.tpu import ledger as torch_ledger
from tpurpc_torch.tpu.hbm_ring import HbmRing as TorchRing

CAP = 32768
BF16 = np.dtype(ml_dtypes.bfloat16)
_KEYS = ("dma_h2d", "dma_d2d", "zero_copy", "host_copy")

#: step -> {ledger key: (port delta, reference delta)} where the two differ
EXPECTED_DIFF = {
    "view_bf16": {"zero_copy": (128, 0), "zero_copy_ops": (1, 0),
                  "dma_d2d": (0, 128), "dma_d2d_ops": (0, 1),
                  "aliased": (True, False)},
    "view_off4": {"zero_copy": (68, 0), "zero_copy_ops": (1, 0),
                  "dma_d2d": (0, 68), "dma_d2d_ops": (0, 1),
                  "aliased": (True, False)},
    "view_N": {"zero_copy": (45, 0), "zero_copy_ops": (1, 0),
               "dma_d2d": (0, 45), "dma_d2d_ops": (0, 1),
               "aliased": (True, False)},
}


class _JaxSide:
    name = "reference"
    ledger = jax_ledger

    def __init__(self):
        self.ring = JaxRing(CAP)

    @staticmethod
    def dtype(np_dt):
        return np_dt

    @staticmethod
    def record(arr):
        a = np.asarray(arr)
        return (a.tobytes(), tuple(a.shape), np.dtype(a.dtype).name)


class _TorchSide:
    name = "port"
    ledger = torch_ledger

    def __init__(self):
        self.ring = TorchRing(CAP, device="cpu")

    @staticmethod
    def dtype(np_dt):
        if np_dt == BF16:
            return torch.bfloat16
        return torch.from_numpy(np.empty(0, np_dt)).dtype

    @staticmethod
    def record(t):
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        return (raw, tuple(t.shape), str(t.dtype).replace("torch.", ""))


def _payloads():
    r = np.random.default_rng(7)
    return {
        "A": r.standard_normal((16, 32)).astype(np.float32),    # 2048 B
        "B": r.integers(-99, 99, 256).astype(np.int32),          # 1024 B
        "C": r.integers(0, 256, 960, dtype=np.uint8),            # 960 B
        "Z": np.zeros(0, np.float32),                            # empty
        "D": r.standard_normal(256).astype(np.float16),          # 512 B
        "E": r.standard_normal(6144).astype(np.float32),         # 24576 B
        "F": r.integers(0, 256, 4096, dtype=np.uint8),           # wraps
        "G": r.standard_normal(256).astype(np.float32),          # 1024 B
        "H": r.standard_normal(64).astype(BF16),                 # 128 B
        "J": r.integers(0, 256, 3, dtype=np.uint8),
        "K": r.standard_normal(4).astype(np.float32),            # off by 3
        "N": r.integers(0, 256, 45, dtype=np.uint8),            # realigns
        "L": r.integers(0, 256, 60, dtype=np.uint8),
        "M": r.standard_normal(17).astype(np.float32),           # off by 4
        "R": r.integers(-9, 9, 512).astype(np.int16),            # region
    }


def _script(side):
    """The op script as ``[(step, fn)]``; ``fn()`` runs one step on
    ``side.ring`` and returns what the comparison records. Building the list
    runs nothing, so the step names are known at collection."""
    P = _payloads()
    leases = {}
    spans = {}

    def place(name):
        spans[name] = side.ring.place(P[name])
        return spans[name]

    def place_many(*names):
        got = side.ring.place_many([P[n] for n in names])
        spans.update(zip(names, got))
        return got

    def view(key, name, shape=None):
        off, n = spans[name]
        lease = side.ring.view(off, n, dtype=side.dtype(P[name].dtype),
                               shape=shape)
        leases[key] = lease
        return side.record(lease.array) + (lease.aliased,)

    def release(key):
        leases.pop(key).release()

    def region_fill_view():
        region = side.ring.lease_region(P["R"].nbytes)
        region.fill(P["R"])
        lease = region.view(dtype=side.dtype(P["R"].dtype), shape=(512,))
        rec = side.record(lease.array) + (lease.aliased,)
        lease.release()
        region.release()
        return rec

    def region_unfilled():
        region = side.ring.lease_region(4096)
        mid = side.ring.stats()["writable"]
        region.release()
        return mid

    return [
        ("place_A", lambda: place("A")),
        ("view_A", lambda: view("A", "A", (16, 32))),
        ("place_many_BCZD", lambda: place_many("B", "C", "Z", "D")),
        ("view_B", lambda: view("B", "B", (256,))),
        ("view_C", lambda: view("C", "C", (960,))),
        ("view_Z", lambda: view("Z", "Z", (0,))),
        ("view_D", lambda: view("D", "D", (16, 16))),
        ("release_C_first", lambda: release("C")),  # head must not move
        ("release_A", lambda: release("A")),
        ("release_B", lambda: release("B")),        # head over B and C
        ("poison_view_D", lambda: view("D2", "D", (7,))),
        ("release_D", lambda: release("D")),
        ("release_Z", lambda: release("Z")),
        ("place_E", lambda: place("E")),
        ("place_many_FG_across_wrap", lambda: place_many("F", "G")),
        ("view_E", lambda: view("E", "E", (96, 64))),
        ("view_F_wrapped", lambda: view("F", "F", (4096,))),
        ("view_G", lambda: view("G", "G", (16, 16))),
        ("full_ring_fails_fast",
         lambda: side.ring.place(np.zeros(CAP // 2, np.uint8))),
        ("oversized_fails",
         lambda: side.ring.place(np.zeros(CAP + 64, np.uint8))),
        ("release_E", lambda: release("E")),
        ("release_F", lambda: release("F")),
        ("release_G", lambda: release("G")),
        ("place_H", lambda: place("H")),
        ("view_bf16", lambda: view("H", "H", (64,))),
        ("release_H", lambda: release("H")),
        ("place_many_JKN", lambda: place_many("J", "K", "N")),
        ("view_off3", lambda: view("K", "K", (4,))),
        ("release_K", lambda: release("K")),
        ("view_J", lambda: view("J", "J")),
        ("release_J", lambda: release("J")),
        ("view_N", lambda: view("N", "N")),
        ("release_N", lambda: release("N")),
        ("place_many_LM", lambda: place_many("L", "M")),
        ("view_off4", lambda: view("M", "M", (17,))),
        ("view_L", lambda: view("L", "L")),
        ("release_M", lambda: release("M")),
        ("release_L", lambda: release("L")),
        ("lease_region_fill_view", region_fill_view),
        ("lease_region_release_unfilled", region_unfilled),
        ("view_before_fill_fails", lambda: side.ring.lease_region(64).view()),
    ]


def _run_script(side):
    """Run the op script; returns [(step, record)] for comparison."""
    out = []
    for name, fn in _script(side):
        with side.ledger.track() as w:
            try:
                rec = fn()
            except Exception:  # both rings must fail on the same steps
                rec = "raised"
        delta = {k: w[k] for k in _KEYS}
        delta.update({k + "_ops": w[k + "_ops"] for k in _KEYS})
        out.append((name, {"result": rec, "ledger": delta,
                           "stats": side.ring.stats()}))
    return out


@pytest.fixture(scope="module")
def transcripts():
    return _run_script(_JaxSide()), _run_script(_TorchSide())


@pytest.mark.parametrize("step", [name for name, _ in _script(None)])
def test_op_script_step_matches_reference(transcripts, step):
    ref = dict(transcripts[0])[step]
    port = dict(transcripts[1])[step]
    assert port["stats"] == ref["stats"]
    diff = EXPECTED_DIFF.get(step, {})
    for key, val in ref["ledger"].items():
        if key in diff:
            assert (port["ledger"][key], val) == diff[key], key
        else:
            assert port["ledger"][key] == val, key
    p, r = port["result"], ref["result"]
    assert (p == "raised") == (r == "raised")
    if "aliased" in diff:
        assert (p[-1], r[-1]) == diff["aliased"]
        p, r = p[:-1], r[:-1]
    assert p == r


def test_script_ends_with_all_credit_returned(transcripts):
    for side in transcripts:
        stats = side[-1][1]["stats"]
        # one 64-byte region stays claimed by the last (failed-view) step
        assert stats["live_spans"] == 1
        assert stats["writable"] == CAP - 64


def test_port_views_alias_the_ring_by_address():
    ring = TorchRing(CAP, device="cpu")
    off, n = ring.place(np.arange(64, dtype=np.float32))
    lease = ring.view(off, n, dtype=torch.float32, shape=(8, 8))
    assert lease.aliased
    assert lease.array.data_ptr() == ring.buf.data_ptr() + (off & (CAP - 1))
    lease.release()
    assert ring.stats()["writable"] == CAP


def test_port_ring_wait_for_space_times_out_then_succeeds():
    import threading

    ring = TorchRing(4096, device="cpu")
    off, n = ring.place(np.zeros(3072, np.uint8))
    lease = ring.view(off, n)
    with pytest.raises(BufferError):
        ring.place(np.zeros(2048, np.uint8), timeout=0.05)
    threading.Timer(0.05, lease.release).start()
    assert ring.place(np.zeros(2048, np.uint8), timeout=5.0) == (3072, 2048)


def test_port_ring_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchRing(CAP, device="cuda")


@pytest.mark.parametrize("wrap", [False, True], ids=["unwrapped", "wrapped"])
def test_port_release_then_place_over_the_same_span(wrap):
    """A lease's span, read, released, then written over by a ring-sized
    payload (a wrapped landing write whose segments cover the span): the
    read saw the old bytes and a new view sees the new ones. On the CPU
    there are no streams, so no release event is kept (on a card the write
    waits on one: tests/test_torch_cuda.py)."""
    ring = TorchRing(CAP, device="cpu")
    if wrap:    # move the tail so that the span lands across the wrap point
        pad = ring.place(np.zeros(CAP - 4096, np.uint8))
        ring.view(*pad).release()
    off, n = ring.place(np.full(8192, 1, np.uint8))
    assert ((off & (CAP - 1)) + n > CAP) == wrap
    lease = ring.view(off, n)
    seen = lease.array.clone()
    lease.release()
    assert ring._reads == []
    off2, n2 = ring.place(np.full(CAP, 2, np.uint8))
    assert bool((seen == 1).all())
    assert bool((ring.buf == 2).all())
    with ring.view(off2, n2) as again:
        assert bool((again == 2).all())
    assert ring.stats()["writable"] == CAP
