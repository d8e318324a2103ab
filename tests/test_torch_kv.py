"""The port's paged KV plane against the reference's.

Every scenario runs on both packages' ``KvBlockManager`` (and, where a model
is involved, both ``ToyDecodeModel``s and schedulers) with the same seeded
inputs, and the observations must be equal: lengths, entries, block
counts, prefix hits, ``KvArenaFull``, truncate, swap, quarantine, the
entries' bytes, and the ledger's deltas for block grants. The port's model
runs on the CPU here. The KV plane's observability (the kv gauges, the
``/healthz`` kv lines and the watchdog's kv-swap/migration stages) has its
twins in ``tests/test_torch_gen_obs.py``."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

from tpurpc.core import rendezvous as ref_rdv
from tpurpc.jaxshim import generate as ref_gen
from tpurpc.obs import flight as ref_flight
from tpurpc.serving import kv as ref_kv
from tpurpc.serving import scheduler as ref_sched
from tpurpc.tpu import ledger as ref_ledger
from tpurpc_torch.core import rendezvous as rdv
from tpurpc_torch.serving import kv as port_kv
from tpurpc_torch.serving import scheduler as port_sched
from tpurpc_torch.torchshim import generate as port_gen
from tpurpc_torch.tpu import ledger as port_ledger

#: every wait on a stream or thread, seconds
WAIT = 30.0

REF = SimpleNamespace(name="ref", kv=ref_kv, sched=ref_sched,
                      model=ref_gen.ToyDecodeModel, rdv=ref_rdv,
                      ledger=ref_ledger)
PORT = SimpleNamespace(
    name="port", kv=port_kv, sched=port_sched, rdv=rdv, ledger=port_ledger,
    model=lambda **kw: port_gen.ToyDecodeModel(device="cpu", **kw))
BOTH = (REF, PORT)


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


def _mgr(m, **kw):
    kw.setdefault("n_blocks", 64)
    kw.setdefault("block_bytes", 64)   # 4 entries per block
    kw.setdefault("kind", "local")
    return m.kv.KvBlockManager(**kw)


def _entries(kv):
    return [kv.entry(i) for i in range(kv.length)]


# -- the arena / block tables -------------------------------------------------

def test_entry_layout_matches_reference():
    assert port_kv.ENTRY.format == ref_kv.ENTRY.format
    assert (port_kv.ENTRY_BYTES, port_kv.FLAG_POISONED) == \
        (ref_kv.ENTRY_BYTES, ref_kv.FLAG_POISONED) == (16, 1)


def test_alloc_free_accounting_roundtrips():
    def run(m):
        mgr = _mgr(m, n_blocks=8)
        try:
            obs = [(mgr.free_count(), mgr.used_count())]
            kv, hit = mgr.alloc_for_prompt(1, np.arange(9, dtype=np.int32))
            for i in range(9):
                kv.append(i * 3, i)
            obs.append((hit, len(kv.blocks), mgr.used_count()))
            mgr.free_blocks(kv)
            obs.append((mgr.free_count(), len(kv.blocks), kv.length))
            return obs
        finally:
            mgr.close()
    assert _same(run) == [(8, 0), (0, 3, 3), (8, 0, 0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entries_survive_block_boundaries(seed):
    rng = np.random.default_rng(seed)
    hs = [int(x) for x in rng.integers(0, 1 << 63, 13, dtype=np.int64)]
    hs[0] |= 1 << 63                       # a hash with its top bit set
    toks = rng.integers(0, 1 << 31, 13).tolist()

    def run(m):
        mgr = _mgr(m)
        try:
            kv, _ = mgr.alloc_for_prompt(1, np.asarray([1], np.int32))
            for i, (h, t) in enumerate(zip(hs, toks)):
                kv.append(h, t, i % 2)
            return _entries(kv), kv.last(), len(kv.blocks), \
                bytes(b"".join(bytes(v) for _i, v in kv.chunks(0, 13)))
        finally:
            mgr.close()
    got = _same(run)
    assert got[0] == [(h, t, i % 2) for i, (h, t) in enumerate(zip(hs, toks))]


def test_arena_full_raises_after_evicting_prefix_cache():
    def run(m):
        mgr = _mgr(m, n_blocks=4)
        try:
            kv, _ = mgr.alloc_for_prompt(1, np.arange(4, dtype=np.int32))
            for i in range(4):
                kv.append(i, i)
            mgr.free_blocks(kv, cache_prefix=True)
            obs = [mgr.prefix_entries()]
            kv2, _ = mgr.alloc_for_prompt(2, np.asarray([9], np.int32))
            kv2.reserve(16)
            obs.append((mgr.prefix_entries(), len(kv2.blocks)))
            try:
                kv3, _ = mgr.alloc_for_prompt(3, np.asarray([8], np.int32))
                kv3.reserve(4)
                obs.append("no raise")
            except m.kv.KvArenaFull as exc:
                obs.append(type(exc).__name__)
            mgr.free_blocks(kv2)
            return obs
        finally:
            mgr.close()
    assert _same(run) == [1, (0, 4), "KvArenaFull"]


def test_truncate_undoes_partial_appends():
    def run(m):
        mgr = _mgr(m)
        try:
            kv, _ = mgr.alloc_for_prompt(1, np.asarray([1], np.int32))
            for i in range(6):
                kv.append(i, i)
            kv.truncate(4)
            n = kv.length
            kv.append(99, 9)
            return n, kv.entry(4), len(kv.blocks)
        finally:
            mgr.close()
    assert _same(run) == (4, (99, 9, 0), 2)


def test_set_length_and_reserve_match_reference():
    def run(m):
        mgr = _mgr(m)
        try:
            kv, _ = mgr.alloc_for_prompt(1, np.asarray([1, 2], np.int32),
                                         reserve_entries=9)
            obs = [len(kv.blocks), kv.capacity()]
            kv.set_length(9)
            obs.append(kv.length)
            try:
                kv.set_length(13)
            except ValueError:
                obs.append("ValueError")
            return obs
        finally:
            mgr.close()
    assert _same(run) == [3, 12, 9, "ValueError"]


# -- copy-on-write prefix reuse -----------------------------------------------

def test_prefix_cache_hit_shares_blocks_refcounted():
    def run(m):
        mgr = _mgr(m)
        try:
            prompt = np.arange(10, dtype=np.int32)   # aligned span = 8
            kv, _ = mgr.alloc_for_prompt(1, prompt)
            for i in range(10):
                kv.append(i * 7, i)
            shared = list(kv.blocks[:2])
            mgr.free_blocks(kv, cache_prefix=True)
            kv2, hit = mgr.alloc_for_prompt(2, prompt)
            obs = [hit, kv2.blocks[:2] == shared, kv2.shared_len,
                   kv2.length, mgr.block_refs(shared[0]), kv2.entry(7),
                   mgr.prefix_hits, mgr.lookup_prefix(prompt)]
            mgr.free_blocks(kv2)
            obs.append(mgr.block_refs(shared[0]))
            return obs
        finally:
            mgr.close()
    assert _same(run) == [8, True, 8, 8, 2, (49, 7, 0), 1, (8, 49, 0), 1]


def test_cow_write_copies_shared_block():
    def run(m):
        mgr = _mgr(m)
        try:
            prompt = np.arange(8, dtype=np.int32)
            kv, _ = mgr.alloc_for_prompt(1, prompt)
            for i in range(8):
                kv.append(i, i)
            mgr.free_blocks(kv, cache_prefix=True)
            kv2, hit = mgr.alloc_for_prompt(2, prompt)
            orig = kv2.blocks[0]
            fresh = kv2.writable_block(0)
            obs = [hit, fresh != orig, mgr.block_refs(fresh),
                   kv2.entry(0), kv2.shared_len]
            mgr.block_view(fresh)[:4] = b"\xff\xff\xff\xff"
            kv3, hit3 = mgr.alloc_for_prompt(3, prompt)
            obs += [hit3, kv3.entry(0)]
            mgr.free_blocks(kv2)
            mgr.free_blocks(kv3)
            return obs
        finally:
            mgr.close()
    assert _same(run) == [8, True, 1, (0, 0, 0), 0, 8, (0, 0, 0)]


def test_poisoned_prefix_never_cached():
    def run(m):
        mgr = _mgr(m)
        try:
            model = m.model(poison_token=666)
            prompt = np.asarray([1, 2, 666, 4, 5, 6, 7, 8], np.int32)
            kv, _ = mgr.alloc_for_prompt(1, prompt)
            model.prefill_paged([prompt], [kv])
            obs = [kv.entry(7), kv.entry(1)]
            mgr.free_blocks(kv, cache_prefix=True)
            kv2, hit = mgr.alloc_for_prompt(2, prompt)
            obs += [mgr.prefix_entries(), hit]
            mgr.free_blocks(kv2)
            return obs
        finally:
            mgr.close()
    got = _same(run)
    assert got[0][2] & port_kv.FLAG_POISONED and not got[1][2]
    assert got[2:] == [0, 0]


# -- preempt-to-host swap -----------------------------------------------------

def test_swap_roundtrip_byte_exact():
    def run(m):
        mgr = _mgr(m)
        try:
            kv, _ = mgr.alloc_for_prompt(7, np.asarray([1], np.int32))
            for i in range(11):
                kv.append(i * 31 + (1 << 63), i, 0)
            used0 = mgr.used_count()
            mgr.swap_out(kv)
            obs = [kv.swapped, len(kv.blocks), used0 - mgr.used_count(),
                   mgr.swapped_count(), kv.entry(10),
                   bytes(b"".join(bytes(v) for _i, v in kv.chunks(0, 11)))]
            mgr.swap_in(kv)
            obs += [kv.swapped, mgr.swapped_count(), _entries(kv),
                    (mgr.swaps_out, mgr.swaps_in), mgr.stats()]
            mgr.free_blocks(kv)
            return obs
        finally:
            mgr.close()
    got = _same(run)
    assert got[:5] == [True, 0, 3, 3, (310 + (1 << 63), 10, 0)]
    assert got[6:8] == [False, 0]


def test_swap_in_of_full_arena_raises_and_keeps_the_image():
    def run(m):
        mgr = _mgr(m, n_blocks=3)
        try:
            kv, _ = mgr.alloc_for_prompt(1, np.asarray([1], np.int32))
            for i in range(9):
                kv.append(i, i)
            mgr.swap_out(kv)
            hog = mgr.alloc_blocks(2, 2)
            try:
                mgr.swap_in(kv)
                obs = ["no raise"]
            except m.kv.KvArenaFull:
                obs = ["KvArenaFull", kv.swapped, kv.entry(8),
                       mgr.free_count()]
            mgr.free_blocks_raw(hog)
            mgr.swap_in(kv)
            obs += [kv.swapped, _entries(kv)]
            mgr.free_blocks(kv)
            return obs
        finally:
            mgr.close()
    got = _same(run)
    assert got[:4] == ["KvArenaFull", True, (8, 8, 0), 1]


# -- quarantine ---------------------------------------------------------------

def test_quarantined_blocks_never_return_to_free_list():
    def run(m):
        mgr = _mgr(m, n_blocks=4)
        try:
            blocks = mgr.alloc_blocks(1, 2)
            obs = [mgr.quarantine(blocks), mgr.quarantined_count(),
                   mgr.free_count()]
            got = mgr.alloc_blocks(2, 2)
            obs.append(bool(set(got) & set(blocks)))
            try:
                mgr.alloc_blocks(3, 1)
                obs.append("no raise")
            except m.kv.KvArenaFull:
                obs.append("KvArenaFull")
            mgr.free_blocks_raw(got)
            return obs
        finally:
            mgr.close()
    assert _same(run) == [2, 2, 2, False, "KvArenaFull"]


def test_quarantine_respects_shared_refs():
    def run(m):
        mgr = _mgr(m)
        try:
            prompt = np.arange(8, dtype=np.int32)
            kv, _ = mgr.alloc_for_prompt(1, prompt)
            for i in range(8):
                kv.append(i, i)
            mgr.free_blocks(kv, cache_prefix=True)
            kv2, hit = mgr.alloc_for_prompt(2, prompt)
            obs = [hit, mgr.quarantine(kv2), mgr.prefix_entries()]
            kv3, hit3 = mgr.alloc_for_prompt(3, prompt)
            obs.append(hit3)
            mgr.free_blocks(kv3)
            return obs
        finally:
            mgr.close()
    assert _same(run) == [8, 0, 1, 8]


# -- the explicit-KV model contract -------------------------------------------

@pytest.mark.parametrize("prompt", [[1], [3, 1, 4], list(range(20)), [7] * 5])
def test_paged_contract_matches_opaque_path_exactly(prompt):
    def run(m):
        mgr = _mgr(m)
        try:
            model_a, model_b = m.model(), m.model()
            p = np.asarray(prompt, np.int32)
            states, toks = model_a.prefill([p])
            opaque = [int(toks[0])]
            for _ in range(15):
                states, toks = model_a.step(states,
                                            np.asarray(toks, np.int32))
                opaque.append(int(toks[0]))
            kv, _ = mgr.alloc_for_prompt(1, p)
            paged = [int(model_b.prefill_paged([p], [kv])[0])]
            for _ in range(15):
                paged.append(int(model_b.step_paged(
                    [kv], np.asarray([paged[-1]], np.int32))[0]))
            return opaque, paged, _entries(kv)
        finally:
            mgr.close()
    opaque, paged, _ = _same(run)
    assert opaque == paged == port_gen.reference_decode(prompt, 16)


def test_paged_prefill_resumes_from_cached_span_exactly():
    def run(m):
        mgr = _mgr(m)
        try:
            model = m.model()
            p = np.arange(10, dtype=np.int32)   # span 8 of 10: partial hit
            kv, _ = mgr.alloc_for_prompt(1, p)
            model.prefill_paged([p], [kv])
            mgr.free_blocks(kv, cache_prefix=True)
            kv2, hit = mgr.alloc_for_prompt(2, p)
            out = [int(model.prefill_paged([p], [kv2])[0])]
            for _ in range(7):
                out.append(int(model.step_paged(
                    [kv2], np.asarray([out[-1]], np.int32))[0]))
            return hit, out, _entries(kv2)
        finally:
            mgr.close()
    hit, out, _ = _same(run)
    assert hit == 8 and out == port_gen.reference_decode(np.arange(10), 8)


def test_hostkv_seeded_base_matches_cold_prefill():
    def run(m):
        model = m.model()
        p = np.arange(12, dtype=np.int32)
        cold = m.kv.HostKv()
        first_cold = int(model.prefill_paged([p], [cold])[0])
        base_hash = cold.entry(7)[0]
        warm = m.kv.HostKv(base_pos=8, base_hash=base_hash, base_flags=0)
        first_warm = int(model.prefill_paged([p], [warm])[0])
        return (first_cold, first_warm, bytes(cold.payload()),
                bytes(warm.payload()), warm.entry(7), warm.length)
    fc, fw, cold, warm, _e, n = _same(run)
    assert fc == fw == port_gen.reference_decode(np.arange(12), 1)[0]
    assert cold[8 * 16:] == warm and n == 13


def test_hostkv_truncate_keeps_the_base():
    def run(m):
        host = m.kv.HostKv(base_pos=4, base_hash=(1 << 64) - 5,
                           base_flags=1)
        for i in range(3):
            host.append(i, i)
        host.truncate(2)
        obs = [host.length, bytes(host.payload()), host.last()]
        try:
            host.entry(4)
            obs.append("no raise")
        except IndexError:
            obs.append("IndexError")
        return obs
    assert _same(run) == [4, b"", ((1 << 64) - 5, 0, 1), "IndexError"]


# -- the paged scheduler end to end -------------------------------------------

def _sched(m, model, mgr, **kw):
    kw.setdefault("idle_wait_s", 0.01)
    return m.sched.DecodeScheduler(model, kv=mgr, **kw)


def test_paged_scheduler_streams_reference_tokens():
    def run(m):
        mgr = _mgr(m, n_blocks=256)
        s = _sched(m, m.model(), mgr, max_batch=4)
        try:
            handles = {i: s.submit([i, i + 1], max_tokens=24)
                       for i in range(10)}
            return {i: list(h) for i, h in handles.items()}
        finally:
            s.close()
            mgr.close()
    got = _same(run)
    for i, toks in got.items():
        assert toks == port_gen.reference_decode([i, i + 1], 24), i


def _wait(pred, what):
    ev = threading.Event()
    for _ in range(int(WAIT / 0.005)):
        if pred():
            return
        ev.wait(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def test_paged_scheduler_releases_all_blocks_at_retire():
    def run(m):
        mgr = _mgr(m, n_blocks=64)
        s = _sched(m, m.model(), mgr, max_batch=4)
        try:
            outs = [list(s.submit([i], max_tokens=10)) for i in range(6)]
            _wait(lambda: mgr.used_count() == 0, "blocks freed")
            return outs, mgr.used_count(), mgr.prefix_entries()
        finally:
            s.close()
            mgr.close()
    outs, used, cached = _same(run)
    assert used == 0 and cached == 0


def test_paged_long_prompt_donates_its_prefix_and_hits():
    """A prompt of two full blocks is cached at retire; the same prompt
    again prefills only its tail and streams the same tokens."""
    prompt = list(range(40, 48))

    def run(m):
        mgr = _mgr(m, n_blocks=64)
        s = _sched(m, m.model(), mgr, max_batch=2)
        try:
            a = list(s.submit(prompt, max_tokens=6))
            _wait(lambda: mgr.prefix_entries() == 1, "prefix donated")
            b = list(s.submit(prompt, max_tokens=6))
            _wait(lambda: mgr.used_count() == 2, "second retire")
            return a, b, mgr.prefix_hits, mgr.stats()
        finally:
            s.close()
            mgr.close()
    a, b, hits, _stats = _same(run)
    assert a == b == port_gen.reference_decode(prompt, 6) and hits == 1


class _Gate:
    """Parks a model's step until released (bounded)."""

    def __init__(self):
        self.entered = threading.Event()
        self.go = threading.Event()

    def wrap(self, model, name):
        inner = getattr(model, name)

        def gated(*args):
            self.entered.set()
            assert self.go.wait(WAIT), "gate never released"
            return inner(*args)
        setattr(model, name, gated)
        return model


def test_paged_swap_preemption_resumes_value_exact():
    """The batch-class row is parked in a gated step; an interactive
    submit then finds the batch full, preempts it (a swap to host) and
    runs; the swapped row swaps back in and finishes exactly."""
    def run(m):
        mgr = _mgr(m, n_blocks=128, block_bytes=256)
        gate = _Gate()
        s = _sched(m, gate.wrap(m.model(), "step_paged"), mgr, max_batch=1,
                   idle_wait_s=0.005)
        try:
            long = s.submit([9], max_tokens=60, slo="batch")
            head = long.next(timeout=WAIT)
            assert gate.entered.wait(WAIT)
            quick = s.submit([4], max_tokens=4, slo="interactive")
            gate.go.set()
            q = list(quick)
            rest = list(long)
            return (head, q, rest, s.preempted_total, mgr.swaps_out >= 1,
                    mgr.swaps_in >= 1)
        finally:
            gate.go.set()
            s.close()
            mgr.close()
    head, q, rest, pre, out, back = _same(run)
    assert [head] + rest == port_gen.reference_decode([9], 60)
    assert q == port_gen.reference_decode([4], 4)
    assert (pre, out, back) == (1, True, True)


def test_paged_poisoned_sequence_fails_alone_and_frees():
    def run(m):
        mgr = _mgr(m, n_blocks=64)
        s = _sched(m, m.model(poison_token=666), mgr, max_batch=4)
        try:
            good1 = s.submit([3], max_tokens=20)
            bad = s.submit([666], max_tokens=20)
            good2 = s.submit([4], max_tokens=20)
            g1, g2 = list(good1), list(good2)
            try:
                list(bad)
                err = "no raise"
            except ValueError as exc:
                err = str(exc)
            _wait(lambda: mgr.used_count() == 0, "blocks freed")
            return g1, g2, err, mgr.used_count()
        finally:
            s.close()
            mgr.close()
    g1, g2, err, used = _same(run)
    assert g1 == port_gen.reference_decode([3], 20)
    assert g2 == port_gen.reference_decode([4], 20)
    assert "poison" in err and used == 0


def test_paged_scheduler_requires_contract():
    class NoPaged:
        pass

    def run(m):
        mgr = _mgr(m)
        try:
            m.sched.DecodeScheduler(NoPaged(), kv=mgr)
            return "no raise"
        except ValueError as exc:
            return "explicit-KV" in str(exc)
        finally:
            mgr.close()
    assert _same(run) is True


# -- block grants over an shm arena -------------------------------------------

def test_block_grant_wire_matches_reference():
    args = (7, "shm", "shm:psm_x", 256, [64, 320, 1088], 4096,
            bytes(range(16)), 2112)
    wire = rdv.BlockGrant(*args).to_wire()
    assert wire == ref_rdv.BlockGrant(*args).to_wire()
    g = rdv.BlockGrant.from_wire(wire)
    assert (g.grant_id, g.kind, g.handle, g.block_bytes, g.offsets,
            g.window_bytes, g.nonce, g.nonce_off, g.capacity) == \
        (7, "shm", "shm:psm_x", 256, (64, 320, 1088), 4096,
         bytes(range(16)), 2112, 768)


def test_grant_writer_lands_blocks_and_bills_rdma_write():
    """A writer fills granted blocks of an shm arena one-sided; the arena
    reads the entries back, and each package bills the same bytes."""
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, 700, dtype=np.uint8).tobytes()

    def run(m):
        mgr = _mgr(m, n_blocks=16, block_bytes=256, kind="shm")
        writer = m.rdv.GrantWriter()
        try:
            kv, _ = mgr.alloc_for_prompt(1, np.asarray([1], np.int32),
                                         reserve_entries=44)
            grant = m.rdv.BlockGrant(
                1, mgr.kind, mgr.region_handle, mgr.block_bytes,
                [mgr.block_offset(b) for b in kv.blocks], mgr.window_bytes,
                mgr.nonce, mgr.nonce_off)
            chunks = [payload[o:o + 256] for o in range(0, 700, 256)]
            with m.ledger.track() as w:
                n = writer.write_blocks(grant, chunks)
            kv.set_length(43)
            landed = b"".join(bytes(v) for _i, v in kv.chunks(0, 43))
            bad = m.rdv.BlockGrant(2, mgr.kind, mgr.region_handle,
                                   mgr.block_bytes, [0], mgr.window_bytes,
                                   b"\x00" * 16, mgr.nonce_off)
            try:
                writer.write_blocks(bad, [b"x"])
                nonce = "no raise"
            except OSError:
                nonce = "OSError"
            return (n, landed[:688], w["rdma_write"], w["rdma_write_ops"],
                    w["host_copy"], nonce)
        finally:
            writer.close()
            mgr.close()
    n, landed, billed, ops, host, nonce = _same(run)
    assert (n, billed, ops, host, nonce) == (700, 700, 1, 0, "OSError")
    assert landed == payload[:688]
