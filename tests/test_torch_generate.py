"""The port's step model against the reference's, on the CPU.

``tpurpc_torch.torchshim.generate.ToyDecodeModel`` keeps its state as an
int64 tensor on its device and folds prompts with precomputed wrapped
powers of the hash's multiplier; the reference's is numpy uint64 and a
Python loop. The same seeded prompts go through both: tokens, states (as
uint64 bits) and the paged entries' bytes must be equal, hashes whose top
bit is set included."""

import numpy as np
import pytest
import torch

from tpurpc.jaxshim import generate as ref_gen
from tpurpc.serving.kv import HostKv as RefHostKv
from tpurpc_torch.serving.kv import HostKv
from tpurpc_torch.torchshim import generate as gen
from tpurpc_torch.utils import config as torch_config

MASK64 = (1 << 64) - 1


def _model(**kw):
    return gen.ToyDecodeModel(device="cpu", **kw)


def _prompts(seed, n=64, lo=1, hi=64, vocab=251):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(n)]


def _u64(states: torch.Tensor) -> np.ndarray:
    return states.cpu().numpy().view(np.uint64)


def _loop_hash(prompt) -> int:
    """The prompt fold one token at a time, in Python integers."""
    h = 0
    for t in np.asarray(prompt, np.int64).tolist():
        h = (h * gen._MULT + gen._INC + t) & MASK64
    return h


# -- the opaque-state contract ------------------------------------------------

def test_toy_model_matches_reference():
    m = _model()
    states, toks = m.prefill([np.asarray([3, 1, 4], np.int32)])
    out = [int(toks[0])]
    for _ in range(7):
        states, toks = m.step(states, np.asarray(toks, np.int32))
        out.append(int(toks[0]))
    assert out == ref_gen.reference_decode([3, 1, 4], 8)
    assert isinstance(states, torch.Tensor) and states.dtype == torch.int64


def test_toy_model_rows_independent():
    m = _model()
    sa, ta = m.prefill([np.asarray([1], np.int32)])
    sb, tb = m.prefill([np.asarray([2], np.int32)])
    both, tboth = m.prefill([np.asarray([1], np.int32),
                             np.asarray([2], np.int32)])
    assert list(tboth) == [int(ta[0]), int(tb[0])]
    s2, t2 = m.step(both, tboth)
    sa2, ta2 = m.step(sa, ta)
    sb2, tb2 = m.step(sb, tb)
    assert list(t2) == [int(ta2[0]), int(tb2[0])]
    assert torch.equal(s2, torch.cat([sa2, sb2]))


@pytest.mark.parametrize("seed", range(5))
def test_prefill_and_steps_match_reference(seed):
    """64 seeded prompts of 1–64 tokens, one batched prefill and 12 steps
    in both packages: equal tokens and equal state bits."""
    prompts = _prompts(seed)
    port, ref = _model(), ref_gen.ToyDecodeModel()
    ps, pt = port.prefill(prompts)
    rs, rt = ref.prefill(prompts)
    assert pt.dtype == np.int32 and list(pt) == list(rt)
    np.testing.assert_array_equal(_u64(ps), rs)
    for _ in range(12):
        ps, pt = port.step(ps, pt)
        rs, rt = ref.step(rs, rt)
        assert list(pt) == list(rt)
    np.testing.assert_array_equal(_u64(ps), rs)
    assert (port.prefills, port.steps) == (ref.prefills, ref.steps) == (1, 12)


def test_hashes_with_the_top_bit_set_match():
    """Half the folded hashes of random prompts have bit 63 set; an int64
    shift copies it, so the sample masks after the shift. Every such row
    must still match the uint64 reference."""
    prompts = _prompts(11, n=256, lo=1, hi=8)
    ps, pt = _model().prefill(prompts)
    rs, rt = ref_gen.ToyDecodeModel().prefill(prompts)
    top = rs[:, 0] >> np.uint64(63)
    assert 64 < int(top.sum()) < 192
    assert bool((ps[:, 0] < 0).any())
    np.testing.assert_array_equal(_u64(ps), rs)
    assert list(pt) == list(rt)


@pytest.mark.parametrize("h", [0, 1, (1 << 63) - 1, 1 << 63, MASK64,
                               0xDEADBEEFCAFEF00D, 0x8000FFFF0000FFFF])
def test_sample_of_edge_hashes(h):
    m = _model(vocab=97)
    t = torch.tensor([h - (1 << 64) if h >> 63 else h], dtype=torch.int64)
    assert int(m._sample(t)[0]) == (h >> 16) % 97


@pytest.mark.parametrize("seed", range(3))
def test_vectorised_prefill_equals_the_loop(seed):
    """The one-product-one-sum fold is bit-equal to folding token by
    token, for prompts up to 300 tokens and tokens up to 2^31 - 1."""
    rng = np.random.default_rng(100 + seed)
    prompts = [rng.integers(0, 2 ** 31 - 1, int(n)).astype(np.int64)
               for n in rng.integers(1, 300, 16)]
    ps, _ = _model().prefill(prompts)
    want = [_loop_hash(p) * gen._MULT + gen._INC & MASK64 for p in prompts]
    assert _u64(ps)[:, 0].tolist() == want


def test_power_tables_grow_and_stay_exact():
    m = _model()
    p1 = [np.arange(5)]
    m.prefill(p1)
    assert m._pow_tables[0].numel() == m._pow_tables[1].numel() == 64
    long = np.arange(1000) % 251
    s, t = m.prefill([long])
    assert m._pow_tables[0].numel() == 1024
    assert int(_u64(s)[0, 0]) == _loop_hash(long) * gen._MULT + gen._INC \
        & MASK64
    inv = (m._pow_tables[0] * m._pow_tables[1]).numpy()
    assert (inv == 1).all()     # MULT^i * MULT^-i == 1 mod 2^64


def test_concurrent_prefills_share_one_model():
    """A prefill server calls one model from many handler threads, each
    growing the power tables to its own prompt's length."""
    import threading

    m = _model()
    prompts = _prompts(31, n=48, lo=1, hi=300)
    out, errors = {}, []

    def go(i):
        try:
            kv = HostKv()
            out[i] = (int(m.prefill_paged([prompts[i]], [kv])[0]),
                      int(m.prefill([prompts[i]])[1][0]))
        except Exception as exc:
            errors.append(exc)
    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors
    for i, p in enumerate(prompts):
        first = ref_gen.reference_decode(p, 1)[0]
        assert out[i] == (first, first)


@pytest.mark.parametrize("vocab", [2, 7, 251, 50257])
def test_reference_decode_matches_reference(vocab):
    for p in _prompts(vocab, n=8, vocab=min(vocab, 251)):
        assert gen.reference_decode(p, 20, vocab=vocab) == \
            ref_gen.reference_decode(p, 20, vocab=vocab)


def test_eos_in_reference_decode():
    full = ref_gen.reference_decode([7], 64)
    eos = full[5]
    want = ref_gen.reference_decode([7], 64, eos=eos)
    assert gen.reference_decode([7], 64, eos=eos) == want
    assert want == full[:full.index(eos) + 1]


# -- failure knobs --------------------------------------------------------------

def test_poison_fails_the_batch_and_a_clean_row_alone_succeeds():
    port, ref = _model(poison_token=666), \
        ref_gen.ToyDecodeModel(poison_token=666)
    prompts = [np.asarray([1, 666], np.int32), np.asarray([3], np.int32)]
    ps, pt = port.prefill(prompts)
    rs, rt = ref.prefill(prompts)
    assert list(pt) == list(rt)
    np.testing.assert_array_equal(_u64(ps), rs)   # poisoned column too
    for m, s, t in ((port, ps, pt), (ref, rs, rt)):
        with pytest.raises(ValueError, match="poisoned row"):
            m.step(s, t)
    p1, t1 = port.step(ps[1:], pt[1:])
    r1, u1 = ref.step(rs[1:], rt[1:])
    assert list(t1) == list(u1) == ref_gen.reference_decode([3], 2)[1:]
    assert port.steps == ref.steps == 2


def test_bad_inputs_raise_like_the_reference():
    for make in (_model, ref_gen.ToyDecodeModel):
        m = make()
        with pytest.raises(ValueError, match="empty prompt"):
            m.prefill([np.asarray([], np.int32)])
        with pytest.raises(ValueError, match="bad state shape"):
            m.step(np.zeros((2, 2), np.int64), np.zeros(2, np.int32))
        with pytest.raises(ValueError, match="empty prompt"):
            m.prefill_paged([np.asarray([], np.int32)], [HostKv()])
    with pytest.raises(ValueError, match="vocab"):
        _model(vocab=1)


def test_device_follows_the_config(monkeypatch):
    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    torch_config.set_config(None)
    try:
        assert gen.ToyDecodeModel().device == torch.device("cpu")
    finally:
        torch_config.set_config(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gen.ToyDecodeModel(device="cuda")


# -- the explicit-KV contract ---------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_paged_entries_match_reference_bytes(seed):
    """A batched paged prefill and 6 steps: tokens and every entry's bytes
    equal the reference's (hashes, tokens, flags)."""
    prompts = _prompts(20 + seed, n=16)
    port, ref = _model(poison_token=250), \
        ref_gen.ToyDecodeModel(poison_token=250)
    pk, rk = [HostKv() for _ in prompts], [RefHostKv() for _ in prompts]
    pt = port.prefill_paged(prompts, pk)
    rt = ref.prefill_paged(prompts, rk)
    assert list(pt) == list(rt)
    clean = [i for i, p in enumerate(prompts) if 250 not in p]
    pk, rk = [pk[i] for i in clean], [rk[i] for i in clean]
    pt, rt = pt[clean], rt[clean]
    for _ in range(6):
        pt = port.step_paged(pk, pt)
        rt = ref.step_paged(rk, rt)
        assert list(pt) == list(rt)
    for a, b in zip(pk, rk):
        assert bytes(a.payload()) == bytes(b.payload())
        assert a.length == b.length


def test_paged_prefill_from_a_mid_sequence_base():
    """Rows whose tables already hold a prefix (a cache hit) fold only
    the tail, in one batch with cold rows and a row whose whole prompt is
    cached."""
    prompts = [np.arange(12), np.arange(5, 9), np.arange(30, 34)]
    cold = [HostKv() for _ in prompts]
    _model().prefill_paged(prompts, cold)
    bases = [8, 0, 4]
    warm = [HostKv(base_pos=b, base_hash=c.entry(b - 1)[0] if b else 0)
            for b, c in zip(bases, cold)]
    toks = _model().prefill_paged(prompts, warm)
    assert list(toks) == [ref_gen.reference_decode(p, 1)[0]
                          for p in prompts]
    for b, c, w in zip(bases, cold, warm):
        assert bytes(c.payload()[b * 16:]) == bytes(w.payload())


def test_paged_poison_flags_stick_and_fail_the_batch():
    port, ref = _model(poison_token=9), ref_gen.ToyDecodeModel(
        poison_token=9)
    prompts = [np.asarray([1, 9, 2], np.int32), np.asarray([4], np.int32)]
    pk, rk = [HostKv(), HostKv()], [RefHostKv(), RefHostKv()]
    port.prefill_paged(prompts, pk)
    ref.prefill_paged(prompts, rk)
    assert [pk[0].entry(i)[2] for i in range(4)] == [0, 1, 1, 1]
    assert bytes(pk[0].payload()) == bytes(rk[0].payload())
    for m, kvs in ((port, pk), (ref, rk)):
        with pytest.raises(ValueError, match="poisoned row"):
            m.step_paged(kvs, np.zeros(2, np.int32))
    assert list(port.step_paged(pk[1:], np.zeros(1, np.int32))) == \
        list(ref.step_paged(rk[1:], np.zeros(1, np.int32)))


def test_paged_prefill_refuses_a_table_longer_than_its_prompt():
    kv = HostKv(base_pos=5, base_hash=1)
    with pytest.raises(ValueError, match="5 entries for a 3-token prompt"):
        _model().prefill_paged([np.arange(3)], [kv])
