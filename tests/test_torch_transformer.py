"""The port's MoE transformer (``tpurpc_torch.models.transformer``) against
the reference's (``tpurpc.models.transformer``), on the CPU.

The reference's ``init_params`` output goes across as numpy arrays through
``from_jax``; both run the same tokens, made from a seed with numpy. The
reference runs ``build_forward`` (jitted ``shard_map``) on JAX's CPU
devices; the port runs on its one-rank mesh with ``device="cpu"``.

Tolerances, of max(1, the reference's largest |logit|):

* float32 at the defaults' full width cut to 2 layers, against the 1-device
  mesh: 1e-5 (readings 7.8e-7 and 8.7e-7: the same arithmetic in another
  summation order).
* float32 at ``tests/test_transformer.py``'s config against 8-device
  meshes: that test's 5e-4.
* bfloat16. The reference's jitted forward may keep excess precision inside
  a fusion (``xla_allow_excess_precision``), where the port rounds every op
  to bf16, so the two differ by bf16 roundings (one ulp is 2^-8 relative),
  and a token whose router margin is inside that rounding can take the
  other expert, which moves its logits by a large part of the scale.
  Readings on this test's inputs (B 4, S 32, 2 layers, seeds 0–5), per
  token position the max |diff| over the vocab: median 0.0035 – 0.0042, at
  most one position of 128 above 2^-6 (routing flips, 0.22 and 0.35);
  the port's float32 forward of the same bf16-valued weights reads a
  median 0.0036 – 0.0045, above the bf16 port's on every seed. Limits: the
  median at most 2^-7 (0.0078), at most 2 positions above 2^-6, and the
  median below the float32 forward's.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurpc.jaxshim import service as jsvc
from tpurpc.models import transformer as jtfm
from tpurpc.parallel import mesh as jmesh
from tpurpc_torch.models import transformer as ttfm
from tpurpc_torch.parallel import build_mesh
from tpurpc_torch.parallel import mesh as tmesh
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.rpc.server import Server
from tpurpc_torch.torchshim import service as tsvc
from tpurpc_torch.utils import config as torch_config

F32_TOL = 1e-5
MESH8_TOL = 5e-4
BF16_MEDIAN = 2 ** -7
BF16_POS = 2 ** -6
BF16_MAX_FLIPS = 2
WAIT = 30.0

#: the defaults' full width (vocab 256, d 128, 8 heads x 16, d_ff 256,
#: 2 experts, capacity factor 2.0, 2 microbatches), cut to 2 layers
FULL = {"n_layers": 2}
#: tests/test_transformer.py's config
SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, d_ff=64,
             n_layers=2, n_experts=2, capacity_factor=16.0, n_micro=2)


def _cfgs(kw, dtype="float32"):
    return (jtfm.TransformerConfig(**kw, dtype=getattr(jnp, dtype)),
            ttfm.TransformerConfig(**kw, dtype=getattr(torch, dtype)))


def _jax_params(jcfg, seed=0):
    return jtfm.init_params(jax.random.PRNGKey(seed), jcfg)


def _ref_logits(jcfg, params, tokens, n=1, sizes=None):
    m = jmesh.build_mesh(n, sizes=sizes)
    fwd = jtfm.build_forward(jcfg, m)
    return np.asarray(fwd(jtfm.shard_params(params, jcfg, m),
                          jnp.asarray(tokens)))


def _port_model(tcfg, params):
    model = ttfm.Transformer(tcfg, build_mesh(1, device="cpu"))
    model.load_state_dict(ttfm.from_jax(
        {k: np.asarray(v) for k, v in params.items()}))
    return model


def _port_logits(model, tokens):
    with torch.inference_mode():
        return model(torch.from_numpy(np.asarray(tokens))).numpy()


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# -- forward against the reference --------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_forward_full_width_matches_reference(seed):
    jcfg, tcfg = _cfgs(FULL)
    params = _jax_params(jcfg, seed)
    tokens = _tokens(jcfg.vocab, 4, 32, seed)
    want = _ref_logits(jcfg, params, tokens)
    got = _port_logits(_port_model(tcfg, params), tokens)
    assert got.shape == (4, 32, 256) and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("sizes", [{"sp": 2, "tp": 2, "ep": 2},
                                   {"dp": 2, "pp": 2, "sp": 2},
                                   {"dp": 2, "tp": 2, "pp": 2},
                                   {"ep": 2, "pp": 2, "dp": 2}],
                         ids=lambda s: "-".join(f"{k}{v}" for k, v in
                                                s.items()))
def test_forward_matches_reference_on_8_device_meshes(sizes):
    """The reference shards the same program 8 ways (capacity factor 16:
    the MoE never drops, so the factorization is exact math)."""
    jcfg, tcfg = _cfgs(SMALL)
    params = _jax_params(jcfg)
    tokens = _tokens(jcfg.vocab, 8, 16, 0)
    want = _ref_logits(jcfg, params, tokens, n=8, sizes=sizes)
    got = _port_logits(_port_model(tcfg, params), tokens)
    np.testing.assert_allclose(got, want, rtol=MESH8_TOL, atol=MESH8_TOL)


def _per_position(got, want, scale):
    return (np.abs(got - want).max(axis=-1) / scale).ravel()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_forward_bf16_within_readings(seed):
    params32 = _jax_params(_cfgs(FULL)[0], seed)
    jcfg, tcfg = _cfgs(FULL, "bfloat16")
    params = {k: v.astype(jnp.bfloat16) for k, v in params32.items()}
    tokens = _tokens(jcfg.vocab, 4, 32, seed)
    want = _ref_logits(jcfg, params, tokens)
    model = _port_model(tcfg, params)
    assert model.wq.dtype == torch.bfloat16
    got = _port_logits(model, tokens)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    scale = max(1.0, np.abs(want).max())
    d = _per_position(got, want, scale)
    # the port's float32 forward of the same (bf16-valued) weights
    f32 = _port_logits(_port_model(_cfgs(FULL)[1], params), tokens)
    d32 = _per_position(f32, want, scale)
    assert np.median(d) <= BF16_MEDIAN, np.median(d)
    assert (d > BF16_POS).sum() <= BF16_MAX_FLIPS, np.sort(d)[-4:]
    assert np.median(d) < np.median(d32), (np.median(d), np.median(d32))


@pytest.mark.parametrize("sizes", [{"tp": 8}, {"ep": 4, "dp": 2},
                                   {"pp": 4, "tp": 2}],
                         ids=lambda s: "-".join(f"{k}{v}" for k, v in
                                                s.items()))
def test_validate_rejects_the_reference_bad_meshes(sizes):
    jcfg, tcfg = _cfgs(SMALL)
    with pytest.raises(AssertionError):
        jcfg.validate(jmesh.build_mesh(8, sizes=sizes))
    bad = tmesh.Mesh.of(sizes, "cpu")
    with pytest.raises(ValueError, match="%"):
        tcfg.validate(bad)
    with pytest.raises(ValueError, match="%"):
        ttfm.Transformer(tcfg, bad)


def test_validate_accepts_a_dividing_mesh():
    jcfg, tcfg = _cfgs(SMALL)
    sizes = {"dp": 2, "tp": 2, "pp": 2}
    jcfg.validate(jmesh.build_mesh(8, sizes=sizes))
    tcfg.validate(tmesh.Mesh.of(sizes, "cpu"))


# -- parameters ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_keeps_every_key_shape_dtype_and_bit(dtype):
    jcfg, tcfg = _cfgs(SMALL, dtype)
    params = {k: np.asarray(v) for k, v in _jax_params(jcfg).items()}
    sd = ttfm.from_jax(params)
    assert set(sd) == set(params) == set(ttfm.param_shapes(tcfg))
    for k, a in params.items():
        t = sd[k]
        assert tuple(t.shape) == a.shape == ttfm.param_shapes(tcfg)[k]
        assert t.dtype == getattr(torch, dtype)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    model = ttfm.Transformer(tcfg, build_mesh(1, device="cpu"))
    model.load_state_dict(sd)   # strict: the module's names are the same
    assert set(model.state_dict()) == set(params)


def test_init_params_shapes_scales_and_seed():
    tcfg = ttfm.TransformerConfig()
    p = ttfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.TransformerConfig())
    n = 0
    for k, a in jp.items():
        assert tuple(p[k].shape) == a.shape and p[k].dtype == torch.float32
        # sample stds: each within 3 of its standard errors, 1/sqrt(2 size)
        assert p[k].std().item() == pytest.approx(
            float(np.std(a)), rel=6 / np.sqrt(2 * a.size), abs=1e-6), k
        n += a.size
    assert n == 821_376
    again = ttfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    p16 = ttfm.init_params(dataclasses.replace(tcfg, dtype=torch.bfloat16),
                           torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p16[k], p[k].to(torch.bfloat16)) for k in p)


# -- the embedding gather -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_matches_jnp_take(dtype):
    table = np.random.default_rng(0).standard_normal((5, 3)).astype(
        np.float32)
    idx = np.array([[0, 4, 5, 6, -1, -5, -6, 2 ** 31 - 1, -2 ** 31, 3]],
                   np.int32)
    jt = jnp.asarray(table, getattr(jnp, dtype))
    want = np.asarray(jnp.take(jt, jnp.asarray(idx), axis=0), np.float32)
    got = ttfm._embed(torch.from_numpy(table).to(getattr(torch, dtype)),
                      torch.from_numpy(idx))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)   # NaN == NaN
    assert np.isnan(want[0, 2]).all() and not np.isnan(want[0, 4]).any()


@pytest.mark.parametrize("bad", [(256, -1), (300, 0), (2 ** 31 - 1, -256)],
                         ids=["vocab_and_-1", "300_and_0", "max_and_-256"])
def test_out_of_range_tokens_match_reference(bad):
    """Token ``bad[0]`` in row 1 and ``bad[1]`` in row 6: the NaN rows (the
    whole microbatch of a token outside the table, by the MoE's dense
    dispatch), the wrapped rows and every finite value equal the
    reference's."""
    jcfg, tcfg = _cfgs(FULL)
    params = _jax_params(jcfg)
    tokens = _tokens(jcfg.vocab, 8, 16, 5)
    tokens[1, 5], tokens[6, 2] = bad
    want = _ref_logits(jcfg, params, tokens)
    got = _port_logits(_port_model(tcfg, params), tokens)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[:4]).all()       # microbatch 0 holds row 1
    fin = ~np.isnan(want)
    assert fin[4:].any()
    assert np.abs(got[fin] - want[fin]).max() <= F32_TOL * max(
        1.0, np.abs(want[fin]).max())


# -- serving ------------------------------------------------------------------

def test_rows_do_not_depend_on_their_batch():
    """Capacity factor 2 with 2 experts gives every expert T slots: no token
    is dropped, so a row's logits depend on its own tokens alone."""
    _, tcfg = _cfgs({})
    model = ttfm.Transformer(tcfg, build_mesh(1, device="cpu"),
                             generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    row = rng.integers(0, 256, (1, 32)).astype(np.int32)
    alone = _port_logits(model, np.concatenate([row, row]))[0]
    for B in (2, 4, 8):
        for pos in (0, B - 1):
            batch = rng.integers(0, 256, (B, 32)).astype(np.int32)
            batch[pos] = row[0]
            got = _port_logits(model, batch)[pos]
            np.testing.assert_allclose(got, alone, rtol=0,
                                       atol=1e-6 * np.abs(alone).max())


def test_make_serve_fn_returns_logits_in_inference_mode():
    _, tcfg = _cfgs(SMALL)
    model = ttfm.Transformer(tcfg, build_mesh(1, device="cpu"))
    serve = ttfm.make_serve_fn(model)
    tokens = torch.from_numpy(_tokens(64, 2, 8, 0))
    out = serve({"tokens": tokens})
    assert set(out) == {"logits"} and out["logits"].is_inference()
    assert out["logits"].shape == (2, 8, 64)
    assert out["logits"].dtype == torch.float32
    with pytest.raises(ValueError, match="not divisible"):
        serve({"tokens": tokens[:1]})


class _Gated:
    """A serve function whose first call parks on a gate, so requests queue
    behind it in a known order; records each dispatched batch's rows."""

    def __init__(self, fn):
        self.fn = fn
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.rows = []

    def __call__(self, tree):
        if not self.entered.is_set():
            self.entered.set()
            self.gate.wait(WAIT)
        self.rows.append(int(tree["tokens"].shape[0]))
        return self.fn(tree)


def _wait_until(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


def _ordered(batcher, gated, warm, calls):
    """Run ``warm`` into the gate, queue ``calls`` (each a no-argument
    function that reaches ``batcher``) one by one, release; return their
    results."""
    out = [None] * len(calls)
    errors = []

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as exc:
            errors.append(exc)

    warm_t = threading.Thread(target=lambda: batcher(warm), daemon=True)
    warm_t.start()
    assert gated.entered.wait(WAIT)
    ts = []
    for i, fn in enumerate(calls):
        t = threading.Thread(target=run, args=(i, fn), daemon=True)
        t.start()
        ts.append(t)
        _wait_until(lambda: len(batcher._queue) == i + 1, f"request {i}")
    gated.gate.set()
    for t in [warm_t, *ts]:
        t.join(WAIT)
        assert not t.is_alive(), "caller stranded"
    assert not errors, errors
    return out


@pytest.fixture
def torch_on_cpu(monkeypatch):
    monkeypatch.setenv("TPURPC_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GRPC_PLATFORM_TYPE", "TCP")
    torch_config.set_config(None)
    yield
    torch_config.set_config(None)


def test_served_path_matches_reference_batcher(torch_on_cpu):
    """6 single-row requests queued in one order behind a gated warm-up, as
    batches of 4 and 2 (padded to 4): the reference's ``FanInBatcher`` over
    its jitted 1-device forward, called directly, and the port's
    ``FanInBatcher`` over ``make_serve_fn`` behind a ``Server``, called over
    loopback by ``TensorClient``s. Same batch composition, replies within
    1e-5, and each reply equal to its own tokens' row."""
    jcfg, tcfg = _cfgs(FULL)
    params = _jax_params(jcfg)
    rows = [_tokens(jcfg.vocab, 1, 32, 100 + i) for i in range(6)]
    warm = np.zeros((1, 32), np.int32)

    m1 = jmesh.build_mesh(1)
    fwd = jtfm.build_forward(jcfg, m1)
    jparams = jtfm.shard_params(params, jcfg, m1)
    jgated = _Gated(lambda t: {"logits": fwd(jparams,
                                             jnp.asarray(t["tokens"]))})
    jb = jsvc.FanInBatcher(jgated, max_batch=4, max_delay_s=0.005,
                           fixed_bucket=True)
    try:
        want = _ordered(jb, jgated, {"tokens": warm},
                        [lambda r=r: jb({"tokens": r}) for r in rows])
    finally:
        jb.close()

    model = _port_model(tcfg, params)
    tgated = _Gated(ttfm.make_serve_fn(model))
    tb = tsvc.FanInBatcher(tgated, max_batch=4, max_delay_s=0.005,
                           fixed_bucket=True, device="cpu")
    srv = Server(max_workers=16)
    tsvc.add_tensor_method(srv, "Generate", tb)
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")

    def call(r):
        with Channel(f"127.0.0.1:{port}") as ch:
            return tsvc.TensorClient(ch).call(
                "Generate", {"tokens": torch.from_numpy(r)}, timeout=WAIT)

    try:
        got = _ordered(tb, tgated, {"tokens": torch.from_numpy(warm)},
                       [lambda r=r: call(r) for r in rows])
    finally:
        srv.stop(grace=0)
        tb.close()
    assert jgated.rows == tgated.rows == [4, 4, 4]
    assert tb.rows_run == 7 and tb.batches_run == 3
    direct = _ref_logits(jcfg, params, np.concatenate(rows + rows[:2]))
    for i, (g, w) in enumerate(zip(got, want)):
        g = g["logits"].numpy()
        assert g.shape == (1, 32, 256)
        assert _rel(g, np.asarray(w["logits"])) <= F32_TOL
        assert _rel(g[0], direct[i]) <= F32_TOL


def test_transformer_without_a_card_raises(monkeypatch):
    """No device given and no TPURPC_TORCH_DEVICE=cpu: the port asks for
    the card, and where there is none it raises, never running on the CPU
    quietly."""
    monkeypatch.delenv("TPURPC_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    torch_config.set_config(None)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttfm.Transformer(ttfm.TransformerConfig(n_layers=1))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_mesh(1)
    finally:
        torch_config.set_config(None)
