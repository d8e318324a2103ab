"""The port's MoE transformer and its training on 8-rank meshes: gloo
processes on the CPU (``tests/torch_ranks.py``), against the reference on
conftest's 8 CPU devices. tests/test_transformer.py:33, :44 and :58 and
``__graft_entry__.dryrun_multichip(8)`` for the port.

One launch of 8 ranks runs: the loss, its gradient and the logits on the
four factorizations of tests/test_transformer.py (every axis 2-way in at
least one), from the reference's ``init_params(PRNGKey(0))`` on that
test's ``_data()``; 10 AdamW steps at lr 3e-3 on {'dp': 2, 'pp': 2,
'tp': 2} from ``init_params(PRNGKey(1))`` on ``_data(seed=3)``'s tokens
with next-token targets; one step of each of the dryrun's two meshes with
its configs, batches and lr 1e-3; and ring attention over an 8-rank 'sp'.
The weights cross by ``from_jax(params, mesh)``. While the ranks run, this
process computes the reference's values on one device (its values do not
depend on the factorization) and runs the same loss, gradient and 10 steps
on the port's one-rank mesh.

Tolerances: losses 1e-5 relative; every parameter's gradient, gathered
from its shards, within 2e-6 of the largest entry of the reference's
1-device gradient (the reference's own meshes agree within 1.1e-6 of it;
readings here at most 1.10e-6, ``router``); logits (each rank's
``DATA_SPEC`` block, gathered) within 1e-5 of max(1, max |logit|). The
parameters after training, by tests/test_torch_train.py's rule (Adam can
turn a rounding difference in a gradient near 0 into up to lr a step in
that entry): the median |Δ| of each parameter under 1e-6, at most 1e-3 of
its entries above 1e-5, none above 2 × lr a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from tests import torch_ranks
from tests.test_torch_train import (PARAM_FAR, PARAM_FAR_SHARE, PARAM_MEDIAN,
                                    PARAM_STEP_SHARE)
from tpurpc.models import transformer as jtfm
from tpurpc.parallel import mesh as jmesh
from tpurpc.parallel import ring_attention as jring
from tpurpc_torch.models import transformer as ttfm
from tpurpc_torch.parallel import build_mesh

LOSS_TOL = 1e-5
GRAD_TOL = 2e-6
F32_TOL = 1e-5
WORLD = 8
LR, STEPS = 3e-3, 10
CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, d_ff=64,
           n_layers=2, n_experts=2, capacity_factor=16.0, n_micro=2)
MESHES = [{"dp": 2, "pp": 2, "sp": 2}, {"sp": 2, "tp": 2, "ep": 2},
          {"dp": 2, "tp": 2, "pp": 2}, {"ep": 2, "pp": 2, "dp": 2}]
TRAIN_MESH = {"dp": 2, "pp": 2, "tp": 2}
#: dryrun_multichip(8)'s two factorizations and the losses MULTICHIP_r05.json
#: recorded for them (printed to 4 decimals)
DRYRUN = [(("pp", "sp", "tp", "ep", "dp"), 4.4310),
          (("dp", "ep", "tp", "pp", "sp"), 4.6904)]
PARAMS = ("embed", "ln_f", "ln1", "ln2", "wq", "wk", "wv", "wo", "router",
          "w_in", "w_out")


def _name(sizes):
    return "-".join(f"{k}{v}" for k, v in sizes.items())


def _np_params(jcfg, seed):
    return {k: np.asarray(v) for k, v in
            jtfm.init_params(jax.random.PRNGKey(seed), jcfg).items()}


def _dryrun_case(prio):
    """The dryrun's mesh, config and batch for one priority order."""
    sizes = jmesh.factor_mesh(WORLD, priority=prio,
                              caps={ax: 2 for ax in prio if ax != prio[-1]})
    jcfg = graft._mesh_compatible_config(sizes)
    B = sizes["dp"] * sizes["ep"] * jcfg.n_micro * 2
    S = sizes["sp"] * 8
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S)).astype(
        np.int32)
    return sizes, jcfg, tokens, np.roll(tokens, -1, axis=1)


class _Case:
    """One job's description and inputs, and the reference's config."""

    def __init__(self, job, jcfg, params, tokens, targets):
        self.job, self.jcfg, self.params = job, jcfg, params
        self.tokens, self.targets = tokens, targets

    def inputs(self):
        name = self.job["name"]
        out = {f"{name}/param/{k}": v for k, v in self.params.items()}
        out.update({f"{name}/tokens": self.tokens,
                    f"{name}/targets": self.targets})
        return out


def _cases():
    jcfg = jtfm.TransformerConfig(**CFG)
    rng = np.random.default_rng(0)         # the test's _data()
    tokens = rng.integers(0, CFG["vocab"], (8, 16)).astype(np.int32)
    targets = rng.integers(0, CFG["vocab"], (8, 16)).astype(np.int32)
    params0 = _np_params(jcfg, 0)
    cases = [_Case({"name": f"tf-{_name(sizes)}", "kind": "transformer",
                    "sizes": sizes, "cfg": CFG}, jcfg, params0, tokens,
                   targets) for sizes in MESHES]
    tok3 = np.random.default_rng(3).integers(0, CFG["vocab"], (8, 16)).astype(
        np.int32)                          # _data(seed=3)'s tokens
    cases.append(_Case({"name": "train", "kind": "train",
                        "sizes": TRAIN_MESH, "cfg": CFG, "lr": LR,
                        "steps": STEPS}, jcfg, _np_params(jcfg, 1), tok3,
                       np.roll(tok3, -1, axis=1)))
    for i, (prio, _) in enumerate(DRYRUN):
        sizes, dcfg, dtok, dtgt = _dryrun_case(prio)
        kw = {f: getattr(dcfg, f) for f in CFG}
        cases.append(_Case({"name": f"dryrun{i}", "kind": "train",
                            "sizes": sizes, "cfg": kw, "lr": 1e-3,
                            "steps": 1}, dcfg, _np_params(dcfg, 0), dtok,
                           dtgt))
    return cases


def _ring_inputs():
    rng = np.random.default_rng(8)
    return [rng.standard_normal((1, 2, 64, 8)).astype(np.float32)
            for _ in range(3)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the 8 ranks, computes the reference's values (and the port's
    one-rank runs) while they run, then collects both."""
    cases = _cases()
    qkv = _ring_inputs()
    jobs = [c.job for c in cases]
    jobs.append({"name": "ring-sp8", "kind": "ring_attention",
                 "sizes": {"sp": WORLD}, "causal": True})
    inputs = {k: v for c in cases for k, v in c.inputs().items()}
    inputs.update({f"ring-sp8/{n}": a for n, a in zip("qkv", qkv)})
    workdir = tmp_path_factory.mktemp("tf8")
    procs = torch_ranks.start(WORLD, jobs, inputs, workdir)
    try:
        with torch_ranks.one_torch_thread():
            ref = _reference(cases, qkv)
    finally:
        torch_ranks.finish(procs)
    return torch_ranks.collect(workdir, jobs, WORLD), ref


def _reference(cases, qkv):
    m1 = jmesh.build_mesh(1)

    def put(c, params=None):
        return jtfm.shard_params({k: jnp.asarray(v) for k, v in
                                  (params or c.params).items()}, c.jcfg, m1)

    fwd, train, *dry = cases[0], cases[len(MESHES)], *cases[len(MESHES) + 1:]
    tok, tgt = jnp.asarray(fwd.tokens), jnp.asarray(fwd.targets)
    loss1, grads = jax.jit(jax.value_and_grad(jtfm.build_loss_fn(
        fwd.jcfg, m1)))(put(fwd), tok, tgt)
    ref = {"loss1": float(loss1),
           "grads": {k: np.asarray(v) for k, v in grads.items()},
           "logits1": np.asarray(jtfm.build_forward(fwd.jcfg, m1)(
               put(fwd), tok))}
    # the reference's 1-device build_train_step
    step, opt = jtfm.build_train_step(train.jcfg, m1, lr=LR)
    p = put(train)
    state = opt.init(p)
    losses = []
    for _ in range(STEPS):
        p, state, loss = step(p, state, jnp.asarray(train.tokens),
                              jnp.asarray(train.targets))
        losses.append(float(loss))
    ref["train"] = (np.array(losses), {k: np.asarray(v) for k, v in
                                       p.items()})
    # a train step returns the loss before its update: the loss fn's
    ref["dryrun"] = [float(jax.jit(jtfm.build_loss_fn(c.jcfg, m1))(
        put(c), jnp.asarray(c.tokens), jnp.asarray(c.targets))) for c in dry]
    q, k, v = (jnp.asarray(a) for a in qkv)
    m = jmesh.build_mesh(WORLD, sizes={"sp": WORLD})
    (_, ref["ring"]), ref["ring_grads"] = jax.jit(jax.value_and_grad(
        lambda q, k, v: (lambda o: (jnp.sum(o ** 2), o))(
            jring.ring_attention(q, k, v, m, causal=True)),
        argnums=(0, 1, 2), has_aux=True))(q, k, v)
    ref["one_rank"] = _one_rank(fwd, train)
    return ref


def _one_rank(fwd, train):
    """The port on its one-rank mesh: the loss and gradient, and the 10
    steps."""
    mesh = build_mesh(1, device="cpu")
    tcfg = ttfm.TransformerConfig(**CFG)
    out = {}
    model = ttfm.Transformer(tcfg, mesh)
    model.load_state_dict(ttfm.from_jax(fwd.params))
    out["loss"] = float(ttfm.value_and_grad(
        ttfm.build_loss_fn(tcfg, mesh), model,
        torch.from_numpy(fwd.tokens), torch.from_numpy(fwd.targets)))
    out["grads"] = {k: v.grad.numpy().copy()
                    for k, v in model.named_parameters()}
    model = ttfm.Transformer(tcfg, mesh)
    model.load_state_dict(ttfm.from_jax(train.params))
    step, make_optimizer = ttfm.build_train_step(tcfg, mesh, lr=LR)
    opt = make_optimizer(model)
    out["losses"] = np.array([float(step(
        model, opt, torch.from_numpy(train.tokens),
        torch.from_numpy(train.targets))) for _ in range(STEPS)])
    out["params"] = {k: v.detach().numpy().copy()
                     for k, v in model.named_parameters()}
    return out


def _check_params(got, want):
    d = np.abs(got - want)
    assert d.max() <= PARAM_STEP_SHARE * LR * STEPS, d.max()
    assert np.median(d) <= PARAM_MEDIAN, np.median(d)
    assert (d > PARAM_FAR).mean() <= PARAM_FAR_SHARE, (d > PARAM_FAR).mean()


# -- the loss, its gradient and the logits ------------------------------------

@pytest.mark.parametrize("sizes", MESHES, ids=_name)
def test_loss_matches_reference_on_8_ranks(ranks, sizes):
    out, ref = ranks
    for r in out[f"tf-{_name(sizes)}"]:
        assert float(r["loss"]) == pytest.approx(ref["loss1"], rel=LOSS_TOL)


@pytest.mark.parametrize("name", PARAMS)
@pytest.mark.parametrize("sizes", MESHES, ids=_name)
def test_gathered_grad_matches_one_device_grad(ranks, sizes, name):
    """The sharded gradient, gathered from the ranks' shards (ranks that
    hold the same shard hold equal values), is the reference's 1-device
    gradient. ``embed`` takes the gather's part on 'pp' stage 0 and the
    logits' part on every stage, each counted once."""
    out, ref = ranks
    want = ref["grads"][name]
    spec = ttfm.param_specs(ttfm.TransformerConfig(**CFG))[name]
    got = torch_ranks.gather([r[f"grad/{name}"] for r in
                              out[f"tf-{_name(sizes)}"]], spec, sizes,
                             want.shape, WORLD)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= GRAD_TOL, err


def test_one_rank_loss_and_grads_match_reference(ranks):
    _, ref = ranks
    got = ref["one_rank"]
    assert got["loss"] == pytest.approx(ref["loss1"], rel=LOSS_TOL)
    for name, want in ref["grads"].items():
        g = got["grads"][name]
        assert np.abs(g - want).max() <= GRAD_TOL * np.abs(want).max(), name


@pytest.mark.parametrize("sizes", MESHES, ids=_name)
def test_logits_come_back_in_data_spec_layout(ranks, sizes):
    """``build_forward`` on 8 ranks: each rank's block is the reference's
    1-device logits at its ``DATA_SPEC`` index (tests/test_transformer.py:44
    holds the reference's sp2-tp2-ep2 mesh to the same)."""
    out, ref = ranks
    want = ref["logits1"]
    got = torch_ranks.gather([r["logits"] for r in
                              out[f"tf-{_name(sizes)}"]],
                             ttfm.DATA_SPEC, sizes, want.shape, WORLD)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale <= F32_TOL


def test_ring_attention_on_8_ranks(ranks):
    out, ref = ranks
    res = out["ring-sp8"]
    spec = (None, None, "sp")
    want = np.asarray(ref["ring"])
    got = torch_ranks.gather([r["out"] for r in res], spec, {"sp": WORLD},
                             want.shape, WORLD)
    assert np.abs(got - want).max() <= F32_TOL * max(1.0, np.abs(want).max())
    for name, g in zip(("dq", "dk", "dv"), ref["ring_grads"]):
        g = np.asarray(g)
        gg = torch_ranks.gather([r[name] for r in res], spec, {"sp": WORLD},
                                g.shape, WORLD)
        assert np.abs(gg - g).max() <= GRAD_TOL * np.abs(g).max(), name


# -- training -----------------------------------------------------------------

def test_train_losses_follow_reference_and_fall(ranks):
    out, ref = ranks
    want, _ = ref["train"]
    for r in out["train"]:
        np.testing.assert_allclose(r["losses"], want, rtol=LOSS_TOL)
        assert r["losses"][-1] < 0.8 * r["losses"][0], r["losses"]


@pytest.mark.parametrize("name", PARAMS)
def test_trained_params_follow_reference(ranks, name):
    out, ref = ranks
    want = ref["train"][1][name]
    got = torch_ranks.gather([r[f"param/{name}"] for r in out["train"]],
                             ttfm.param_specs(None)[name], TRAIN_MESH,
                             want.shape, WORLD)
    _check_params(got, want)


def test_train_keeps_each_ranks_shards(ranks):
    """As the reference's sharded step keeps ``wq`` sharded, each rank keeps
    its shard shape [L/pp, d, H/tp, Dh] through 10 steps, and so for every
    parameter its spec gives."""
    out, _ = ranks
    specs = ttfm.param_specs(None)
    shapes = ttfm.param_shapes(ttfm.TransformerConfig(**CFG))
    for r in out["train"]:
        assert r["param/wq"].shape == (1, 32, 2, 8)
        for name in PARAMS:
            want = tuple(n // (TRAIN_MESH.get(e, 1) if e else 1)
                         for n, e in zip(shapes[name], specs[name]))
            assert r[f"param/{name}"].shape == want, name


def test_one_rank_train_step_matches_reference(ranks):
    """tests/test_transformer.py:58's run on the port's one-rank mesh,
    against the reference's 1-device ``build_train_step`` step by step."""
    _, ref = ranks
    want_losses, want = ref["train"]
    got = ref["one_rank"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_TOL)
    assert got["losses"][-1] < 0.8 * got["losses"][0]
    for name in PARAMS:
        _check_params(got["params"][name], want[name])


@pytest.mark.parametrize("case", range(len(DRYRUN)),
                         ids=["pp2-sp2-tp2", "dp2-tp2-ep2"])
def test_dryrun_multichip_losses(ranks, case):
    """One train step on each of the dryrun's meshes gives the reference's
    live loss, and the one MULTICHIP_r05.json recorded to 4 decimals."""
    out, ref = ranks
    _, recorded = DRYRUN[case]
    for r in out[f"dryrun{case}"]:
        loss = float(r["losses"][0])
        assert loss == pytest.approx(ref["dryrun"][case], rel=LOSS_TOL)
        assert round(loss, 4) == recorded
