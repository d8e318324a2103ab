"""The port's training half (``tpurpc_torch.models.transformer``: loss,
``value_and_grad``, ``build_train_step``), its sharding specs and its
one-process bring-up, against the reference's, on the CPU in one process.
(The multi-rank meshes are held in tests/test_torch_dist_*.py.)

The reference's ``init_params`` output goes across through ``from_jax``;
tokens are made from a seed with numpy. The reference runs its jitted
``shard_map`` programs on JAX's CPU devices, the port its one-rank mesh.

Tolerances:

* loss: 1e-5 relative, every step;
* gradients: 2e-6 of each parameter's largest |gradient| (the reference's
  own meshes agree within 1.1e-6 of it);
* parameters after AdamW steps: Adam divides each gradient entry by its
  running RMS, so a rounding difference in a gradient near 0 can move that
  entry's update by up to lr a step, while the rest agree to float32
  rounding. Readings, 10 steps at lr 3e-3 against the reference's
  1-device ``build_train_step``: SMALL, largest |Δ| 3.6e-6, median
  1.3e-7, no entry above 1e-5; the defaults' full width, largest 2.6e-4
  (``wv``, 0.0087 × lr × steps), median at most 3.0e-7, at most 9.2e-5 of
  a parameter's entries above 1e-5. Limits: the median 1e-6, the share
  above 1e-5 1e-3, and none above 2 × lr a step (an entry whose gradient
  rounds to the other sign in one package moves by lr one way there and
  lr the other here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpurpc.models import transformer as jtfm
from tpurpc.parallel import mesh as jmesh
from tpurpc.parallel import moe as jmoe
from tpurpc_torch.models import transformer as ttfm
from tpurpc_torch.parallel import build_mesh, collectives
from tpurpc_torch.parallel import distributed as tdist
from tpurpc_torch.parallel import mesh as tmesh
from tpurpc_torch.parallel import moe as tmoe
from tests import torch_ranks

LOSS_TOL = 1e-5
GRAD_TOL = 2e-6
LR = 3e-3
STEPS = 10
#: parameters after training (see above): the largest |Δ| per step taken,
#: in units of lr; the median |Δ|; the share of entries above PARAM_FAR
PARAM_STEP_SHARE = 2.0
PARAM_MEDIAN = 1e-6
PARAM_FAR, PARAM_FAR_SHARE = 1e-5, 1e-3
SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, d_ff=64,
             n_layers=2, n_experts=2, capacity_factor=16.0, n_micro=2)


def _cfgs(kw):
    return (jtfm.TransformerConfig(**kw, dtype=jnp.float32),
            ttfm.TransformerConfig(**kw, dtype=torch.float32))


def _data(vocab, B, S, seed):
    """tests/test_transformer.py's ``_data``: tokens, then targets."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


def _np_params(jcfg, seed):
    return {k: np.asarray(v) for k, v in
            jtfm.init_params(jax.random.PRNGKey(seed), jcfg).items()}


def _port_model(tcfg, params):
    model = ttfm.Transformer(tcfg, build_mesh(1, device="cpu"))
    model.load_state_dict(ttfm.from_jax(params))
    return model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_ranks.one_torch_thread():
        yield


# -- the loss and its gradient --------------------------------------------------

def _ref_value_and_grad(jcfg, params, tokens, targets):
    m = jmesh.build_mesh(1)
    loss_fn = jtfm.build_loss_fn(jcfg, m)
    p = jtfm.shard_params({k: jnp.asarray(v) for k, v in params.items()},
                          jcfg, m)
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(
        p, jnp.asarray(tokens), jnp.asarray(targets))
    return float(loss), {k: np.asarray(v) for k, v in g.items()}


def test_one_rank_loss_and_grads_match_reference_at_full_width():
    """``TransformerConfig()``'s full width, cut to 2 layers (the test
    config's case is in tests/test_torch_dist_transformer.py, beside the
    8-rank meshes that share its reference)."""
    B, S = 4, 32
    jcfg, tcfg = _cfgs({"n_layers": 2})
    params = _np_params(jcfg, 0)
    tokens, targets = _data(jcfg.vocab, B, S, 0)
    want_loss, want = _ref_value_and_grad(jcfg, params, tokens, targets)
    model = _port_model(tcfg, params)
    mesh = model.mesh
    loss = ttfm.value_and_grad(ttfm.build_loss_fn(tcfg, mesh), model,
                               torch.from_numpy(tokens),
                               torch.from_numpy(targets))
    assert loss.shape == () and loss.dtype == torch.float32
    assert float(loss) == pytest.approx(want_loss, rel=LOSS_TOL)
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name]
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), name


def test_loss_is_mean_nll_of_the_logits():
    jcfg, tcfg = _cfgs(SMALL)
    params = _np_params(jcfg, 2)
    tokens, targets = _data(jcfg.vocab, 4, 8, 2)
    model = _port_model(tcfg, params)
    with torch.no_grad():
        logits = ttfm.build_forward(tcfg, model.mesh)(
            model, torch.from_numpy(tokens)).double().numpy()
        loss = ttfm.build_loss_fn(tcfg, model.mesh)(
            model, torch.from_numpy(tokens), torch.from_numpy(targets))
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + \
        logits.max(-1)
    nll = lse - np.take_along_axis(logits, targets[..., None], -1)[..., 0]
    assert float(loss) == pytest.approx(nll.mean(), rel=LOSS_TOL)


# -- training -----------------------------------------------------------------

def test_train_step_optimizer_is_optax_adamw():
    mesh = build_mesh(1, device="cpu")
    model = ttfm.Transformer(ttfm.TransformerConfig(**SMALL), mesh)
    _, make_optimizer = ttfm.build_train_step(model.cfg, mesh, lr=LR)
    opt = make_optimizer(model)
    assert isinstance(opt, torch.optim.AdamW)
    (group,) = opt.param_groups
    assert group["lr"] == LR and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["weight_decay"] == 1e-4
    assert len(group["params"]) == len(list(model.parameters())) == 11
    assert all(p.requires_grad for p in model.parameters())


def test_serving_stays_in_inference_mode():
    model = ttfm.Transformer(ttfm.TransformerConfig(**SMALL),
                             build_mesh(1, device="cpu"))
    out = ttfm.make_serve_fn(model)({"tokens": torch.zeros(2, 8, dtype=int)})
    assert out["logits"].is_inference() and not out["logits"].requires_grad


# -- the router gate's tie ----------------------------------------------------

def test_router_tie_gradient_matches_reference():
    """A zero router ties both experts for every token. ``probs.amax``
    splits the gate's gradient between them as ``jnp.max`` does, and
    through the softmax at [0.5, 0.5] the halves cancel: the router's
    gradient is 0, the reference's answer. ``torch.max(dim)`` would give
    all of it to one expert, and the router a gradient."""
    rng = np.random.default_rng(5)
    d, f, E, T = 8, 16, 2, 16
    router = np.zeros((d, E), np.float32)
    w_in = rng.standard_normal((E, d, f)).astype(np.float32) * d ** -0.5
    w_out = rng.standard_normal((E, f, d)).astype(np.float32) * f ** -0.5
    x = rng.standard_normal((T, d)).astype(np.float32)
    cot = rng.standard_normal((T, d)).astype(np.float32)

    jm = jmesh.build_mesh(1)

    def jloss(r):
        fn = jmesh.shard_map(
            lambda p, x: jmoe.moe_block(p, x, "ep", 2.0)[0], mesh=jm,
            in_specs=(jmoe.MoEParams(P(), P(), P()), P()), out_specs=P())
        y = fn(jmoe.MoEParams(r, jnp.asarray(w_in), jnp.asarray(w_out)),
               jnp.asarray(x))
        return jnp.sum(y * cot)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(router)))
    r = torch.from_numpy(router).requires_grad_(True)
    y, _ = tmoe.moe_block(tmoe.MoEParams(r, torch.from_numpy(w_in),
                                         torch.from_numpy(w_out)),
                          torch.from_numpy(x), build_mesh(1, device="cpu"))
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(r.grad.numpy(), want, rtol=0, atol=1e-7)
    assert np.abs(want).max() <= 1e-7
    # the gate by torch.max(dim) at the same tie: a gradient
    logits = torch.zeros(T, E, requires_grad=True)
    gate = torch.softmax(logits, -1).max(-1).values
    (gate * torch.arange(1.0, T + 1)).sum().backward()
    assert logits.grad.abs().max() > 0.1


# -- specs and the rank-to-coordinate map ---------------------------------------

def test_param_specs_and_data_spec_match_reference():
    jcfg, tcfg = _cfgs(SMALL)
    want = jtfm.param_specs(jcfg)
    got = ttfm.param_specs(tcfg)
    assert set(got) == set(want)
    for k, spec in want.items():
        assert got[k] == tuple(spec), k
    assert ttfm.DATA_SPEC == tuple(jtfm.DATA_SPEC)


MESHES = [{"dp": 2, "pp": 2, "tp": 2}, {"sp": 2, "tp": 2, "ep": 2},
          {"dp": 2, "ep": 4}, {"pp": 4, "sp": 2}]


@pytest.mark.parametrize("sizes", MESHES,
                         ids=lambda s: "-".join(f"{k}{v}" for k, v in
                                                s.items()))
def test_shard_gives_rank_r_what_reference_device_r_holds(sizes):
    """Rank r's coordinates are reference device r's (row-major in AXES),
    so ``shard`` picks the block ``NamedSharding`` puts on device r: for
    every parameter spec and the tokens' ``DATA_SPEC``."""
    jcfg, tcfg = _cfgs(dict(SMALL, n_heads=8, n_layers=4, n_experts=4))
    params = _np_params(jcfg, 0)
    tokens = np.arange(16 * 8, dtype=np.int32).reshape(16, 8)
    jm = jmesh.build_mesh(8, sizes=sizes)
    devices = list(jm.devices.flat)
    cases = [(params[k], jtfm.param_specs(jcfg)[k],
              ttfm.param_specs(tcfg)[k]) for k in params]
    cases.append((tokens, jtfm.DATA_SPEC, ttfm.DATA_SPEC))
    for a, jspec, tspec in cases:
        arr = jax.device_put(jnp.asarray(a), NamedSharding(jm, jspec))
        blocks = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for rank in range(8):
            mesh = tmesh.Mesh(tmesh.Mesh.of(sizes, "cpu").shape,
                              torch.device("cpu"), rank)
            assert [mesh.coords[ax] for ax in tmesh.AXES] == [
                int(c) for c in np.argwhere(jm.devices == devices[rank])[0]]
            got = tmesh.shard(mesh, torch.from_numpy(a.copy()), *tspec)
            np.testing.assert_array_equal(got.numpy(), blocks[devices[rank]])


def test_shard_rejects_an_uneven_split():
    mesh = tmesh.Mesh((1, 1, 3, 1, 1), torch.device("cpu"), 1)
    with pytest.raises(ValueError, match="does not split 3 ways"):
        tmesh.shard(mesh, torch.zeros(4, 8), None, "sp")
    assert tmesh.replicated(mesh, torch.zeros(4, 8)).shape == (4, 8)


# -- one-process bring-up -----------------------------------------------------

def test_distributed_single_process_bringup(monkeypatch):
    """tests/test_parallel.py:226 for the port: with no TPURPC_* variables,
    initialize_cluster is a no-op (twice), the process is the whole
    cluster, and global_mesh is a one-rank mesh whose every collective is
    the identity."""
    for var in ("TPURPC_COORDINATOR", "TPURPC_NUM_PROCESSES",
                "TPURPC_PROCESS_ID", "TPURPC_AUTODETECT"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize_cluster() == 0
    assert tdist.initialize_cluster() == 0
    assert tdist.process_count() == 1
    assert not torch.distributed.is_initialized()
    mesh, sizes = tdist.global_mesh(device="cpu")
    assert int(np.prod(list(sizes.values()))) == 1 == mesh.size
    assert tuple(mesh.axis_names) == ("dp", "pp", "sp", "tp", "ep")
    x = torch.ones(8, 4)
    s = x
    for ax in mesh.axis_names:
        s = collectives.psum(s, mesh, ax)
    assert torch.equal(s, x)
    assert collectives.pmean(x, mesh, ("dp", "ep", "sp")) is x


@pytest.mark.parametrize("value", ["bogus", "mpi"])
def test_initialize_cluster_refuses_a_cpu_backend_it_lacks(monkeypatch,
                                                          value):
    if value == "mpi" and torch.distributed.is_mpi_available():
        value = "nccl"        # not a CPU backend either way
    monkeypatch.setenv("TPURPC_CPU_COLLECTIVES", value)
    with pytest.raises(ValueError, match="TPURPC_CPU_COLLECTIVES"):
        tdist.initialize_cluster("127.0.0.1:1", 2, 0)
    assert not torch.distributed.is_initialized()


def test_initialize_cluster_needs_all_three_settings(monkeypatch):
    for var in ("TPURPC_NUM_PROCESSES", "TPURPC_PROCESS_ID",
                "TPURPC_AUTODETECT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="process id"):
        tdist.initialize_cluster("127.0.0.1:1", 2)
    assert not torch.distributed.is_initialized()


def test_validate_rejects_mesh_before_any_collective():
    jcfg, tcfg = _cfgs(SMALL)
    bad = tmesh.Mesh.of({"tp": 8}, "cpu")
    for build in (ttfm.build_loss_fn, ttfm.build_forward,
                  ttfm.build_train_step):
        with pytest.raises(ValueError, match="heads % tp"):
            build(tcfg, bad)
    with pytest.raises(AssertionError):
        jtfm.build_loss_fn(jcfg, jmesh.build_mesh(8, sizes={"tp": 8}))


def test_from_jax_with_a_mesh_gives_this_ranks_shards():
    jcfg, tcfg = _cfgs(SMALL)
    params = _np_params(jcfg, 0)
    mesh = tmesh.Mesh(tmesh.Mesh.of({"pp": 2, "tp": 2, "dp": 2}, "cpu").shape,
                      torch.device("cpu"), 7)
    sd = ttfm.from_jax(params, mesh)
    assert sd["wq"].shape == (1, 32, 2, 8)          # [L/pp, d, H/tp, Dh]
    np.testing.assert_array_equal(sd["wq"].numpy(), params["wq"][1:, :, 2:])
    np.testing.assert_array_equal(sd["embed"].numpy(), params["embed"])
    assert dataclasses.is_dataclass(mesh) and mesh.coords == {
        "dp": 1, "pp": 1, "sp": 0, "tp": 1, "ep": 0}
