"""The port's collectives and parallel modules on meshes of 2 and 4 ranks:
gloo processes on the CPU (``tests/torch_ranks.py``), against the
reference's ``shard_map`` programs on conftest's 8 CPU devices.

Each world size is one launch of its ranks, which runs every job of that
size; each test reads one job's outputs. Inputs are made from seeds with
numpy in this process and handed to the ranks. A rank holds its block of
each sharded output and gradient; the test lays the blocks out by the
ranks' mesh coordinates and holds them against the reference's arrays.

Tolerances, of max(1, the reference's largest |value|): forwards 1e-5;
gradients 2e-6 of the reference gradient's largest entry (the reference's
own meshes agree within 1.1e-6 of it). The collectives against their
definitions in numpy: 1e-6. (On 8 ranks the modules run inside the
transformer's four factorizations, and ring attention over an 8-rank
'sp', in tests/test_torch_dist_transformer.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tests import torch_ranks
from tpurpc.parallel import mesh as jmesh
from tpurpc.parallel import moe as jmoe
from tpurpc.parallel import pipeline as jpipe
from tpurpc.parallel import ring_attention as jring

F32_TOL = 1e-5
GRAD_TOL = 2e-6
EXACT_TOL = 1e-6


def _name(sizes):
    return "-".join(f"{k}{v}" for k, v in sizes.items())


# Each job is (its description, a function making its inputs): the
# inputs are made when a world's ranks start, not when the module is
# collected.

def _ring_job(sizes, causal):
    def inputs():
        rng = np.random.default_rng(10 + sum(sizes.values()) + causal)
        return dict(zip("qkv", (rng.standard_normal((2, 3, 32, 8)).astype(
            np.float32) for _ in range(3))))

    return ({"name": f"ring-{_name(sizes)}-{'causal' if causal else 'full'}",
             "kind": "ring_attention", "sizes": sizes, "causal": causal},
            inputs)


def _moe_job(ep, drop=False):
    """tests/test_parallel.py:110 (no drops: capacity factor E) and :138
    (a router biased to expert 0, capacity factor 0.5: one kept row a
    shard), with a seeded cotangent for the gradients."""
    d, f, T, cf = (4, 8, 4, 0.5) if drop else (8, 16, 16, float(ep))

    def inputs():
        rng = np.random.default_rng(20 + ep + drop)
        p = jmoe.init_moe(jax.random.PRNGKey(int(drop)), d, f, ep)
        if drop:
            router = np.array([[9.0, -9.0] + [-9.0] * (ep - 2)] * d,
                              np.float32)
            x = np.ones((ep * T, d), np.float32)
        else:
            router = np.asarray(p.router)
            x = rng.standard_normal((ep * T, d)).astype(np.float32)
        return {"router": router, "w_in": np.asarray(p.w_in),
                "w_out": np.asarray(p.w_out), "x": x,
                "cot": rng.standard_normal(x.shape).astype(np.float32)}

    return ({"name": f"moe-ep{ep}{'-drop' if drop else ''}", "kind": "moe",
             "sizes": {"ep": ep}, "capacity_factor": cf}, inputs)


def _pipe_job(sizes, n_micro):
    """tests/test_parallel.py:161's stages (two tanh layers a stage, with
    biases), B 8, d 6."""
    pp = sizes["pp"]

    def inputs():
        rng = np.random.default_rng(30 + pp + n_micro)
        return {"W": (rng.standard_normal((2 * pp, 6, 6)) * 0.3).astype(
                    np.float32),
                "b": (rng.standard_normal((2 * pp, 6)) * 0.1).astype(
                    np.float32),
                "x": rng.standard_normal((8, 6)).astype(np.float32)}

    return ({"name": f"pipe-{_name(sizes)}-m{n_micro}", "kind": "pipeline",
             "sizes": sizes, "n_micro": n_micro}, inputs)


JOBS = {
    2: [({"name": "coll-dp2", "kind": "collectives", "sizes": {"dp": 2},
          "axes": ["dp", "tp", ["dp", "sp"]]}, dict),
        ({"name": "cluster", "kind": "cluster", "sizes": {"dp": 2}}, dict),
        _ring_job({"sp": 2}, True),
        _moe_job(2), _moe_job(2, drop=True),
        _pipe_job({"pp": 2}, 4)],
    4: [({"name": "coll-dp2-tp2", "kind": "collectives",
          "sizes": {"dp": 2, "tp": 2}, "axes": ["dp", "tp", ["dp", "tp"]]},
         dict),
        _ring_job({"sp": 4}, True), _ring_job({"sp": 4}, False),
        _ring_job({"sp": 2, "tp": 2}, True),
        _moe_job(4),
        _pipe_job({"pp": 4}, 4), _pipe_job({"pp": 2, "dp": 2}, 2)],
}


def _jobs(kind):
    return [pytest.param(w, j, id=j["name"]) for w, jobs in JOBS.items()
            for j, _ in jobs if j["kind"] == kind]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_ranks.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(world)``: every job of that world, run once. The 2-rank
    launch joins by torchrun's variables (``TPURPC_AUTODETECT=1``), the
    others by ``TPURPC_COORDINATOR``."""
    done = {}

    def get(world):
        if world not in done:
            jobs = [j for j, _ in JOBS[world]]
            made = {j["name"]: make() for j, make in JOBS[world]}
            inputs = {f"{name}/{k}": v for name, inp in made.items()
                      for k, v in inp.items()}
            done[world] = (torch_ranks.launch(
                world, jobs, inputs, tmp_path_factory.mktemp(f"w{world}"),
                autodetect=world == 2), made)
        return done[world]

    return get


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _grad_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- collectives ----------------------------------------------------------------

@pytest.mark.parametrize("world,job", _jobs("collectives"))
def test_collectives_match_their_definitions(ranks, world, job):
    """psum, pmean, all_to_all (split = concat = axis 0), shift (+1) and
    axis_index on every axis of the job, with their gradients: psum's and
    pmean's transpose is a psum (pmean's over n), all_to_all's is
    all_to_all, shift's is the shift by -1. An axis of size 1 is the
    identity."""
    out, _ = ranks(world)
    res = out[job["name"]]
    sizes = job["sizes"]
    coords = torch_ranks.coords(sizes, world)
    for r in range(world):
        assert res[r]["rank"] == r
        assert list(res[r]["coords"]) == [coords[r][a] for a in
                                          ("dp", "pp", "sp", "tp", "ep")]
    for axis in job["axes"]:
        names = [axis] if isinstance(axis, str) else axis
        key = "+".join(names)
        n = int(np.prod([sizes.get(a, 1) for a in names]))
        for r in range(world):
            # this rank's group: the ranks that agree off ``names``
            grp = [q for q in range(world) if all(
                coords[q][a] == coords[r][a] for a in coords[r]
                if a not in names)]
            idx = sum(coords[r][a] * int(np.prod(
                [sizes.get(b, 1) for b in names[i + 1:]]))
                for i, a in enumerate(names))
            assert res[r][f"axis_index/{key}"] == idx
            xs = np.stack([res[q]["x"] for q in grp])
            ws = np.stack([res[q]["w"] for q in grp])
            me = grp.index(r)
            want = {"psum": (xs.sum(0), ws.sum(0)),
                    "pmean": (xs.mean(0), ws.sum(0) / n)}
            if isinstance(axis, str):
                blk = xs.shape[1] // n
                want["all_to_all"] = tuple(
                    np.concatenate([a[q, me * blk:(me + 1) * blk]
                                    for q in range(n)]) for a in (xs, ws))
                want["shift"] = (xs[(me - 1) % n], ws[(me + 1) % n])
            for op, (y, g) in want.items():
                np.testing.assert_allclose(res[r][f"{op}/{key}/y"], y,
                                           rtol=0, atol=EXACT_TOL)
                np.testing.assert_allclose(res[r][f"{op}/{key}/g"], g,
                                           rtol=0, atol=EXACT_TOL)


def test_cluster_sum_matmul_and_psum(ranks):
    """tests/test_distributed.py:107 on two processes: the cross-rank sum
    of arange(8) is 28, a 'dp'-split matmul gives each rank its rows of
    X @ W, and a psum over 'dp' of [0..3] and [4..7] is [4, 6, 8, 10]."""
    out, _ = ranks(2)
    rng = np.random.default_rng(7)
    X = rng.standard_normal((8, 16)).astype(np.float32)
    W = rng.standard_normal((16, 4)).astype(np.float32)
    for r, res in enumerate(out["cluster"]):
        assert float(res["total"]) == 28.0
        np.testing.assert_allclose(res["y"], X[4 * r:4 * (r + 1)] @ W,
                                   rtol=1e-5)
        np.testing.assert_allclose(res["red"], [4.0, 6.0, 8.0, 10.0],
                                   rtol=1e-6)


# -- ring attention -------------------------------------------------------------

@pytest.mark.parametrize("world,job", _jobs("ring_attention"))
def test_ring_attention_forward_and_grads_match_reference(ranks, world,
                                                          job):
    out, inputs = ranks(world)
    inp = inputs[job["name"]]
    sp = job["sizes"]["sp"]
    jm = jmesh.build_mesh(sp, sizes={"sp": sp})
    q, k, v = (jnp.asarray(inp[n]) for n in "qkv")

    def loss(q, k, v):
        o = jring.ring_attention(q, k, v, jm, causal=job["causal"])
        return jnp.sum(o ** 2), o

    (_, want), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    want = np.asarray(want)
    res = out[job["name"]]
    spec = (None, None, "sp")
    got = torch_ranks.gather([r["out"] for r in res], spec, job["sizes"],
                             want.shape, world)
    assert _rel(got, want) <= F32_TOL
    for name, g in zip(("dq", "dk", "dv"), grads):
        gg = torch_ranks.gather([r[name] for r in res], spec, job["sizes"],
                                g.shape, world)
        assert _grad_err(gg, np.asarray(g)) <= GRAD_TOL, name


# -- MoE ------------------------------------------------------------------------

@pytest.mark.parametrize("world,job", _jobs("moe"))
def test_moe_forward_and_grads_match_reference(ranks, world, job):
    out, inputs = ranks(world)
    inp = inputs[job["name"]]
    ep = job["sizes"]["ep"]
    jm = jmesh.build_mesh(ep, sizes={"ep": ep})
    specs = jmoe.MoEParams(P(None, None), P("ep", None, None),
                           P("ep", None, None))
    fn = jmesh.shard_map(
        lambda p, x: jmoe.moe_block(p, x, "ep", job["capacity_factor"]),
        mesh=jm, in_specs=(specs, P("ep", None)),
        out_specs=(P("ep", None), P()))
    params = jmoe.MoEParams(*(jnp.asarray(inp[n]) for n in
                              ("router", "w_in", "w_out")))
    x, cot = jnp.asarray(inp["x"]), jnp.asarray(inp["cot"])
    def loss(p, x):
        y, aux = fn(p, x)
        return jnp.sum(y * cot), (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    res = out[job["name"]]
    got = torch_ranks.gather([r["y"] for r in res], ("ep",), job["sizes"],
                             y.shape, world)
    assert _rel(got, np.asarray(y)) <= F32_TOL
    np.testing.assert_array_equal(np.abs(got).max(1) > 0,
                                  np.abs(np.asarray(y)).max(1) > 0)
    if job["name"].endswith("drop"):   # one kept row a shard
        assert int((np.abs(got).sum(-1) > 1e-9).sum()) == ep
    for r in res:
        assert float(r["aux"]) == pytest.approx(float(aux), rel=F32_TOL)
        assert _grad_err(r["drouter"], np.asarray(gp.router)) <= GRAD_TOL
    for name, want in (("dx", gx), ("dw_in", gp.w_in),
                       ("dw_out", gp.w_out)):
        g = torch_ranks.gather([r[name] for r in res], ("ep",),
                               job["sizes"], want.shape, world)
        assert _grad_err(g, np.asarray(want)) <= GRAD_TOL, name


# -- pipeline -------------------------------------------------------------------

@pytest.mark.parametrize("world,job", _jobs("pipeline"))
def test_pipeline_forward_and_grads_match_reference(ranks, world, job):
    out, inputs = ranks(world)
    inp = inputs[job["name"]]
    pp, M = job["sizes"]["pp"], job["n_micro"]
    jm = jmesh.build_mesh(pp, sizes={"pp": pp})

    def stage(params, h):
        def layer(carry, wb):
            return jnp.tanh(carry @ wb[0] + wb[1]), None
        return jax.lax.scan(layer, h, params)[0]

    piped = jmesh.shard_map(
        lambda W, b, xm: jpipe.pipeline_apply(stage, (W, b), xm),
        mesh=jm, in_specs=(P("pp", None, None), P("pp", None),
                           P(None, None, None)),
        out_specs=P(None, None, None))
    W, b = jnp.asarray(inp["W"]), jnp.asarray(inp["b"])
    xm = jpipe.microbatch(jnp.asarray(inp["x"]), M)

    def loss(W, b):
        y = piped(W, b, xm)
        return jnp.sum(y ** 2), y

    (_, y), (gW, gb) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(W, b)
    want = np.asarray(jpipe.unmicrobatch(y))
    seq = inp["x"]
    for layer in range(inp["W"].shape[0]):
        seq = np.tanh(seq @ inp["W"][layer] + inp["b"][layer])
    np.testing.assert_allclose(want, seq, rtol=1e-5, atol=1e-5)
    res = out[job["name"]]
    for r in res:   # replicated over 'pp': every stage holds the outputs
        assert _rel(r["out"], want) <= F32_TOL
    for name, g in (("dW", gW), ("db", gb)):
        gg = torch_ranks.gather([r[name] for r in res], ("pp",),
                                job["sizes"], g.shape, world)
        assert _grad_err(gg, np.asarray(g)) <= GRAD_TOL, name
