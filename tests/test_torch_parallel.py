"""The port's parallel modules (``tpurpc_torch.parallel``) against the
reference's (``tpurpc.parallel``), on the CPU.

Each case feeds the same numpy inputs, made from a seed, to both packages.
The reference runs its per-device bodies inside ``shard_map`` on JAX's CPU
devices (tests/conftest.py gives it 8); the port runs them on its one-rank
mesh (``device="cpu"``), where every collective is the identity.

Ring attention: the reference's values do not depend on how 'sp' splits the
sequence (exact math, float32 statistics), so the port's one-rank block is
held against the reference on 1-, 2- and 4-device 'sp' meshes. float32
within 1e-5 of max(1, max |out|). bf16 inputs: both accumulate in float32
and round the output once to bf16, so they may differ by one bf16 rounding
of the output: 2^-8 of max(1, max |out|) (readings over the cases below:
0 to 7.1e-4, under 2^-9).

MoE: float32 within 1e-5; the tokens kept (a dropped token's output row is
exactly 0, a kept one's is not) must be the same tokens, at every capacity
factor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

from tpurpc.parallel import mesh as jmesh
from tpurpc.parallel import moe as jmoe
from tpurpc.parallel import pipeline as jpipe
from tpurpc.parallel import ring_attention as jring
from tpurpc_torch.parallel import build_mesh, collectives
from tpurpc_torch.parallel import factor_mesh
from tpurpc_torch.parallel import mesh as tmesh
from tpurpc_torch.parallel import moe as tmoe
from tpurpc_torch.parallel import pipeline as tpipe
from tpurpc_torch.parallel import ring_attention as tring

F32_TOL = 1e-5
BF16_TOL = 2 ** -8


@pytest.fixture(scope="module")
def mesh1():
    return build_mesh(1, device="cpu")


def _t(a) -> torch.Tensor:
    """numpy (or a JAX array) → torch, bfloat16 bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


# -- mesh ---------------------------------------------------------------------

FACTOR_CASES = {
    "default": {},
    "sp first, tp capped at 4": {"priority": ("sp", "tp", "dp", "pp", "ep"),
                                 "caps": {"tp": 4}},
    "ep, pp capped at 2, dp at 8": {"priority": ("ep", "pp", "dp"),
                                    "caps": {"ep": 2, "pp": 2, "dp": 8}},
}


@pytest.mark.parametrize("case", list(FACTOR_CASES))
def test_factor_mesh_matches_reference(case):
    kw = FACTOR_CASES[case]
    for n in range(1, 65):
        want = jmesh.factor_mesh(n, **kw)
        got = factor_mesh(n, **kw)
        assert got == want, (n, got, want)
        assert int(np.prod(list(got.values()))) == n


def test_build_mesh_one_rank():
    m = build_mesh(device="cpu")
    assert m.axis_names == jmesh.AXES == tmesh.AXES
    assert m.sizes == {a: 1 for a in tmesh.AXES}
    assert m.device == torch.device("cpu")
    m = build_mesh(1, sizes={"sp": 1, "tp": 1}, device="cpu")
    assert m.shape == (1, 1, 1, 1, 1)
    assert all(tmesh.axis_size(m, a) == 1 for a in tmesh.AXES)


@pytest.mark.parametrize("n,sizes", [(1, {"sp": 2}), (8, {"tp": 2}),
                                     (4, {"dp": 2, "ep": 3})])
def test_build_mesh_rejects_bad_product(n, sizes):
    with pytest.raises(ValueError, match="devices"):
        jmesh.build_mesh(n, sizes=sizes)
    with pytest.raises(ValueError, match="devices"):
        build_mesh(n, sizes=sizes, device="cpu")


@pytest.mark.parametrize("n,sizes", [(2, None), (8, {"sp": 2, "tp": 2,
                                                       "ep": 2})])
def test_build_mesh_refuses_more_than_one_rank(n, sizes):
    """Without a process group of n ranks, more than one rank raises and
    names the bring-up call (the multi-rank meshes themselves are held in
    tests/test_torch_dist_*.py)."""
    with pytest.raises(ValueError, match="initialize_cluster"):
        build_mesh(n, sizes=sizes, device="cpu")


def test_mesh_value_rejects_unknown_axis():
    with pytest.raises(ValueError, match="unknown mesh axes"):
        tmesh.Mesh.of({"xp": 2}, "cpu")


# -- collectives --------------------------------------------------------------

def test_collectives_are_identity_on_one_rank(mesh1):
    x = torch.arange(6.0).reshape(2, 3)
    for axis in tmesh.AXES:
        assert collectives.axis_index(mesh1, axis) == 0
        assert collectives.psum(x, mesh1, axis) is x
        assert collectives.pmean(x, mesh1, axis) is x
        assert collectives.all_to_all(x, mesh1, axis) is x
        a, b = collectives.shift(mesh1, axis, x, x + 1)
        assert a is x and torch.equal(b, x + 1)


@pytest.mark.parametrize("op", ["axis_index", "shift", "psum", "pmean",
                                "all_to_all"])
def test_collectives_refuse_larger_axes(op):
    mesh = tmesh.Mesh.of({"sp": 2, "ep": 4}, "cpu")
    x = torch.zeros(4)
    call = {"axis_index": lambda a: collectives.axis_index(mesh, a),
            "shift": lambda a: collectives.shift(mesh, a, x),
            "psum": lambda a: collectives.psum(x, mesh, a),
            "pmean": lambda a: collectives.pmean(x, mesh, a),
            "all_to_all": lambda a: collectives.all_to_all(x, mesh, a)}[op]
    for axis in ("sp", "ep", ("dp", "sp")):
        with pytest.raises(ValueError, match="no process groups"):
            call(axis)
    call("tp")   # size 1 on the same mesh: fine


# -- ring attention -----------------------------------------------------------

def _qkv(seed, shape=(2, 4, 32, 16)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_ring_attention_matches_reference(mesh1, sp, causal, dtype):
    q, k, v = _qkv(sp * 10 + causal)
    jm = jmesh.build_mesh(sp, sizes={"sp": sp})
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    want = jring.ring_attention(jq, jk, jv, jm, causal=causal)
    tq, tk, tv = (_t(a) for a in (jq, jk, jv))
    got = tring.ring_attention(tq, tk, tv, mesh1, causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    assert _rel(got, want) <= (F32_TOL if dtype == "float32" else BF16_TOL)
    # the whole-array wrapper is the block on a one-rank mesh
    assert torch.equal(got, tring.ring_attention_block(
        tq, tk, tv, mesh1, causal=causal))


def test_ring_attention_causal_first_row_sees_itself_only(mesh1):
    q, k, v = (torch.from_numpy(a) for a in _qkv(7))
    out = tring.ring_attention_block(q, k, v, mesh1, causal=True)
    torch.testing.assert_close(out[:, :, 0], v[:, :, 0], rtol=0, atol=1e-6)


def test_ring_attention_refuses_sp_above_one():
    mesh = tmesh.Mesh.of({"sp": 2}, "cpu")
    q, k, v = (torch.from_numpy(a) for a in _qkv(0))
    with pytest.raises(ValueError, match="no process groups"):
        tring.ring_attention_block(q, k, v, mesh, causal=True)


# -- MoE ----------------------------------------------------------------------

def _moe_params(seed, d=32, f=64, E=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, E)).astype(np.float32) * d ** -0.5,
            rng.standard_normal((E, d, f)).astype(np.float32) * d ** -0.5,
            rng.standard_normal((E, f, d)).astype(np.float32) * f ** -0.5)


def _moe_ref(params, x, capacity_factor):
    jm = jmesh.build_mesh(1)
    fn = jmesh.shard_map(
        lambda p, x: jmoe.moe_block(p, x, "ep", capacity_factor),
        mesh=jm, in_specs=(jmoe.MoEParams(P(), P(), P()), P()),
        out_specs=(P(), P()))
    y, aux = fn(jmoe.MoEParams(*(jnp.asarray(a) for a in params)),
                jnp.asarray(x))
    return np.asarray(y), float(aux)


def _moe_port(params, x, mesh, capacity_factor):
    y, aux = tmoe.moe_block(tmoe.MoEParams(*(_t(a) for a in params)), _t(x),
                            mesh, capacity_factor=capacity_factor)
    return y.numpy(), float(aux)


@pytest.mark.parametrize("capacity_factor", [0.25, 0.5, 1.0, 2.0])
def test_moe_matches_reference(mesh1, capacity_factor):
    params = _moe_params(1)
    x = np.random.default_rng(2).standard_normal((64, 32)).astype(np.float32)
    want, want_aux = _moe_ref(params, x, capacity_factor)
    got, got_aux = _moe_port(params, x, mesh1, capacity_factor)
    kept_want = np.abs(want).max(1) > 0
    kept_got = np.abs(got).max(1) > 0
    np.testing.assert_array_equal(kept_got, kept_want)
    expert = np.argmax(x @ params[0], axis=1)
    cap = tmoe.capacity(capacity_factor, 64, 2)
    for e in range(2):   # each expert keeps its first `cap` tokens
        n = int((expert == e).sum())
        assert int(kept_got[expert == e].sum()) == min(n, cap)
    if capacity_factor < 1.0:
        assert not kept_got.all()   # the case drops tokens
    assert _rel(got, want) <= F32_TOL
    assert got_aux == pytest.approx(want_aux, rel=F32_TOL, abs=F32_TOL)


def test_moe_router_tie_picks_first_expert(mesh1):
    """A zero router ties every token's experts: both packages send all of
    them to expert 0, which keeps its first `cap` and drops the rest."""
    params = list(_moe_params(3))
    params[0] = np.zeros_like(params[0])
    x = np.random.default_rng(4).standard_normal((16, 32)).astype(np.float32)
    want, want_aux = _moe_ref(params, x, 1.0)
    got, got_aux = _moe_port(params, x, mesh1, 1.0)
    kept = np.abs(got).max(1) > 0
    np.testing.assert_array_equal(kept, np.abs(want).max(1) > 0)
    np.testing.assert_array_equal(kept, np.arange(16) < 8)
    assert _rel(got, want) <= F32_TOL
    assert got_aux == pytest.approx(want_aux) == pytest.approx(1.0)


def test_moe_gelu_is_the_tanh_approximation(mesh1):
    x = jnp.asarray([-2.0, -0.5, 1.0, 3.0], jnp.float32)
    want = np.asarray(jax.nn.gelu(x))
    t = torch.tensor([-2.0, -0.5, 1.0, 3.0])
    np.testing.assert_allclose(F.gelu(t, approximate="tanh").numpy(), want,
                               rtol=1e-6, atol=1e-7)
    assert abs(float(F.gelu(t)[2]) - float(want[2])) > 1e-4   # exact differs
    # and the MoE layer uses it: one expert, identity-like weights, a token
    # at 1.0 on one channel comes out at gelu_tanh(1) = 0.841192
    d = 4
    params = (np.zeros((d, 1), np.float32), np.eye(d, dtype=np.float32)[None],
              np.eye(d, dtype=np.float32)[None])
    x = np.zeros((1, d), np.float32)
    x[0, 0] = 1.0
    got, _ = _moe_port(params, x, mesh1, 1.0)
    assert got[0, 0] == pytest.approx(0.841192, abs=1e-6)


def test_moe_init_shapes_and_scales():
    g = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(g, 64, 128, 4, device="cpu")
    assert p.router.shape == (64, 4) and p.w_in.shape == (4, 64, 128)
    assert p.w_out.shape == (4, 128, 64)
    assert p.w_in.std().item() == pytest.approx(64 ** -0.5, rel=0.05)
    assert p.w_out.std().item() == pytest.approx(128 ** -0.5, rel=0.05)
    q = tmoe.init_moe(torch.Generator().manual_seed(0), 64, 128, 4,
                      dtype=torch.bfloat16, device="cpu")
    assert q.router.dtype == torch.bfloat16
    assert torch.equal(q.router, p.router.to(torch.bfloat16))


# -- pipeline -----------------------------------------------------------------

def _stage_params(seed, d=8):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5,
            "b": rng.standard_normal((d,)).astype(np.float32)}


def _jax_stage(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _torch_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


@pytest.mark.parametrize("M", [1, 2, 4])
def test_pipeline_matches_reference(mesh1, M):
    params = _stage_params(M)
    x = np.random.default_rng(M + 1).standard_normal((8, 3, 8)).astype(
        np.float32)
    jm = jmesh.build_mesh(1)
    fn = jmesh.shard_map(
        lambda p, x: jpipe.unmicrobatch(jpipe.pipeline_apply(
            _jax_stage, p, jpipe.microbatch(x, M), "pp")),
        mesh=jm, in_specs=({"w": P(), "b": P()}, P()), out_specs=P())
    want = np.asarray(fn({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x)))
    xm = tpipe.microbatch(torch.from_numpy(x), M)
    assert xm.shape == (M, 8 // M, 3, 8)
    got = tpipe.unmicrobatch(tpipe.pipeline_apply(
        _torch_stage, {k: torch.from_numpy(v) for k, v in params.items()},
        xm, mesh1))
    assert got.shape == (8, 3, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_microbatch_rejects_indivisible_batch():
    with pytest.raises(ValueError, match="not divisible"):
        jpipe.microbatch(jnp.zeros((6, 2)), 4)
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.microbatch(torch.zeros(6, 2), 4)


@pytest.mark.parametrize("change", ["shape", "dtype"])
def test_pipeline_rejects_stage_that_changes_activation(mesh1, change):
    jfn = {"shape": lambda p, h: h[..., :2],
           "dtype": lambda p, h: h.astype(jnp.bfloat16)}[change]
    tfn = {"shape": lambda p, h: h[..., :2],
           "dtype": lambda p, h: h.to(torch.bfloat16)}[change]
    x = np.zeros((2, 2, 4), np.float32)
    jm = jmesh.build_mesh(1)
    fn = jmesh.shard_map(lambda x: jpipe.pipeline_apply(jfn, {}, x, "pp"),
                         mesh=jm, in_specs=P(), out_specs=P())
    msg = "pipeline stages must preserve activation shape/dtype"
    with pytest.raises(ValueError, match=msg) as jerr:
        fn(jnp.asarray(x))
    with pytest.raises(ValueError, match=msg) as terr:
        tpipe.pipeline_apply(tfn, {}, torch.from_numpy(x), mesh1)
    assert str(terr.value) == str(jerr.value)
