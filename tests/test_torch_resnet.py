"""The port's ResNet (tpurpc_torch.models.resnet) against the reference's
flax model (tpurpc.models.resnet): the reference's variables, randomized
from a numpy seed (BatchNorm statistics included, so every block's residual
branch and projection carry signal), go across through ``from_flax`` and both
models run the same NHWC input on the CPU.

Tolerance: float32 on both sides, the same arithmetic in another summation
order (XLA's convolutions vs oneDNN's) — 1e-4 absolute and relative on
logits of order one. resnet50 at full width catches a wrong stage layout;
64x64 keeps the even-size SAME padding of every stride-2 layer in play.

bfloat16 (``dtype=``): both compute convs and batch norms in bf16 from
float32 parameters, and the head in float32. The tolerance is BF16_TOL ×
the reference's largest |logit|, with top-1 equal. Readings on this
test's inputs, max |diff| over that scale, seeds 0–5 of resnet18_thin and
0–2 of resnet50 (this CPU's oneDNN against XLA's):

  model          port bf16 vs flax bf16    port float32 vs flax bf16
  resnet18_thin  0.8e-7 – 2.0e-7           1.4e-3 – 7.4e-3
  resnet50       5.5e-3 – 1.17e-2          7.8e-3 – 1.36e-2

resnet18_thin agrees to float32 rounding, so its limit, 2^-12 (2.4e-4),
sits a thousand times above the sound readings and six times below the
float32 control's least: a port whose ``dtype=`` computed in float32 fails
every thin case (``test_bfloat16_tolerance_refuses_float32``). resnet50's
16 blocks compound single bf16 roundings landing the other way to the size
of the bf16–float32 gap itself, so it cannot tell the two apart; its limit,
2^-6 (1.56e-2), sits 1.3 times above its largest sound reading.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurpc.models import resnet as jres
from tpurpc_torch.models import resnet as tres

TOL = 1e-4
BF16_TOL = {"resnet18_thin": 2 ** -12, "resnet50": 2 ** -6}


def _random_variables(model, size, seed):
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = getattr(path[-1], "key", "")
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("name,size", [("resnet18_thin", 32), ("resnet50", 64)])
def test_from_flax_logits_match_reference(name, size):
    jmodel = getattr(jres, name)(num_classes=10)
    variables = _random_variables(jmodel, size, seed=size)
    x = np.random.default_rng(1).standard_normal((1, size, size, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, x, train=False))

    tmodel = getattr(tres, name)(num_classes=10)
    tmodel.load_state_dict(tres.from_flax(variables))  # strict: every key
    got = tres.make_infer_fn(tmodel)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 10)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _bf16_case(name, size, seed, dtype):
    """The reference's bf16 logits, the port's at ``dtype`` from the same
    variables, and the reference's largest |logit|."""
    jmodel = getattr(jres, name)(num_classes=10, dtype=jnp.bfloat16)
    variables = _random_variables(jmodel, size, seed=size + seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, x, train=False))
    tmodel = getattr(tres, name)(num_classes=10, dtype=dtype)
    tmodel.load_state_dict(tres.from_flax(variables))
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    got = tres.make_infer_fn(tmodel)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    return got.numpy(), want, float(np.abs(want).max())


@pytest.mark.parametrize("name,size,seed", [
    ("resnet18_thin", 32, 0), ("resnet18_thin", 32, 1),
    ("resnet18_thin", 32, 2), ("resnet50", 64, 0)])
def test_bfloat16_logits_match_reference(name, size, seed):
    got, want, scale = _bf16_case(name, size, seed, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_TOL[name] * scale)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bfloat16_tolerance_refuses_float32(seed):
    """The control: the port's float32 forward lies outside the thin
    model's bf16 limit, so a ``dtype=`` that computed in float32 fails."""
    got, want, scale = _bf16_case("resnet18_thin", 32, seed, torch.float32)
    assert np.abs(got - want).max() > BF16_TOL["resnet18_thin"] * scale


@pytest.mark.parametrize("size,k,s,want", [
    (32, 3, 2, (0, 1)),   # even input, stride 2: SAME pads (0, 1)
    (33, 3, 2, (1, 1)),
    (16, 1, 2, (0, 0)),   # 1x1 stride 2 pads nothing
    (16, 3, 1, (1, 1)),
])
def test_same_padding_matches_flax(size, k, s, want):
    assert tres._same_pad(size, k, s) == want


def test_resnet50_stage_layout():
    m = tres.resnet50()
    assert len(m.blocks) == 16 and m.dense.out_features == 1000
    assert m.blocks[0].conv2.out_channels == 256
    assert m.blocks[-1].conv2.out_channels == 2048
    assert sum(b.proj for b in m.blocks) == 4
