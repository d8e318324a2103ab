"""The port's one-rank training at full width against the reference's
``build_train_step``, step by step, on the CPU: ``chip_smoke.py`` phase
7's run. (tests/test_transformer.py:58's run at the test config is in
tests/test_torch_dist_transformer.py.) Tolerances and readings:
tests/test_torch_train.py's docstring."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_ranks
from tests.test_torch_train import (LOSS_TOL, LR, PARAM_FAR,
                                    PARAM_FAR_SHARE, PARAM_MEDIAN,
                                    PARAM_STEP_SHARE, STEPS, _cfgs,
                                    _np_params, _port_model)
from tpurpc.models import transformer as jtfm
from tpurpc.parallel import mesh as jmesh
from tpurpc_torch.models import transformer as ttfm
from tpurpc_torch.parallel import build_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_ranks.one_torch_thread():
        yield


def _ref_train(jcfg, params, tokens, targets, steps, lr=LR, n=1, sizes=None):
    """The reference's ``build_train_step``: each step's loss and the
    parameters after the last step."""
    m = jmesh.build_mesh(n, sizes=sizes)
    step, opt = jtfm.build_train_step(jcfg, m, lr=lr)
    p = jtfm.shard_params({k: jnp.asarray(v) for k, v in params.items()},
                          jcfg, m)
    state = opt.init(p)
    losses = []
    for _ in range(steps):
        p, state, loss = step(p, state, jnp.asarray(tokens),
                              jnp.asarray(targets))
        losses.append(float(loss))
    return np.array(losses), {k: np.asarray(v) for k, v in p.items()}


def _port_train(tcfg, params, tokens, targets, steps, lr=LR):
    mesh = build_mesh(1, device="cpu")
    model = _port_model(tcfg, params)
    step, make_optimizer = ttfm.build_train_step(tcfg, mesh, lr=lr)
    opt = make_optimizer(model)
    losses = [float(step(model, opt, torch.from_numpy(tokens),
                         torch.from_numpy(targets))) for _ in range(steps)]
    return np.array(losses), {k: v.detach().numpy()
                              for k, v in model.named_parameters()}


def _check_train(got, want, steps):
    (gl, gp), (wl, wp) = got, want
    np.testing.assert_allclose(gl, wl, rtol=LOSS_TOL)
    assert set(gp) == set(wp)
    for k in wp:
        d = np.abs(gp[k] - wp[k])
        assert d.max() <= PARAM_STEP_SHARE * LR * steps, (k, d.max())
        assert np.median(d) <= PARAM_MEDIAN, (k, np.median(d))
        assert (d > PARAM_FAR).mean() <= PARAM_FAR_SHARE, (k, (
            d > PARAM_FAR).mean())


def test_full_width_train_matches_reference():
    """``chip_smoke.py`` phase 7's run on the CPU: ``TransformerConfig()``
    (821,376 parameters), PRNGKey(0) weights, seed-0 tokens [8, 128] with
    next-token targets, 10 steps at lr 3e-3. The reference went from 6.0299
    to 2.2268."""
    jcfg, tcfg = _cfgs({})
    params = _np_params(jcfg, 0)
    tokens = np.random.default_rng(0).integers(0, 256, (8, 128)).astype(
        np.int32)
    targets = np.roll(tokens, -1, axis=1)
    want = _ref_train(jcfg, params, tokens, targets, STEPS)
    got = _port_train(tcfg, params, tokens, targets, STEPS)
    _check_train(got, want, STEPS)
    assert got[0][-1] < 0.8 * got[0][0], got[0]
