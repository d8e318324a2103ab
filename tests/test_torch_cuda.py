"""Tests of the port that need a CUDA card; each skips where
``torch.cuda.is_available()`` is false. This file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax.) The CPU tests hold
the kernels' plain versions against the reference; here the CUDA kernels are
held against the plain versions, and the device ring and the slice run on
the card.
"""

import numpy as np
import pytest
import torch

from tpurpc_torch.ops import ring_scatter as rs_mod
from tpurpc_torch.ops import ring_window as rw_mod
from tpurpc_torch.ops.ring_scatter import ring_scatter, ring_scatter_plain
from tpurpc_torch.ops.ring_window import ring_window, ring_window_plain
from tpurpc_torch.tpu.hbm_ring import HbmRing

CAP = 16384
SPANS = [(0, 4096), (4 * 37, 4096), (CAP - 2048, 8192), (CAP - 400, 4096),
         (4 * 77, CAP), (CAP - 4096, 4096), (3, 1001), (CAP - 1, 2),
         (CAP - 1, 1), (CAP - 7, 13), (5, CAP), (CAP - 4093, 4099), (1, 0)]
#: every start residue mod 16, unwrapped (4099) and across the wrap (8192+5)
SKEWED = [(CAP - 6144 + r, n) for r in range(16) for n in (4099, 8192 + 5)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("start,n", SPANS + SKEWED)
def test_kernels_match_plain_on_card(dev, start, n):
    g = torch.Generator(device=dev).manual_seed(start + n)
    ring = torch.randint(0, 256, (CAP,), dtype=torch.uint8, device=dev,
                         generator=g)
    payload = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                            generator=g)
    before = (rs_mod.launches, rw_mod.launches)
    a = ring_scatter(ring.clone(), payload, start)
    w = ring_window(ring, start, n)
    torch.cuda.synchronize()
    launched = 1 if n else 0
    assert (rs_mod.launches, rw_mod.launches) == (before[0] + launched,
                                                   before[1] + launched)
    assert torch.equal(a, ring_scatter_plain(ring.clone(), payload, start))
    assert torch.equal(w, ring_window_plain(ring, start, n))


@pytest.mark.cuda
def test_device_ring_on_card_aliases_and_gathers(dev):
    ring = HbmRing(CAP, device=dev)
    x = np.random.default_rng(0).standard_normal(1536).astype(np.float32)
    spans = [ring.place(x) for _ in range(2)]      # 6144 B each
    views = [ring.view(o, n, dtype=torch.float32, shape=(1536,))
             for o, n in spans]
    assert all(v.aliased for v in views)
    for v in views:
        v.release()
    before = (rs_mod.launches, rw_mod.launches)
    off, n = ring.place(x)                          # 12288 + 6144 > CAP
    lease = ring.view(off, n, dtype=torch.float32, shape=(1536,))
    assert (rs_mod.launches, rw_mod.launches) == (before[0] + 1, before[1] + 1)
    assert not lease.aliased and lease.array.device.type == "cuda"
    np.testing.assert_array_equal(lease.array.cpu().numpy(), x)
    lease.release()
    assert ring.stats()["writable"] == CAP
    assert ring.buf.data_ptr() == ring._base_ptr
