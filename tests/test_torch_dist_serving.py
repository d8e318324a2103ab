"""RPC fan-in to a two-process mesh, for the port: tests/test_distributed.py
:222 with gloo ranks on the CPU (``tests/torch_ranks.py``).

Rank 0 serves tensor RPCs on the port's ``Server`` (``add_tensor_method``).
Each request's batch is broadcast from rank 0 to both ranks
(``dist.broadcast``, where the reference has ``broadcast_one_to_all``),
split over 'dp', multiplied by a weight both ranks make from one seed, and
gathered back for the reply; rank 1 runs the same step once per request.
The client is the port's ``TensorClient`` in this process, and every reply
must equal X @ W.
"""

import numpy as np
import torch

from tests import torch_ranks
from tpurpc_torch.rpc.channel import Channel
from tpurpc_torch.torchshim.service import TensorClient

REQUESTS = 3


def test_rpc_fanin_to_two_process_mesh(tmp_path):
    done = tmp_path / "done"
    jobs = [{"name": "serve", "kind": "serve", "sizes": {"dp": 2},
             "requests": REQUESTS, "done": str(done)}]
    procs = torch_ranks.start(2, jobs, {}, tmp_path / "w")
    try:
        port = None
        for line in procs[0].stdout:
            if line.startswith("PORT "):
                port = int(line.split()[1])
                break
        assert port, "rank 0 never printed its port"
        W = np.random.default_rng(21).standard_normal((16, 4)).astype(
            np.float32)
        xr = np.random.default_rng(5)
        with Channel(f"127.0.0.1:{port}") as ch:
            client = TensorClient(ch)
            for _ in range(REQUESTS):
                X = xr.standard_normal((8, 16)).astype(np.float32)
                y = client.call("Infer", {"x": torch.from_numpy(X)},
                                timeout=120)["y"]
                assert y.shape == (8, 4)
                np.testing.assert_allclose(y.numpy(), X @ W, rtol=1e-4,
                                           atol=1e-5)
    finally:
        done.write_text("done")
        torch_ranks.finish(procs)
