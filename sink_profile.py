#!/usr/bin/env python3
"""Where the time of the port's bulk stream goes, on one CUDA card.

Run from the root of a checkout: ``python3 sink_profile.py``. It needs a
card, prints the card's name and power limit, and runs ``chip_smoke.py``'s
phase 5 leg (a) — bench.py's Sink stream of float32 [1024,1024] tensors
over rendezvous, landed on the host and moved to the card by ``to_torch``
— in variants, 3 timed rounds of 64 messages each:

1. as phase 5 runs it (``RDMA_BPEV``);
2. with a landing pool budget of 1 GiB (``TPURPC_RENDEZVOUS_POOL_MB``)
   instead of 256 MiB;
3. with the ring's spin before blocking off
   (``TPURPC_BUSY_POLLING_TIMEOUT_US=0``);
4. on ``TCP``;

and leg (b), framed, for 2 rounds. For each round it prints GB/s, the
client link's counters, the Sink handler's host ms per message (pull,
h2d, reduce; ``chip_smoke._sink_consume``) and the client's host ms per
message in its link's sender path: all of ``send_message``, the wait for a
free standing grant (``_take_grant``), solicited claims (``rdv_claim``,
OFFER to CLAIM) and the write into the region (``_rdv_write``), with the
number of solicited claims. Then one 4 MiB ``to_torch`` by host clock from
a landing region, from fresh pageable memory and from pinned memory; and
phase 4 (a) (bf16 fan-in serving) with rendezvous on and off, in turns.
"""

import os
import sys
import time

#: the link's sender-path methods timed on the client
TIMED = ("send_message", "_take_grant", "rdv_claim", "_rdv_write")


def timed_link(acc: dict):
    """An ``on_link`` hook that wraps TIMED on the client's link instance
    and adds each call's host seconds and count into ``acc``."""
    def hook(link):
        for name in TIMED:
            fn = getattr(link, name)   # raises if the link lost the method
            if not callable(fn):
                raise TypeError(f"RdvLink.{name} is not callable")

            def wrapped(*a, _fn=fn, _name=name, **kw):
                t = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    acc[_name] = acc.get(_name, 0.0) + time.perf_counter() - t
                    acc[_name + "_n"] = acc.get(_name + "_n", 0) + 1
            setattr(link, name, wrapped)
    return hook


def leg_variants(dev, card, want):
    import chip_smoke as cs
    from tpurpc_torch.core import rendezvous as rdv

    base = {"GRPC_PLATFORM_TYPE": "RDMA_BPEV"}
    variants = [
        ("(a) as phase 5", base),
        ("(a) pool 1 GiB", dict(base, TPURPC_RENDEZVOUS_POOL_MB="1024")),
        ("(a) no spin", dict(base, TPURPC_BUSY_POLLING_TIMEOUT_US="0")),
        ("(a) TCP", {"GRPC_PLATFORM_TYPE": "TCP"}),
    ]
    extra = ("TPURPC_RENDEZVOUS_POOL_MB", "TPURPC_BUSY_POLLING_TIMEOUT_US")
    n = len(want[0])
    for label, env in variants:
        acc = {}
        saved = {k: os.environ.get(k) for k in cs.SINK_ENV + extra}
        try:
            for key in extra:
                os.environ.pop(key, None)
            # a pool reads its budget when made: each variant gets new ones
            for pool in rdv._pools.values():
                pool.trim()
            rdv._pools.clear()
            recs, gbps = cs.sink_leg(f"profile {label}", dev, card, want, env,
                                     rounds=3, on_link=timed_link(acc))
        finally:
            for key, val in saved.items():
                if val is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = val
        msgs = n * len(recs)
        client = {k: acc.get(k, 0.0) * 1e3 / msgs for k in TIMED}
        print(f"profile {label}: client host ms per message {client}; "
              f"solicited claims {acc.get('rdv_claim_n', 0)} of {msgs} "
              f"messages; GB/s {gbps} ({card})", flush=True)
    cs.sink_leg("profile (b) framed", dev, card, want,
                {"GRPC_PLATFORM_TYPE": "RDMA_BPEV",
                 "TPURPC_RENDEZVOUS": "0"}, rounds=2)
    os.environ.pop("TPURPC_RENDEZVOUS", None)


def h2d_sources(dev, card, x):
    import torch

    import chip_smoke as cs

    region_ms = cs.landing_to_torch_ms(dev, x)
    fresh_ms = cs.host_ms(lambda: torch.from_numpy(x.copy()).to(dev))
    copy_ms = cs.host_ms(lambda: torch.from_numpy(x.copy()))
    pinned = torch.from_numpy(x).pin_memory()
    pinned_ms = cs.host_ms(lambda: pinned.to(dev))
    print(f"profile h2d of {x.nbytes} bytes, host ms: from a landing region "
          f"{region_ms}; from fresh pageable memory {fresh_ms} (of which "
          f"the host copy {copy_ms}); from pinned memory {pinned_ms} "
          f"({card})", flush=True)


def fanin_ab(dev, card):
    """Phase 4 (a) with rendezvous on and off, in turns (on, off, off,
    on): 128 single-image requests from 8 pipelined clients."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.rpc.server import Server
    from tpurpc_torch.torchshim.service import FanInBatcher, add_tensor_method
    from tpurpc_torch.utils import config

    rng = np.random.default_rng(cs.SEED)
    images = [rng.standard_normal((1, cs.SIZE, cs.SIZE, 3)).astype(np.float32)
              for _ in range(cs.CLIENTS * cs.PER_CLIENT)]
    torch.manual_seed(cs.SEED)
    infer = make_infer_fn(resnet50(dtype=torch.bfloat16).to(dev))
    infer(torch.zeros(cs.MAX_BATCH, cs.SIZE, cs.SIZE, 3, device=dev))
    for on in ("1", "0", "0", "1"):
        os.environ["TPURPC_RENDEZVOUS"] = on
        config.set_config(None)
        b = FanInBatcher(lambda t: {"logits": infer(t["x"])},
                         max_batch=cs.MAX_BATCH, max_delay_s=0.005,
                         fixed_bucket=True, transfer_dtype=torch.bfloat16,
                         device=dev)
        srv = Server(max_workers=cs.WORKERS)
        add_tensor_method(srv, "Infer", b)
        srv.start()
        port = srv.add_insecure_port("127.0.0.1:0")
        try:
            replies, lat, wall, before = cs.drive_clients(
                port, images, cs.PER_CLIENT, b)
        finally:
            srv.stop()
            b.close()
        print(f"profile fan-in bf16, TPURPC_RENDEZVOUS={on}: "
              f"{len(replies) / wall} images/s, p50 "
              f"{float(np.percentile(lat, 50))} ms, "
              f"{b.batches_run - before[1]} batches ({card})", flush=True)
    os.environ.pop("TPURPC_RENDEZVOUS", None)
    config.set_config(None)


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this profile needs a "
                "card")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    want = cs.sink_payloads()
    leg_variants(dev, card, want)
    h2d_sources(dev, card, want[0][0])
    fanin_ab(dev, card)


if __name__ == "__main__":
    main()
