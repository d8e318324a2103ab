#!/usr/bin/env python3
"""Where the time of the port's fan-in serving goes, on one CUDA card.

Run from the root of a checkout: ``python3 fanin_profile.py``. It needs a
card, prints the card's name and power limit, and measures:

1. ResNet-50 at the bucket shape [8,224,224,3] in three forms: float32
   (TF32 off); bf16 as the port runs it (float32 weights at rest, each conv
   casting its kernel per call); and bf16 with the conv kernels stored in
   bf16 (the cast is then a no-op). Each is timed by host clock (a forward
   then a synchronize, mean of 20) and by CUDA events around 20 forwards
   back to back (device time per forward, the host's dispatch overlapped),
   and one forward of each runs under ``torch.profiler``: its kernels'
   device time, the top 6 by name, and the number of kernel launches.
2. ``chip_smoke.py``'s phase 4 (a) — bf16 ResNet-50 behind the
   fixed-bucket ``FanInBatcher``, 8 pipelined clients at depth 4, 128
   single-image requests — once plain and once under ``torch.profiler``:
   the device's busy share over the window (kernel and copy time over wall
   time), and the host time of the batcher's stages per batch as the
   batcher counts them (``FanInBatcher.stage_s``: stack, the host concat,
   cast, pad and H2D enqueue; model, the forward's dispatch; d2h, the
   reply's D2H enqueue; split, the replies' views, on the completion
   threads), warm-up batches included.
"""

import os
import sys
import time

SEED = 0
BUCKET = (8, 224, 224, 3)
REPS = 20


def model_forms(dev, card):
    import torch

    from chip_smoke import device_busy_ms, device_events, host_ms
    from tpurpc_torch.models.resnet import _Conv, make_infer_fn, resnet50

    x = torch.zeros(BUCKET, device=dev)
    forms = {}
    torch.manual_seed(SEED)
    forms["float32"] = make_infer_fn(resnet50().to(dev))
    torch.manual_seed(SEED)
    forms["bf16"] = make_infer_fn(resnet50(dtype=torch.bfloat16).to(dev))
    torch.manual_seed(SEED)
    stored = resnet50(dtype=torch.bfloat16).to(dev)
    for m in stored.modules():
        if isinstance(m, _Conv):
            m.weight.data = m.weight.data.to(torch.bfloat16)
    forms["bf16, conv kernels stored bf16"] = make_infer_fn(stored)
    for name, infer in forms.items():
        host = host_ms(lambda: infer(x), reps=REPS)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(REPS):
            infer(x)
        b.record()
        b.synchronize()
        back_to_back = a.elapsed_time(b) / REPS
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            infer(x)
            torch.cuda.synchronize()
        kernels = device_events(prof)
        launches = sum(e.count for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        print(f"model {name} at {list(BUCKET)}: host clock {host} ms; back "
              f"to back {back_to_back} ms per forward; profiled forward: "
              f"{launches} kernel launches, device {device_busy_ms(prof)} ms "
              f"({card})", flush=True)
        for e in top:
            print(f"    {e.self_device_time_total / 1e3:.4f} ms x{e.count} "
                  f"{e.key[:100]}", flush=True)


def serving_window(dev, card):
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.rpc.server import Server
    from tpurpc_torch.torchshim.service import FanInBatcher, add_tensor_method

    rng = np.random.default_rng(SEED)
    images = [rng.standard_normal((1, *BUCKET[1:])).astype(np.float32)
              for _ in range(cs.CLIENTS * cs.PER_CLIENT)]
    torch.manual_seed(SEED)
    infer = make_infer_fn(resnet50(dtype=torch.bfloat16).to(dev))
    infer(torch.zeros(BUCKET, device=dev))

    def one_run(profile: bool):
        b = FanInBatcher(lambda t: {"logits": infer(t["x"])},
                         max_batch=cs.MAX_BATCH, max_delay_s=0.005,
                         fixed_bucket=True, transfer_dtype=torch.bfloat16,
                         device=dev)
        srv = Server(max_workers=cs.WORKERS)
        add_tensor_method(srv, "Infer", b)
        srv.start()
        port = srv.add_insecure_port("127.0.0.1:0")
        prof = None
        try:
            if profile:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            replies, lat, wall, before = cs.drive_clients(port, images,
                                                   cs.PER_CLIENT, b)
            total = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
            srv.stop()
            b.close()
        batches = b.batches_run - before[1]
        p50 = float(np.percentile(lat, 50))
        line = (f"serving{' (profiled)' if profile else ''}: "
                f"{len(replies)} requests, {batches} batches, images/s "
                f"{len(replies) / wall}, p50 {p50} ms; batcher stages per "
                f"batch over all {b.batches_run}, host ms: " + ", ".join(
                    f"{k} {v * 1e3 / b.batches_run}" for k, v in
                    b.stage_s.items()))
        if prof is not None:
            busy = cs.device_busy_ms(prof)
            line += (f"; device busy {busy} ms of {total * 1e3} ms "
                     f"profiled ({busy / (total * 1e3)})")
        print(f"{line} ({card})", flush=True)

    one_run(profile=False)
    one_run(profile=True)


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    model_forms(dev, card)
    serving_window(dev, card)


if __name__ == "__main__":
    main()
