#!/usr/bin/env python3
"""The port's fleet serving alone, on one CUDA card, beside its one-process
baseline.

Run from the root of a checkout: ``python3 fleet_profile.py``. It builds
the kernels, runs ``chip_smoke.py``'s phase 3 (one process, one connection:
8 ResNet-50 requests through the device ring, each request's latency) and
then its phase 9 (three fleets of spawned worker processes: (a)
``serve_torch_sharded`` of two transformer workers under phase 6's traffic,
(b) two device-ring ResNet-50 workers, one connection each, each request's
latency, (c) one ``least_loaded`` channel over two servers), and prints
phase 9's time with the card's name and power limit. It checks what the
smoke checks and needs a card.

Spawned workers re-import this file as ``__mp_main__``: it does its work
under the ``__main__`` guard, and the workers find their builds in
``chip_smoke``.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this profile needs a "
                "card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    cs.build_kernels()
    cs.main_path(dev)
    t0 = time.perf_counter()
    out = cs.fleet_serving(dev, card)
    print(f"fleet profile: phase 9 took {time.perf_counter() - t0} s; (b) "
          f"{out['b']} ({card})", flush=True)


if __name__ == "__main__":
    main()
