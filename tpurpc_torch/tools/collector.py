"""Fleet collector CLI.

    python -m tpurpc_torch.tools.collector HOST:PORT [HOST:PORT ...] \
        [--port 9123] [--poll 1.0] [--stale-after 3] [--once]

A copy of ``tpurpc/tools/collector.py``. Polls every member's
introspection routes and serves the merged fleet views
(``/fleet/metrics``, ``/fleet/slo``, ``/fleet/seq``, ``/fleet/diagnose``)
on its own HTTP port; see :mod:`tpurpc_torch.obs.collector`. ``--once``
polls once, prints the merged SLO document and exits. Targets may also be resolver
specs (``dns:///name:port``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpurpc_torch.tools.collector",
        description="Aggregate N tpurpc members' telemetry behind one "
                    "/fleet/* endpoint.")
    ap.add_argument("targets", nargs="+",
                    help="HOST:PORT (or resolver spec) of each member")
    ap.add_argument("--port", type=int, default=0,
                    help="HTTP port to serve /fleet/* on (0 = ephemeral)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--poll", type=float, default=1.0,
                    help="poll interval, seconds")
    ap.add_argument("--stale-after", type=int, default=3,
                    help="missed polls before a member is marked stale")
    ap.add_argument("--once", action="store_true",
                    help="poll once, print merged /fleet/slo, exit")
    args = ap.parse_args(argv)

    from tpurpc_torch.obs.collector import FleetCollector, resolve_targets

    targets = resolve_targets(args.targets)
    if not targets:
        print("collector: no targets", file=sys.stderr)
        return 1
    col = FleetCollector(targets, poll_s=args.poll,
                         stale_after=args.stale_after)
    if args.once:
        col.poll_once()
        print(json.dumps(col.merged_slo(), indent=1))
        return 0
    port = col.serve(host=args.host, port=args.port)
    print(f"collector: {len(targets)} member(s), serving "
          f"http://{args.host}:{port}/fleet/{{metrics,slo,seq,diagnose}}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        col.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
