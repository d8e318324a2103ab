"""Bundle renderer: read a postmortem off disk.

    python -m tpurpc_torch.tools.bundle <bundle-dir | bundles-root>

A copy of ``tpurpc/tools/bundle.py``. Renders one evidence bundle (see
:mod:`tpurpc_torch.obs.bundle`): the trigger and detail from
``meta.json``, the SLO alert states, the watchdog diagnoses, the flight
replay's tail, the tsdb history's summary and the waterfall. Pointed at a
root directory of bundles it lists them and renders the newest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional


def _load(path: str, fname: str):
    try:
        with open(os.path.join(path, fname), "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _flight_dump(path: str) -> Optional[list]:
    for fn in sorted(os.listdir(path)):
        if fn.startswith("flight-") and fn.endswith(".json"):
            doc = _load(path, fn)
            if isinstance(doc, list):
                return doc
    return None


def render(path: str, flight_tail: int = 40) -> str:
    lines = [f"bundle: {path}", "=" * 64]
    meta = _load(path, "meta.json") or {}
    lines.append(f"trigger  {meta.get('trigger', '?')} "
                 f"(pid {meta.get('pid', '?')}, seq {meta.get('seq', '?')})")
    if meta.get("detail"):
        lines.append(f"detail   {meta['detail']}")

    slo = _load(path, "slo.json") or {}
    for obj in slo.get("objectives", ()):
        for track, st in (obj.get("tracks") or {}).items():
            if st.get("state") != "ok" or st.get("fired"):
                lines.append(
                    f"slo      {obj.get('name')}/{track}: "
                    f"state={st.get('state')} "
                    f"burn={st.get('burn_fast')}x/{st.get('burn_slow')}x "
                    f"fired={st.get('fired')}")
    stalls = _load(path, "stalls.json") or {}
    for d in (stalls.get("active") or [])[:5]:
        lines.append(f"stall    {d.get('method')}: stage={d.get('stage')} "
                     f"age={d.get('age_s')}s")
    for d in (stalls.get("history") or [])[-3:]:
        lines.append(f"stall(h) {d.get('method')}: stage={d.get('stage')}")

    hist = _load(path, "history.json") or {}
    n_series = len(hist.get("series") or {})
    if n_series:
        lines.append(f"history  {n_series} series over "
                     f"{hist.get('window_s')}s @ {hist.get('grain_s')}s "
                     f"grain (history.json)")
    wf = _load(path, "waterfall.json") or {}
    slow = wf.get("slowest_hop")
    if slow:
        lines.append(f"flow     slowest hop: {slow}")

    events = _flight_dump(path)
    if events:
        lines.append(f"flight   {len(events)} events; last {flight_tail}:")
        t0 = events[0].get("t_ns", 0)
        for e in events[-flight_tail:]:
            lines.append(
                f"  +{(e.get('t_ns', 0) - t0) / 1e6:10.3f}ms "
                f"{e.get('event', '?'):<22} {e.get('entity', '-'):<18} "
                f"a1={e.get('a1')} a2={e.get('a2')}")
    else:
        lines.append("flight   (no flight dump in bundle)")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpurpc_torch.tools.bundle",
        description="Render an evidence bundle.")
    ap.add_argument("path", help="a bundle directory, or a root of them")
    ap.add_argument("--tail", type=int, default=40,
                    help="flight events to show")
    args = ap.parse_args(argv)

    path = args.path
    if not os.path.isdir(path):
        print(f"bundle: {path} is not a directory", file=sys.stderr)
        return 1
    if not any(fn.startswith("flight-") or fn == "meta.json"
               for fn in os.listdir(path)):
        from tpurpc_torch.obs.bundle import list_bundles

        names = list_bundles(path)
        if not names:
            print(f"bundle: no bundles under {path}", file=sys.stderr)
            return 1
        print(f"{len(names)} bundle(s) under {path}; rendering newest:")
        for n in names:
            print(f"  {n}")
        path = os.path.join(path, names[-1])
    sys.stdout.write(render(path, flight_tail=args.tail))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
