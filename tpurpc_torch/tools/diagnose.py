"""Offline diagnosis: replay a postmortem bundle into the same ranked
causal report the live ``/debug/diagnose`` route serves.

    python -m tpurpc_torch.tools.diagnose <bundle-dir | bundles-root>
                                          [--json] [--symptom KIND]

A copy of ``tpurpc/tools/diagnose.py``. The bundle's frozen planes
(``history.json``, ``flight-*.json``, ``stalls.json``, ``slo.json``,
``waterfall.json``) run through the same rule engine
(:class:`tpurpc_torch.obs.diagnose.BundlePlanes` is just another
``Planes``), so a postmortem read later ranks the cause the live route
ranked at trip time. Pointed at a root of bundles it takes the newest.
``--json`` prints the machine document; the default is the prose
report."""

from __future__ import annotations

import argparse
import json
import os
import sys

from tpurpc_torch.obs import diagnose as _diagnose


def _resolve(path: str) -> str:
    """A bundle dir as-is, or the newest bundle under a root."""
    if os.path.isfile(os.path.join(path, "meta.json")):
        return path
    try:
        names = sorted(n for n in os.listdir(path)
                       if n.startswith("bundle-")
                       and os.path.isdir(os.path.join(path, n)))
    except OSError:
        names = []
    if names:
        return os.path.join(path, names[-1])
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpurpc_torch.tools.diagnose",
        description="replay a postmortem bundle through the causal "
                    "diagnosis engine")
    ap.add_argument("path", help="bundle directory (or a root of bundles "
                                 "— the newest is diagnosed)")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable report")
    ap.add_argument("--symptom", default=None,
                    help="pin the symptom (auto|watchdog|slo|<query>)")
    args = ap.parse_args(argv)

    path = _resolve(args.path)
    if not os.path.isdir(path):
        print(f"no such bundle: {args.path}", file=sys.stderr)
        return 2
    doc = _diagnose.diagnose_bundle(path, want=args.symptom)
    if args.json:
        print(json.dumps(doc, indent=1))
    else:
        print(f"bundle: {path}")
        if doc.get("trigger"):
            print(f"trigger: {doc['trigger']}")
        sys.stdout.write(_diagnose.render_text(doc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
