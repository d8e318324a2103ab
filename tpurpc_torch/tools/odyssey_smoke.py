"""One sequence's whole journey across a disaggregated split.

A copy of ``tpurpc/tools/odyssey_smoke.py``. A disaggregated pair over
``shm`` block grants (the prefill tier in a CHILD process, two decode
servers in this one) serves one account's generation stream, which is
migrated live mid-decode from decode A to decode B. Checked:

* **exact tokens across three hops**: prefill child -> decode A ->
  migration -> decode B; values equal ``reference_decode`` and indices run
  0..n-1;
* **one trace id spans the split**: the client opens one trace context;
  the journey built from ``/traces?trace_id=`` of this process and the
  child has at least two clock-anchored lanes and carries the
  ``seq-ship``/``seq-decode``/``seq-migrate`` spans;
* **the cost plane attributes**: ``/debug/seq`` rolls the account up with
  its tokens, at least one migration, shipped bytes, and at least 95 % of
  the measured device-step time attributed to named sequences;
* **the flight journey is in order**: ``seq-submit`` -> ``gen-join`` ->
  ``seq-first-token`` -> ``seq-detach`` -> ``migration-begin`` ->
  ``migration-end`` (ok). The reference runs its protocol verifier over the
  stream as well; the port's copy of it is ROADMAP A12.

Exit 0 on success. The models run on the card unless
``TPURPC_TORCH_DEVICE=cpu``::

    python -m tpurpc_torch.tools.odyssey_smoke
    python -m tpurpc_torch.tools.odyssey_smoke --prefill HOST:PORT

With ``--prefill`` it is the child alone: a prefill server shipping into
the decode server at ``HOST:PORT``, printing ``PORT <port> <device>`` once
it serves and stopping when its standard input closes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

PROMPT_LEN = 192
MAX_TOKENS = 48
ACCOUNT = "smoke-tenant"


def run_prefill_child() -> int:
    decode_addr = sys.argv[sys.argv.index("--prefill") + 1]

    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.serving import serve_prefill
    from tpurpc_torch.torchshim.generate import ToyDecodeModel

    ch = Channel(decode_addr)
    model = ToyDecodeModel()
    srv, port, state = serve_prefill(model, ch, decode_addr)
    print(f"PORT {port} {model.device}", flush=True)
    try:
        sys.stdin.read()
    finally:
        srv.stop(grace=0)
        state.close()
        ch.close()
    return 0


def spawn_prefill(decode_addr: str, timeout: float = 120.0) -> "tuple":
    """Start the prefill child for ``decode_addr``; returns ``(process,
    port, device)``. The child inherits this environment with the checkout
    on ``PYTHONPATH`` and head sampling on, so its spans commit; a child
    that does not serve within ``timeout`` seconds is killed."""
    import selectors

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env["TPURPC_TRACE_SAMPLE"] = "1"
    child = subprocess.Popen(
        [sys.executable, "-m", "tpurpc_torch.tools.odyssey_smoke",
         "--prefill", decode_addr],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, text=True)
    sel = selectors.DefaultSelector()
    sel.register(child.stdout, selectors.EVENT_READ)
    line = child.stdout.readline().strip() if sel.select(timeout) else ""
    sel.close()
    if not line.startswith("PORT "):
        stop_prefill(child)
        raise RuntimeError(f"prefill child said {line!r}")
    _, port, device = line.split()
    return child, int(port), device


def stop_prefill(child) -> None:
    """Close the child's standard input (its stop signal) and reap it."""
    try:
        child.stdin.close()
        child.wait(timeout=10)
    except Exception:
        child.kill()
        child.wait(timeout=10)
    if child.stdout is not None:
        child.stdout.close()


def _in_order(events, steps) -> bool:
    """True when ``steps`` (event names, or ``(name, {field: value})``)
    occur in ``events`` as an ordered subsequence."""
    i = 0
    for e in events:
        if i == len(steps):
            break
        name, want = (steps[i], {}) if isinstance(steps[i], str) \
            else steps[i]
        if e["event"] == name and all(e.get(k) == v
                                      for k, v in want.items()):
            i += 1
    return i == len(steps)


def run() -> int:
    import numpy as np

    from tpurpc_torch.obs import flight, odyssey, scrape, tracing
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.serving import DisaggClient, migrate, serve_decode
    from tpurpc_torch.torchshim.generate import (ToyDecodeModel,
                                                 reference_decode)

    tracing.force(True)  # every span commits: the journey must be whole
    t0_flight = time.monotonic_ns()

    # decode A (the handoff target) and decode B (the migration target);
    # a slow-ish step keeps the stream alive long enough to migrate it
    a_srv, a_port, a_sched, a_state = serve_decode(
        ToyDecodeModel(step_delay_s=0.01), kv_blocks=96, block_bytes=512,
        kv_kind="shm", name="odyA")
    b_srv, b_port, b_sched, b_state = serve_decode(
        ToyDecodeModel(step_delay_s=0.01), kv_blocks=96, block_bytes=512,
        kv_kind="shm", name="odyB")
    b_ch = Channel(f"127.0.0.1:{b_port}")
    child = None
    try:
        child, p_port, _device = spawn_prefill(f"127.0.0.1:{a_port}")
        p_ch = Channel(f"127.0.0.1:{p_port}")
        cli = DisaggClient(p_ch, f"127.0.0.1:{a_port}", account=ACCOUNT)
        prompt = np.arange(PROMPT_LEN, dtype=np.int32) % 97
        want = reference_decode(prompt, MAX_TOKENS)

        # one trace context for the whole journey: it rides the Prefill
        # RPC into the child, the OfferKv into decode A and the migration
        # offer into decode B
        ctx = tracing.TraceContext(
            int.from_bytes(os.urandom(8), "big"), 1)
        pairs = []
        with tracing.use(ctx):
            it = cli.generate_with_meta(prompt, max_tokens=MAX_TOKENS,
                                        timeout=30)
            for _ in range(6):
                pairs.append(next(it))
            moved, failed = migrate(a_state, b_ch, f"127.0.0.1:{b_port}")
            assert moved >= 1 and failed == 0, (moved, failed)
            pairs.extend(it)
        idxs = [i for i, _ in pairs]
        vals = [t for _, t in pairs]
        assert idxs == list(range(MAX_TOKENS)), idxs
        assert vals == want, (vals[:8], want[:8])
        print(f"  odyssey smoke: {MAX_TOKENS} tokens exact across "
              f"prefill-child -> decode A -> migrate -> decode B "
              f"(moved={moved})")

        doc = odyssey.journey([f"127.0.0.1:{a_port}",
                               f"127.0.0.1:{p_port}"], ctx.trace_id)
        doc = json.loads(json.dumps(doc))  # must be pure JSON
        meta = doc["otherData"]
        assert meta["lanes"] >= 2, meta
        assert not meta["unanchored"], meta
        names = {e.get("name") for e in doc["traceEvents"]
                 if e.get("ph") == "X"}
        for needed in ("seq-ship", "seq-decode", "seq-migrate"):
            assert needed in names, (needed, sorted(names))
        lane_pids = {e.get("pid") for e in doc["traceEvents"]
                     if e.get("ph") == "X"}
        assert len(lane_pids) >= 2, sorted(names)
        print(f"  odyssey smoke: journey doc has {meta['lanes']} anchored "
              f"lanes, spans {sorted(names)}")

        status, _ctype, body = scrape.route_local("/debug/seq")
        assert status == 200
        seq = json.loads(body)
        assert seq["enabled"], seq
        acct = seq["accounts"][ACCOUNT]
        assert acct["tokens"] >= MAX_TOKENS - 1, acct
        assert acct["migrations"] >= 1, acct
        assert acct["shipped_bytes"] > 0, acct
        assert seq["attributed_pct"] is not None \
            and seq["attributed_pct"] >= 95.0, seq["attributed_pct"]
        print(f"  odyssey smoke: /debug/seq attributes "
              f"{seq['attributed_pct']}% of step time; account "
              f"'{ACCOUNT}': tokens={int(acct['tokens'])} "
              f"migrations={int(acct['migrations'])} "
              f"shipped={int(acct['shipped_bytes'])}B")

        events = flight.snapshot(since_ns=t0_flight)
        assert _in_order(events, [
            ("seq-submit", {"a2": PROMPT_LEN}),
            "gen-join", "seq-first-token", "seq-detach",
            "migration-begin", ("migration-end", {"a2": 1}),
        ]), [e["event"] for e in events][:40]
        print("  odyssey smoke: flight journey in order (submit -> join "
              "-> first-token -> detach -> migration)")
        cli.close()
        p_ch.close()
    finally:
        if child is not None:
            stop_prefill(child)
        tracing.force(None)
        for srv, sched, state in ((a_srv, a_sched, a_state),
                                  (b_srv, b_sched, b_state)):
            srv.stop(grace=0)
            sched.close()
            state.close()
            state.mgr.close()
        b_ch.close()
    print("odyssey smoke: PASS (2 processes, one trace id end to end, "
          "account rollup and >=95% step attribution)")
    return 0


def main() -> int:
    if "--prefill" in sys.argv:
        return run_prefill_child()
    try:
        return run()
    except BaseException as exc:
        print(f"odyssey smoke FAILED: {exc!r}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
