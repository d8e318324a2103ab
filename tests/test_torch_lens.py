"""The port's byte-flow waterfall and stage profiler
(``tpurpc_torch/obs/{lens,profiler}.py``) against the reference's.

The cases are ``tests/test_lens.py``'s that need no scrape server, no
shard, no ``tools/`` module and no transport hooks (the ring's hop
counters come with ROADMAP A4 (b)). The profiler cases drive
``sample_once`` with synthetic frames, so stage attribution is
deterministic; markers a case registers use basenames no module has.
Each scenario runs on both packages and the observations must be equal.
"""

import os
import time

import pytest

from torch_call_plane import PORT, REF, both


def test_hop_counters_known_hops_only():
    def scenario(pkg):
        b, ns, cp = pkg.lens.hop_counters("wire")
        try:
            pkg.lens.hop_counters("warp-drive")
            err = None
        except ValueError as exc:
            err = str(exc)
        return b.name, ns.name, cp.name, err, pkg.lens.HOP_NAMES

    got = both(scenario)
    assert got[:3] == ("lens_wire_bytes", "lens_wire_busy_ns",
                       "lens_wire_copy_bytes")


def test_waterfall_rates_and_slowest_hop():
    def scenario(pkg):
        b, ns, _ = pkg.lens.hop_counters("send_ring")
        b0 = b.snapshot()
        b.inc(10_000_000)
        ns.inc(1_000_000)  # 10 MB in 1 ms on top of whatever was there
        doc = pkg.lens.waterfall()
        row = next(r for r in doc["hops"] if r["hop"] == "send_ring")
        rate_ok = row["gbps"] == pytest.approx(
            row["bytes"] / (row["busy_ms"] * 1e6), rel=0.05, abs=0.002)
        return (b0 + 10_000_000 <= row["bytes"] <= b.snapshot(), rate_ok,
                doc["slowest_hop"] in {r["hop"] for r in doc["hops"]},
                sorted(doc), tuple(r["hop"] for r in doc["hops"])
                == pkg.lens.HOP_NAMES, sorted(row))

    assert both(scenario)[:3] == (True, True, True)


def test_waterfall_text_rendering_flags_slowest():
    def scenario(pkg):
        slow_b, slow_ns, _ = pkg.lens.hop_counters("decode")
        slow_b.inc(500_000_000)
        slow_ns.inc(50_000_000_000_000)
        txt = pkg.lens.render_text()
        return ("slowest" in txt and "decode" in txt,
                txt.splitlines()[0].split())

    assert both(scenario)[0] is True


def test_waterfall_text_with_no_traffic():
    def scenario(pkg):
        rows = [{"hop": h, "bytes": 0, "busy_ms": 0.0, "gbps": 0.0,
                 "copy_bytes": 0, "what": "w"} for h in pkg.lens.HOP_NAMES]
        doc = {"hops": rows, "slowest_hop": pkg.lens.slowest_hop(rows)}
        return doc["slowest_hop"], pkg.lens.render_text(doc).splitlines()[-1]

    assert both(scenario) == (None, "(no traffic yet: every hop idle)")


def test_slowest_hop_ignores_control_only_traffic():
    def scenario(pkg):
        rows = [
            {"hop": "wire", "bytes": 20_000, "busy_ms": 10.0, "gbps": 0.002},
            {"hop": "rendezvous", "bytes": 500_000_000, "busy_ms": 100.0,
             "gbps": 5.0},
            {"hop": "decode", "bytes": 480_000_000, "busy_ms": 60.0,
             "gbps": 8.0},
        ]
        first = pkg.lens.slowest_hop(rows)
        rows[0] = {"hop": "wire", "bytes": 400_000_000, "busy_ms": 400.0,
                   "gbps": 1.0}
        return first, pkg.lens.slowest_hop(rows)

    assert both(scenario) == ("rendezvous", "wire")


@pytest.mark.parametrize("val,on", [("", True), ("1", True), ("0", False),
                                    ("off", False), ("false", False)])
def test_lens_switch(monkeypatch, val, on):
    """``TPURPC_LENS`` gates the sampler: ``ensure_started`` is False (and
    starts nothing) with the lens off."""
    monkeypatch.setenv("TPURPC_LENS", val)

    def scenario(pkg):
        enabled = pkg.lens.enabled()
        if not enabled:
            return enabled, pkg.profiler.ensure_started()
        return enabled, None

    assert both(scenario) == (on, None if on else False)


# ---------------------------------------------------------------------------
# the stage profiler: deterministic classification with synthetic frames
# ---------------------------------------------------------------------------

class _Code:
    def __init__(self, filename, name):
        self.co_filename = filename
        self.co_name = name


class _Frame:
    def __init__(self, filename, name, back=None):
        self.f_code = _Code(filename, name)
        self.f_back = back


def _stack(*frames):
    """A frame chain from (filename, function) pairs, outermost first; the
    INNERMOST frame (what ``sys._current_frames`` yields)."""
    top = None
    for filename, name in frames:
        top = _Frame(filename, name, back=top)
    return top


#: a module basename no package has; both registries learn its markers
_FAKE = "/x/torch_lens_twin_ring.py"


@pytest.fixture(autouse=True, scope="module")
def _fake_markers():
    for pkg in (REF, PORT):
        pkg.profiler.register_stages(_FAKE, {"drain_into": "ring-read",
                                             "writev": "ring-write"})


def _server_file(pkg):
    return pkg.server.__file__


def test_server_registers_dispatch_markers():
    def scenario(pkg):
        srv = os.path.basename(_server_file(pkg))
        m = pkg.profiler.markers()
        return {fn: m.get((srv, fn)) for fn in
                ("_run_handler", "_run_handler_inner", "_run_inline")}

    assert both(scenario) == {"_run_handler": "dispatch",
                              "_run_handler_inner": "dispatch",
                              "_run_inline": "dispatch"}


def test_classify_innermost_marker_wins():
    def scenario(pkg):
        f = _stack((_server_file(pkg), "_run_handler"),
                   (_FAKE, "drain_into"))
        stage, parts = pkg.profiler.StageProfiler.classify(f)
        return stage, parts

    assert both(scenario) == ("ring-read", ["server:_run_handler",
                                            "torch_lens_twin_ring:drain_into"])


def test_classify_stdlib_park_attributes_to_outer_frame():
    """A handler thread parked in a stdlib wait belongs to the ``dispatch``
    frame that parked it."""
    def scenario(pkg):
        f = _stack((_server_file(pkg), "_run_handler_inner"),
                   ("/usr/lib/python3/threading.py", "wait"))
        return pkg.profiler.StageProfiler.classify(f)[0]

    assert both(scenario) == "dispatch"


def test_classify_unattributed_vs_other():
    def scenario(pkg):
        in_tree = pkg.profiler._TPURPC_DIR + "/rpc/mystery.py"
        a, _ = pkg.profiler.StageProfiler.classify(_stack((in_tree,
                                                           "enigma")))
        b, parts = pkg.profiler.StageProfiler.classify(
            _stack(("/usr/lib/python3/selectors.py", "select")))
        return a, b, parts

    assert both(scenario) == ("unattributed", "other", [])


def test_sample_once_aggregates_and_bounds():
    def scenario(pkg):
        p = pkg.profiler.StageProfiler(hz=50)
        frames = {
            1: _stack((_FAKE, "writev")),
            2: _stack((_FAKE, "drain_into")),
            3: _stack(("/usr/lib/python3/queue.py", "get")),
        }
        for _ in range(10):
            p.sample_once(frames=dict(frames), now_ns=123)
        snap = p.snapshot()
        return (p.samples, p.ticks, dict(p.stages), snap["attributed_pct"],
                snap["stage_pct"], len(p.recent), p.collapsed_text(),
                snap["top_stacks"][:1])

    got = both(scenario)
    assert got[:4] == (30, 10, {"ring-write": 10, "ring-read": 10,
                                "other": 10}, 100.0)
    assert "torch_lens_twin_ring:writev 10" in got[6]


def test_sampler_thread_runs_and_stops():
    def scenario(pkg):
        p = pkg.profiler.StageProfiler(hz=200)
        p.start()
        try:
            deadline = time.monotonic() + 5
            while p.samples == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            ran = p.samples > 0 and p.running()
        finally:
            p.stop()
        n = p.samples
        time.sleep(0.05)
        p.reset()
        return ran, p.running(), n > 0, p.samples, p.snapshot()["ticks"]

    assert both(scenario) == (True, False, True, 0, 0)


def test_register_stages_keys_by_basename():
    def scenario(pkg):
        pkg.profiler.register_stages("/weird/path/fake_lens_twin_mod.py",
                                     {"fake_fn": "codec"})
        stage, _ = pkg.profiler.StageProfiler.classify(
            _stack(("/other/prefix/fake_lens_twin_mod.py", "fake_fn")))
        return (pkg.profiler.markers()[("fake_lens_twin_mod.py",
                                        "fake_fn")], stage)

    assert both(scenario) == ("codec", "codec")


@pytest.mark.parametrize("val,hz", [("", 50.0), ("10", 10.0),
                                    ("1000", 250.0), ("0.1", 1.0),
                                    ("bogus", 50.0)])
def test_sampler_rate_env(monkeypatch, val, hz):
    monkeypatch.setenv("TPURPC_LENS_HZ", val)
    assert both(lambda pkg: pkg.profiler.StageProfiler().hz) == hz


def test_chrome_trace_carries_clock_anchor():
    def scenario(pkg):
        doc = pkg.tracing.chrome_trace()
        a = doc["clock_anchor"]
        return (abs(a["mono_ns"] - time.monotonic_ns()) < 5e9,
                abs(a["wall_ns"] - time.time_ns()) < 5e9,
                a["uncertainty_ns"] >= 0, a["pid"] == os.getpid(),
                doc["displayTimeUnit"])

    assert both(scenario) == (True, True, True, True, "ms")
