"""The causal diagnosis engine on both packages: the twins of
``tests/test_diagnose.py``.

Every case runs on the reference and on the port (``pkg``) on the same
inputs: change-point detection (the mean-shift split at its exact index,
reset-aware counter deltas, the noise floor), the rule registry (the six
stock rules, symptom gating, noisy-OR combination, a broken rule), the
induced faults that must rank first (credit starvation from a held send
lease, device-infer from a quiet in-flight client call, a frozen native
control ring from synthesized planes), symptom resolution, and every face:
the live ``/debug/diagnose`` route through the scrape dispatch, the
``TPURPC_DIAGNOSE=0`` off switch, a bundle's replay against the live
ranking, the offline CLI, the shard and fleet merges, the text face, and
the watchdog's structured causes and re-trips.

The native-ctrl case drives the engine with synthesized planes (the C
core's own lane, whose live evidence comes with ROADMAP A7 (b), is not
needed for it). Each case resets both packages' flight rings, watchdogs
and tsdbs first and disarms both bundle writers afterwards; the timing
cases keep the reference test's stall bars and sweep by hand.
"""

import json
import threading
import time
import types

import pytest

from torch_call_plane import BOTH
from torch_obs import clean_obs, mod  # noqa: F401


def planes(pkg):
    return types.SimpleNamespace(
        pkg=pkg, flight=pkg.flight, watchdog=pkg.watchdog,
        diagnose=mod(pkg, "obs.diagnose"), scrape=mod(pkg, "obs.scrape"),
        tsdb=mod(pkg, "obs.tsdb"), bundle=mod(pkg, "obs.bundle"),
        collector=mod(pkg, "obs.collector"),
        tools_diagnose=mod(pkg, "tools.diagnose"))


@pytest.fixture(params=BOTH, ids=lambda p: p.name)
def o(request):
    return planes(request.param)


@pytest.fixture(autouse=True)
def _diag_state(clean_obs):  # noqa: F811
    # a fresh tsdb: earlier tests' series would otherwise feed this
    # diagnosis real-looking onsets (the forgotten sampler is stopped)
    for pkg in BOTH:
        db = mod(pkg, "obs.tsdb")
        if db._instance is not None:
            db._instance.stop()
        db.postfork_reset()
    yield
    for pkg in BOTH:
        mod(pkg, "obs.bundle").disable()


def _fast_wd(o):
    wd = o.watchdog.get()
    wd.enabled = True
    wd.min_stall_s = 0.01
    wd.sweep_s = 0.05
    return wd


def _top(doc):
    hyps = doc.get("hypotheses") or []
    return hyps[0]["cause"] if hyps else None


# ---------------------------------------------------------------------------
# change-point detection
# ---------------------------------------------------------------------------

def test_onset_step_function_found_at_exact_index(o):
    pts = [(i * 1000, 0.0) for i in range(16)]
    pts += [(i * 1000, 10.0) for i in range(16, 32)]
    onset = o.diagnose.detect_onset(pts)
    assert onset is not None
    assert onset["index"] == 16
    assert onset["t_ns"] == 16_000
    assert onset["direction"] == 1
    assert onset["magnitude"] == pytest.approx(10.0)
    assert onset["score"] >= o.diagnose.MIN_SCORE


def test_onset_falling_step_has_negative_direction(o):
    pts = [(i, 8.0) for i in range(12)] + [(i, 1.0) for i in range(12, 24)]
    onset = o.diagnose.detect_onset(pts)
    assert onset["direction"] == -1
    assert onset["magnitude"] == pytest.approx(-7.0)


def test_onset_constant_and_noise_series_return_none(o):
    assert o.diagnose.detect_onset([(i, 5.0) for i in range(32)]) is None
    jitter = [(i, 5.0 + (0.1 if i % 2 else -0.1)) for i in range(32)]
    assert o.diagnose.detect_onset(jitter) is None


def test_onset_too_few_points_is_inadmissible(o):
    pts = [(i, 0.0) for i in range(3)] + [(i, 9.0) for i in range(3, 6)]
    assert o.diagnose.detect_onset(pts) is None


def test_onset_counter_series_diffed_before_split(o):
    vals = []
    v = 0.0
    for i in range(32):
        v += 1.0 if i < 16 else 10.0
        vals.append((i * 10, v))
    onset = o.diagnose.detect_onset(vals, kind="counter")
    assert onset is not None and onset["direction"] == 1
    assert onset["magnitude"] == pytest.approx(9.0, abs=0.5)


def test_onset_counter_reset_cannot_fake_a_cliff(o):
    pts = [(i, float(i)) for i in range(16)]
    pts += [(16 + i, float(i)) for i in range(16)]
    assert o.diagnose.detect_onset(pts, kind="counter") is None


def test_series_shifts_scans_every_series(o):
    wins = {
        "flat": [(i, 1.0) for i in range(16)],
        "step": [(i, 0.0) for i in range(12)] + [(i, 6.0)
                                                 for i in range(12, 24)],
    }
    shifts = o.diagnose.series_shifts(wins, {"flat": "gauge",
                                             "step": "gauge"})
    assert set(shifts) == {"step"}


# ---------------------------------------------------------------------------
# rule registry and combination
# ---------------------------------------------------------------------------

def test_registry_carries_the_six_stock_rules(o):
    names = [r.name for r in o.diagnose.rules()]
    for want in ("watchdog-stage", "flight-edges", "tsdb-shift",
                 "lens-hop", "seq-ledger", "native-counters"):
        assert want in names


def test_register_and_symptom_kind_gating(o):
    ran = []

    def collect(planes_, symptom):
        ran.append(symptom["kind"])
        return None

    rule = o.diagnose.Rule("test-gated", ("query",), collect,
                           lambda f, p, s: [])
    o.diagnose.register(rule)
    try:
        o.diagnose.diagnose(o.diagnose.Planes(), want="why slow")
        assert ran == ["query"]
    finally:
        o.diagnose._RULES.remove(rule)


def test_combine_noisy_or_and_evidence_dedup(o):
    H = o.diagnose.Hypothesis
    hyps = [
        H("credit-starvation", 0.6, [("flight", "lease", 1)], rule="a"),
        H("credit-starvation", 0.5, [("flight", "lease", 1),
                                     ("tsdb", "credit@9", -3)], rule="b"),
        H("other", 0.3, [("x", "y", 0)], rule="a"),
    ]
    out = o.diagnose._combine(hyps)
    assert out[0]["cause"] == "credit-starvation"
    assert out[0]["confidence"] == pytest.approx(1 - 0.4 * 0.5, abs=1e-3)
    assert out[0]["rules"] == ["a", "b"]
    assert out[0]["evidence"] == [["flight", "lease", 1],
                                  ["tsdb", "credit@9", -3]]
    assert out[0]["actionable"]


def test_combine_confidence_capped_under_certainty(o):
    H = o.diagnose.Hypothesis
    hyps = [H("x", 0.99, rule="a"), H("x", 0.99, rule="b")]
    assert o.diagnose._combine(hyps)[0]["confidence"] <= 0.99


def test_broken_rule_never_breaks_the_report(o):
    rule = o.diagnose.Rule(
        "test-broken", (),
        lambda p, s: (_ for _ in ()).throw(RuntimeError("boom")),
        lambda f, p, s: [])
    o.diagnose.register(rule)
    try:
        wd = _fast_wd(o)
        tok = wd.call_started("/t/M")
        time.sleep(3 * wd.min_stall_s)
        wd.sweep_once()
        doc = o.diagnose.diagnose(o.diagnose.LivePlanes())
        assert doc["hypotheses"]
        wd.call_finished(tok)
    finally:
        o.diagnose._RULES.remove(rule)


# ---------------------------------------------------------------------------
# induced faults: rank-1 correct
# ---------------------------------------------------------------------------

def test_fault_credit_starvation_ranks_first(o):
    wd = _fast_wd(o)
    tag = o.flight.tag_for("pair:diagtest")
    o.flight.emit(o.flight.LEASE_RESERVE, tag, 4096)
    tok = wd.call_started("/diag/Wedged")
    try:
        time.sleep(3 * wd.min_stall_s)
        wd.sweep_once()
        doc = o.diagnose.diagnose(o.diagnose.LivePlanes())
        assert doc["symptom"]["stage"] == "credit-starvation"
        assert _top(doc) == "credit-starvation"
        top = doc["hypotheses"][0]
        assert {"watchdog-stage", "flight-edges"} <= set(top["rules"])
        assert top["confidence"] > 0.9
        assert any(p == "flight" for p, _r, _v in top["evidence"])
        assert "ring" in top["actionable"].lower() \
            or "shed" in top["actionable"].lower()
    finally:
        wd.call_finished(tok)
        o.flight.emit(o.flight.LEASE_COMMIT, tag, 4096)


def test_fault_device_infer_ranks_first(o):
    wd = _fast_wd(o)
    tok = wd.call_started("/diag/SlowPeer", kind="client")
    try:
        time.sleep(3 * wd.min_stall_s)
        wd.sweep_once()
        doc = o.diagnose.diagnose(o.diagnose.LivePlanes())
        assert doc["symptom"]["stage"] == "device-infer"
        assert _top(doc) == "device-infer"
        assert "fleet" in doc["hypotheses"][0]["actionable"]
    finally:
        wd.call_finished(tok)


def _frozen_nctrl_planes(o, fresh=False):
    """The native-ctrl-frozen fault as frozen planes: an active watchdog
    diagnosis plus an aged native-lane ctrl-stall bracket (``fresh``: a
    0.1 s old bracket and no watchdog)."""
    NOW = 200_000_000_000

    class P(o.diagnose.Planes):
        def now_ns(self):
            return NOW

        def watchdog(self):
            if fresh:
                return {}
            return {"active": [{
                "stage": "native-ctrl-frozen", "method": "/m/Bulk",
                "kind": "client", "age_s": 4.2,
                "since_ns": NOW - int(4.2e9),
                "cause": {"stage": "native-ctrl-frozen", "entity": "conn-7",
                          "evidence": [["flight", "nctrl-ring-full:conn-7",
                                        4.1]]},
            }], "history": []}

        def flight_events(self):
            age = 100_000_000 if fresh else 4_000_000_000
            return [{"t_ns": NOW - age, "code": o.flight.CTRL_STALL_BEGIN,
                     "event": "ctrl-stall", "tag": 1, "entity": "conn-7",
                     "tid": 1, "a1": 8, "a2": 0, "lane": "native"}]

    return P()


def test_fault_frozen_native_ctrl_ranks_first(o):
    doc = o.diagnose.diagnose(_frozen_nctrl_planes(o))
    assert doc["symptom"]["stage"] == "native-ctrl-frozen"
    assert _top(doc) == "native-ctrl-frozen"
    top = doc["hypotheses"][0]
    assert {"watchdog-stage", "flight-edges"} <= set(top["rules"])
    assert "restart" in top["actionable"]


def test_fresh_flight_edges_are_traffic_not_wedges(o):
    """A bracket open for <1 s is in-flight traffic; only aged edges are
    evidence."""
    doc = o.diagnose.diagnose(_frozen_nctrl_planes(o, fresh=True),
                              want="anything wrong?")
    assert all(h["cause"] != "native-ctrl-frozen"
               for h in doc["hypotheses"])


# ---------------------------------------------------------------------------
# symptom resolution
# ---------------------------------------------------------------------------

def test_symptom_precedence_active_watchdog_beats_history(o):
    class P(o.diagnose.Planes):
        def watchdog(self):
            return {"active": [{"stage": "kv-swap", "method": "/a"}],
                    "history": [{"stage": "migration", "method": "/b"}]}

    sym = o.diagnose.find_symptom(P())
    assert sym["stage"] == "kv-swap" and sym["state"] == "active"


def test_symptom_history_serves_the_bundle_replay_case(o):
    class P(o.diagnose.Planes):
        def watchdog(self):
            return {"active": [],
                    "history": [{"stage": "rendezvous", "method": "/b"}]}

    sym = o.diagnose.find_symptom(P())
    assert sym["stage"] == "rendezvous" and sym["state"] == "history"


def test_symptom_operator_query_is_a_first_class_kind(o):
    sym = o.diagnose.find_symptom(o.diagnose.Planes(), want="why is p99 up")
    assert sym == {"kind": "query", "detail": "why is p99 up",
                   "t_ns": None}


def test_no_symptom_no_hypotheses(o):
    doc = o.diagnose.diagnose(o.diagnose.Planes())
    assert doc["symptom"] is None and doc["hypotheses"] == []


# ---------------------------------------------------------------------------
# faces: live route, off switch, bundle replay, shard and fleet merges
# ---------------------------------------------------------------------------

def test_debug_diagnose_route_json_and_text(o):
    wd = _fast_wd(o)
    tag = o.flight.tag_for("pair:routetest")
    o.flight.emit(o.flight.LEASE_RESERVE, tag, 64)
    tok = wd.call_started("/diag/Route")
    try:
        time.sleep(3 * wd.min_stall_s)
        wd.sweep_once()
        status, ctype, body = o.scrape._route("/debug/diagnose")
        assert status == 200 and "json" in ctype
        doc = json.loads(body)
        assert doc["enabled"] and _top(doc) == "credit-starvation"
        status, ctype, body = o.scrape._route("/debug/diagnose?text=1")
        assert status == 200 and ctype.startswith("text/plain")
        text = body.decode()
        assert "credit-starvation" in text and "#1" in text
    finally:
        wd.call_finished(tok)
        o.flight.emit(o.flight.LEASE_COMMIT, tag, 64)


def test_off_switch_disables_engine_and_bundle_dump(o, tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("TPURPC_DIAGNOSE", "0")
    doc = o.diagnose.diagnose_doc({})
    assert doc == {"enabled": False, "reason": "TPURPC_DIAGNOSE=0"}
    assert "disabled" in o.diagnose.render_text(doc)
    w = o.bundle.enable(str(tmp_path), min_interval_s=0.0)
    w.capture("manual", detail="off-switch")
    names = o.bundle.list_bundles(str(tmp_path))
    assert names
    assert not (tmp_path / names[-1] / "diagnosis.json").exists()


def test_bundle_replay_parity_with_live(o, tmp_path):
    """The bundle frozen at trip time replays to the same rank-1 cause the
    live engine reports."""
    wd = _fast_wd(o)
    tag = o.flight.tag_for("pair:paritytest")
    o.flight.emit(o.flight.LEASE_RESERVE, tag, 128)
    tok = wd.call_started("/diag/Parity")
    try:
        time.sleep(3 * wd.min_stall_s)
        wd.sweep_once()
        live = o.diagnose.diagnose(o.diagnose.LivePlanes())
        w = o.bundle.enable(str(tmp_path), min_interval_s=0.0)
        w.capture("manual", detail="parity")
        names = o.bundle.list_bundles(str(tmp_path))
        path = str(tmp_path / names[-1])
        shipped = json.loads(
            (tmp_path / names[-1] / "diagnosis.json").read_text())
        replayed = o.diagnose.diagnose_bundle(path)
        assert (_top(live) == _top(shipped) == _top(replayed)
                == "credit-starvation")
        assert replayed["bundle"] == names[-1]
    finally:
        wd.call_finished(tok)
        o.flight.emit(o.flight.LEASE_COMMIT, tag, 128)


def test_offline_cli_renders_bundle(o, tmp_path, capsys):
    wd = _fast_wd(o)
    tag = o.flight.tag_for("pair:clitest")
    o.flight.emit(o.flight.LEASE_RESERVE, tag, 64)
    tok = wd.call_started("/diag/Cli")
    try:
        time.sleep(3 * wd.min_stall_s)
        wd.sweep_once()
        w = o.bundle.enable(str(tmp_path), min_interval_s=0.0)
        w.capture("manual", detail="cli")
    finally:
        wd.call_finished(tok)
        o.flight.emit(o.flight.LEASE_COMMIT, tag, 64)
    # pointed at the ROOT it resolves the newest bundle
    assert o.tools_diagnose.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "credit-starvation" in out and "bundle:" in out
    assert o.tools_diagnose.main([str(tmp_path), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert _top(doc) == "credit-starvation"


def _doc(cause, conf, stage=None, state="active"):
    sym = None
    if stage:
        sym = {"kind": "watchdog", "state": state, "stage": stage,
               "method": "/m", "detail": None, "t_ns": 1}
    return {"enabled": True, "symptom": sym,
            "hypotheses": [{"cause": cause, "confidence": conf,
                            "evidence": [["flight", "e", 1]],
                            "rules": ["watchdog-stage"],
                            "actionable": "act"}],
            "onsets": {}, "rules_run": []}


def test_merge_diagnose_docs_corroboration_and_ranking(o):
    docs = {"0": _doc("credit-starvation", 0.6, stage="credit-starvation"),
            "1": _doc("credit-starvation", 0.5),
            "2": _doc("kv-swap", 0.9, stage="kv-swap", state="history")}
    out = o.diagnose.merge_diagnose_docs(docs, label="shard")
    assert out["enabled"] and out["sources"] == ["0", "1", "2"]
    by = {h["cause"]: h for h in out["hypotheses"]}
    assert by["credit-starvation"]["confidence"] == pytest.approx(
        1 - 0.4 * 0.5, abs=1e-3)
    assert by["credit-starvation"]["sources"] == ["0", "1"]
    assert out["corroboration"] == {"credit-starvation": ["0", "1"]}
    assert by["kv-swap"]["evidence"] == [["flight", "shard=2:e", 1]]
    assert out["symptom"]["stage"] == "credit-starvation"


def test_merge_diagnose_docs_skips_disabled_members(o):
    docs = {"a": {"enabled": False},
            "b": _doc("migration", 0.7, stage="migration")}
    out = o.diagnose.merge_diagnose_docs(docs)
    assert out["enabled"] and [h["cause"] for h in out["hypotheses"]] \
        == ["migration"]
    empty = o.diagnose.merge_diagnose_docs({"a": {"enabled": False}})
    assert not empty["enabled"] and empty["hypotheses"] == []


def test_collector_fleet_diagnose_merge(o):
    col = o.collector.FleetCollector(["h1:1", "h2:2", "h3:3"], poll_s=0.1)
    for t, doc in (("h1:1", _doc("rendezvous", 0.6, stage="rendezvous")),
                   ("h2:2", _doc("rendezvous", 0.5)),
                   ("h3:3", None)):
        m = col._members[t]
        m.metrics_text = "tpurpc_x 1\n"
        m.diagnose = doc
        m.misses = 0
        m.polls += 1
        m.last_ok_mono = time.monotonic()
    out = col.merged_diagnose()
    assert out["enabled"]
    assert _top(out) == "rendezvous"
    assert out["corroboration"] == {"rendezvous": ["h1:1", "h2:2"]}
    assert out["members"] == {"h1:1": "up", "h2:2": "up", "h3:3": "up"}
    assert out["degraded"] == ["h1:1"]
    by = {h["cause"]: h for h in out["hypotheses"]}
    assert by["rendezvous"]["evidence"][0][1].startswith("member=h1:1:")


def test_render_text_cites_evidence_and_action(o):
    text = o.diagnose.render_text(
        _doc("credit-starvation", 0.8, stage="credit-starvation"))
    assert "symptom [watchdog] credit-starvation" in text
    assert "#1 credit-starvation" in text
    assert "[flight] e = 1" in text
    assert "-> act" in text


# ---------------------------------------------------------------------------
# the watchdog's structured causes
# ---------------------------------------------------------------------------

def test_watchdog_diag_carries_structured_cause(o):
    wd = _fast_wd(o)
    tag = o.flight.tag_for("pair:structtest")
    o.flight.emit(o.flight.LEASE_RESERVE, tag, 77)
    tok = wd.call_started("/diag/Struct")
    try:
        time.sleep(3 * wd.min_stall_s)
        diags = wd.sweep_once()
        d = next(x for x in diags if x["method"] == "/diag/Struct")
        cause = d["cause"]
        assert cause["stage"] == d["stage"] == "credit-starvation"
        assert cause["evidence"], "structured cause cites no evidence"
        plane, ref, _v = cause["evidence"][0]
        assert plane == "flight" and "lease-reserve-open" in ref
        assert "send-lease held" in d["detail"]
    finally:
        wd.call_finished(tok)
        o.flight.emit(o.flight.LEASE_COMMIT, tag, 77)


def test_watchdog_retrips_once_per_distinct_stage(o):
    """A stall that sharpens (device-infer -> credit-starvation as the
    evidence lands) re-trips; the same stage never trips twice. Only this
    call's trips count, and the process-wide sweeper thread is held for
    the case: a call another test left in flight in this worker trips on
    its own (0.01 s is the stall bar), and the live sweeper would race the
    case's own sweeps."""
    wd = _fast_wd(o)
    sweep = wd.sweep_once
    me = threading.get_ident()
    # the sweeper thread calls self.sweep_once: an instance attribute wins
    wd.sweep_once = lambda *a, **kw: (sweep(*a, **kw)
                                      if threading.get_ident() == me else [])
    trips = []

    def hook(diag):
        if diag["method"] == "/diag/Retrip":
            trips.append(diag["stage"])

    o.watchdog.add_trip_hook(hook)
    tag = o.flight.tag_for("pair:retrip")
    tok = wd.call_started("/diag/Retrip")
    try:
        time.sleep(3 * wd.min_stall_s)
        wd.sweep_once()
        wd.sweep_once()
        assert trips == ["device-infer"]
        o.flight.emit(o.flight.LEASE_RESERVE, tag, 9)
        wd.sweep_once()
        assert trips == ["device-infer", "credit-starvation"]
        wd.sweep_once()
        assert trips == ["device-infer", "credit-starvation"]
    finally:
        del wd.sweep_once
        o.watchdog.remove_trip_hook(hook)
        wd.call_finished(tok)
        o.flight.emit(o.flight.LEASE_COMMIT, tag, 9)
