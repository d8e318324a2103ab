"""The trace-flag registry and leveled logging (``tpurpc_torch.utils.trace``).

Twins of ``tests/test_config.py::test_trace_env_grammar`` and of
``tests/test_obs.py``'s three trace-flag cases: the same ``TPURPC_TRACE`` /
``GRPC_TRACE`` / ``TPURPC_VERBOSITY`` settings go to both packages, and the
flags both registries hold must read alike, as must what each package's
``log_*`` prints (the time stamp and thread id aside). The port's registry
is its own: a flag made in one package is not listed by the other.

Rules these tests keep: the trace variables are set only through
``monkeypatch``, and after any change to them both packages'
``reapply_env()`` runs, at the end of each test too, so that every flag of
either registry reads as the environment says when the next test in the
worker starts. No flag is left in the reference's registry; a flag this
file makes in the port's registry is taken out again.
"""

import re

import pytest

from tpurpc.utils import trace as ref_trace
from tpurpc_torch.utils import trace as port_trace
import tpurpc.rpc  # noqa: F401
import tpurpc.rpc.native_server  # noqa: F401  (registers "native_server")
import tpurpc_torch.rpc  # noqa: F401  (registers the port's "lookaside")
import tpurpc_torch.rpc.native_server  # noqa: F401  (and the port's)

TRACE_VARS = ("TPURPC_TRACE", "GRPC_TRACE")
VERBOSITY_VARS = ("TPURPC_VERBOSITY", "GRPC_VERBOSITY")
#: the flags both registries hold once both ``rpc`` packages are imported
COMMON = ("ring", "ring_event", "endpoint", "http2", "rpc", "tpu",
          "lookaside")
#: a log line's stamp: level letter, HH:MM:SS.micro, thread id
STAMP = re.compile(r"^([A-Z])\d\d:\d\d:\d\d\.\d{6} +\d+ ", re.M)


def _reapply():
    ref_trace.reapply_env()
    port_trace.reapply_env()


@pytest.fixture
def clean_trace_env(monkeypatch):
    """No trace or verbosity variable set; both registries re-read the
    environment after the test, once monkeypatch's own changes are gone."""
    for var in TRACE_VARS + VERBOSITY_VARS:
        monkeypatch.delenv(var, raising=False)
    _reapply()
    yield monkeypatch
    for var in TRACE_VARS + VERBOSITY_VARS:
        monkeypatch.delenv(var, raising=False)
    _reapply()


def _common(trace) -> dict:
    flags = trace.list_tracers()
    return {name: flags[name] for name in COMMON}


def test_both_registries_hold_the_common_flags():
    for trace in (ref_trace, port_trace):
        assert set(COMMON) <= set(trace.list_tracers())


def test_trace_env_grammar(clean_trace_env):
    clean_trace_env.setenv("TPURPC_TRACE", "all,-http2")
    _reapply()
    for trace in (ref_trace, port_trace):
        flags = trace.list_tracers()
        assert flags["ring"] is True
        assert flags["http2"] is False
    clean_trace_env.setenv("TPURPC_TRACE", "ring_event")
    _reapply()
    for trace in (ref_trace, port_trace):
        flags = trace.list_tracers()
        assert flags["ring_event"] is True
        assert flags["ring"] is False


SPECS = ["all,-http2", "ring_event", "", "all", "-all", " ring , endpoint ",
         "ring,-ring", "-ring,ring", "all,-all,tpu", "lookaside",
         "no_such_flag", ",,rpc,,", "-lookaside,all", "list_tracers"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("var", TRACE_VARS)
def test_trace_spec_reads_alike(clean_trace_env, capfd, var, spec):
    """One spec under either variable: the flags both registries hold
    read alike."""
    clean_trace_env.setenv(var, spec)
    _reapply()
    assert _common(port_trace) == _common(ref_trace)
    _reapply_quiet(clean_trace_env, capfd)


def _reapply_quiet(monkeypatch, capfd):
    """Clear the variables and re-read them, so a pending registry dump of
    a ``list_tracers`` spec is dropped unprinted; discard what was
    printed."""
    for var in TRACE_VARS:
        monkeypatch.delenv(var, raising=False)
    _reapply()
    capfd.readouterr()


def test_trace_all_with_negation(clean_trace_env):
    clean_trace_env.setenv("TPURPC_TRACE", "all,-ring")
    _reapply()
    for trace in (ref_trace, port_trace):
        flags = trace.list_tracers()
        assert flags["endpoint"] and flags["http2"] and not flags["ring"]


def test_tpurpc_trace_overrides_grpc_trace(clean_trace_env):
    clean_trace_env.setenv("GRPC_TRACE", "ring")
    clean_trace_env.setenv("TPURPC_TRACE", "endpoint")
    _reapply()
    for trace in (ref_trace, port_trace):
        flags = trace.list_tracers()
        assert flags["endpoint"] and not flags["ring"]
    # GRPC_TRACE alone still works
    clean_trace_env.delenv("TPURPC_TRACE")
    _reapply()
    for trace in (ref_trace, port_trace):
        flags = trace.list_tracers()
        assert flags["ring"] and not flags["endpoint"]


@pytest.fixture
def ref_only_flag():
    """A flag in the reference's registry alone (the port now has every
    flag the reference defines), removed afterwards."""
    flag = ref_trace.TraceFlag("torch_trace_ref_probe")
    yield flag.name
    with ref_trace._registry_lock:
        ref_trace._registry.pop(flag.name, None)


def test_list_tracers_token_prints_registry_once(clean_trace_env, capfd,
                                                 ref_only_flag):
    """The port's flag use prints the port's registry once; the
    reference's pending dump is its own and prints at the reference's
    first flag use."""
    clean_trace_env.setenv("TPURPC_TRACE", "list_tracers,ring")
    _reapply()
    assert bool(port_trace.trace_ring)  # first USE flushes the listing
    err = capfd.readouterr().err
    assert err.count("available tracers:") == 1
    assert "ring: on" in err and "endpoint: off" in err
    assert "native_server: off" in err  # the port's own flag
    # the port's registry only: a reference-only flag is not listed
    assert f"{ref_only_flag}:" not in err
    bool(port_trace.trace_ring)  # one-shot: no second print
    assert "available tracers:" not in capfd.readouterr().err
    assert bool(ref_trace.trace_ring)
    err = capfd.readouterr().err
    assert (err.count("available tracers:") == 1
            and f"{ref_only_flag}: off" in err)


def test_port_registry_is_separate(clean_trace_env, ref_only_flag):
    """A flag made in the port's registry is listed there only; the
    reference's own flags are not in the port's."""
    assert ref_only_flag in ref_trace.list_tracers()
    assert ref_only_flag not in port_trace.list_tracers()
    assert port_trace.TraceFlag is not ref_trace.TraceFlag
    clean_trace_env.setenv("TPURPC_TRACE", "torch_trace_probe")
    try:
        probe = port_trace.TraceFlag("torch_trace_probe")
        assert probe.enabled  # the environment applies at creation
        assert port_trace.list_tracers()["torch_trace_probe"] is True
        assert "torch_trace_probe" not in ref_trace.list_tracers()
    finally:
        with port_trace._registry_lock:
            port_trace._registry.pop("torch_trace_probe", None)
    assert "torch_trace_probe" not in port_trace.list_tracers()


def _logged(trace, capfd) -> list:
    trace.log_debug("debug %d", 1)
    trace.log_info("info %s", "two")
    trace.log_error("error")
    trace.trace_rpc.log("flag %r", "x")
    return STAMP.sub(r"\1 ", capfd.readouterr().err).splitlines()


@pytest.mark.parametrize("level", ["DEBUG", "INFO", "ERROR", "NONE", "bogus",
                                   None])
def test_log_levels_print_alike(clean_trace_env, capfd, level):
    """Each ``TPURPC_VERBOSITY`` (or none: ERROR) lets the same lines
    through in both packages, and a trace flag's ``log`` prints only while
    the flag is on."""
    if level is not None:
        clean_trace_env.setenv("TPURPC_VERBOSITY", level)
    clean_trace_env.setenv("TPURPC_TRACE", "rpc")
    _reapply()
    capfd.readouterr()
    ref_lines = _logged(ref_trace, capfd)
    port_lines = _logged(port_trace, capfd)
    assert port_lines == ref_lines
    assert "T [rpc] flag 'x'" in port_lines
    want = {"DEBUG": 3, "INFO": 2, "ERROR": 1, "NONE": 0, "bogus": 1,
            None: 1}[level]
    assert len(port_lines) == want + 1


def test_grpc_verbosity_is_the_fallback(clean_trace_env, capfd):
    clean_trace_env.setenv("GRPC_VERBOSITY", "info")
    assert len(_logged(port_trace, capfd)) == 2      # info, error
    clean_trace_env.setenv("TPURPC_VERBOSITY", "NONE")
    assert _logged(port_trace, capfd) == []
