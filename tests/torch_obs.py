"""The fixture :func:`clean_obs` for the port's obs tests, which take
``REF``, ``PORT`` and ``both`` from ``torch_call_plane``.

Every observability module is process-wide in its package: a scenario
asserts deltas or reads only its own flight tags, resets with the
module's own reset, and :func:`clean_obs` puts each package's recorder,
tracer and watchdog back as it found them.
"""

import pytest

from torch_call_plane import BOTH


def _reset(pkg):
    pkg.flight.RECORDER.reset()
    pkg.tracing.reset()
    pkg.tracing.force(None)
    pkg.tracing.tail(None)
    pkg.tracing.configure(0.0)
    pkg.watchdog.get().reset()


@pytest.fixture
def clean_obs():
    """Fresh flight rings, span buffers and watchdog registries in both
    packages, sampling at 0 and tail capture at its default; the watchdogs'
    knobs are restored afterwards."""
    saved = []
    for pkg in BOTH:
        _reset(pkg)
        wd = pkg.watchdog.get()
        saved.append((wd, (wd.min_stall_s, wd.sweep_s, wd.mult,
                           wd.enabled)))
    yield
    for wd, prev in saved:
        wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled = prev
    for pkg in BOTH:
        _reset(pkg)
        pkg.tracing.configure()
