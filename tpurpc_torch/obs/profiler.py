"""Stage-tagged sampling profiler: where the cycles go, by stage.

A copy of ``tpurpc/obs/profiler.py``. A background sampler walks every
thread's Python stack (``sys._current_frames``, default 50 Hz,
``TPURPC_LENS_HZ``) and maps each stack to a pipeline *stage* through a
frame-marker registry: modules register ``(file basename, function name) ->
stage`` pairs at import (:func:`register_stages`), and a sample's stage is
the FIRST marker hit walking the stack innermost→outermost, so the most
specific stage wins and a thread parked in a stdlib wait is attributed to
the frame of this package that parked it. A stack with this package's
frames but no marker counts as ``unattributed``; a stack with none of its
frames counts as ``other`` and leaves the attribution denominator.

Exports: per-stage sample shares (:func:`snapshot`), collapsed stacks
(:func:`collapsed_text`), and a bounded ring of recent raw samples
``(t_ns, tid, stage)``. ``TPURPC_LENS=0`` keeps the sampler off.

A shard worker's :meth:`StageProfiler.snapshot` names its shard
(:mod:`tpurpc_torch.obs.shard`).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = [
    "STAGES", "DEFAULT_HZ", "register_stages", "markers", "StageProfiler",
    "get", "ensure_started", "stop", "snapshot", "collapsed_text",
]

#: canonical stage vocabulary (superset of the watchdog's stall stages on
#: the CPU side). Append-only: names land in scrapes and bench artifacts.
STAGES = (
    "ring-write", "ring-read", "pair-send", "h2-framing", "codec",
    "hbm-place", "batcher", "device-dispatch", "dispatch", "poller-wait",
    "wire", "scrape", "idle",
)

DEFAULT_HZ = 50.0

#: the frame-marker registry: (file basename, function name) -> stage.
#: Mutated only by register_stages at import time; read racily by the
#: sampler (a plain dict read — worst case one sample attributes late).
_MARKERS: Dict[Tuple[str, str], str] = {}

#: markers for stacks that are pure infrastructure parking — registered
#: here because the frames live in the stdlib, not in a tpurpc module
_SELF_STAGES = {
    "_loop": "idle",            # this module's own sampler thread
}

_TPURPC_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def register_stages(filename: str, mapping: Dict[str, str]) -> None:
    """Declare frame markers for one module: ``mapping`` is
    ``{function_name: stage}``, ``filename`` is the module's ``__file__``
    (or a bare basename for stdlib files). Modules call this ONCE at import
    with a module-level constant dict — the ``stage`` lint rule enforces
    the no-dynamic-strings contract."""
    base = os.path.basename(filename)
    for fn, stage in mapping.items():
        _MARKERS[(base, fn)] = stage


def markers() -> Dict[Tuple[str, str], str]:
    return dict(_MARKERS)


register_stages(__file__, _SELF_STAGES)
#: stdlib parking spots for threads this package owns (scrape listener,
#: thread-pool idlers): basename-keyed like every other marker
register_stages("socketserver.py", {"serve_forever": "idle",
                                    "service_actions": "idle"})
register_stages("threading.py", {"_bootstrap": "idle"})


def _default_hz() -> float:
    from tpurpc_torch.utils.config import _env

    raw = _env("TPURPC_LENS_HZ") or ""
    try:
        return max(1.0, min(250.0, float(raw))) if raw else DEFAULT_HZ
    except ValueError:
        return DEFAULT_HZ


_MAX_WALK = 48        # frames examined per thread per sample
_MAX_STACKS = 2048    # distinct collapsed stacks kept (overflow -> "(other)")
_RECENT = 4096        # raw (t_ns, tid, stage) samples kept for the timeline


class StageProfiler:
    """The sampler. One instance per process (:func:`get`); tests may build
    private ones and drive :meth:`sample_once` deterministically."""

    def __init__(self, hz: Optional[float] = None):
        self.hz = hz if hz is not None else _default_hz()
        self.samples = 0           # thread-samples taken (threads x ticks)
        self.ticks = 0
        self.stages: Dict[str, int] = {}
        self._stacks: Dict[str, int] = {}
        self.recent: "deque" = deque(maxlen=_RECENT)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()   # start/stop only; sampling is free
        self._names: Dict[int, str] = {}
        self._names_stamp = 0.0
        self.started_ns = 0

    # -- classification ------------------------------------------------------

    @staticmethod
    def classify(frame) -> Tuple[str, List[str]]:
        """(stage, collapsed-stack leaf-last) for one thread's innermost
        frame. Walks innermost→outermost; first marker wins. The collapsed
        stack keeps this package's frames and marker frames only,
        outermost first."""
        stage = None
        parts: List[str] = []
        f = frame
        depth = 0
        saw_tpurpc = False
        while f is not None and depth < _MAX_WALK:
            code = f.f_code
            base = os.path.basename(code.co_filename)
            key = (base, code.co_name)
            hit = _MARKERS.get(key)
            if hit is not None and stage is None:
                stage = hit
            in_tree = code.co_filename.startswith(_TPURPC_DIR)
            saw_tpurpc = saw_tpurpc or in_tree
            if in_tree or hit is not None:
                parts.append(f"{base[:-3] if base.endswith('.py') else base}"
                             f":{code.co_name}")
            f = f.f_back
            depth += 1
        if stage is None:
            stage = "unattributed" if saw_tpurpc else "other"
        parts.reverse()
        return stage, parts

    # -- sampling ------------------------------------------------------------

    def sample_once(self, frames: Optional[dict] = None,
                    now_ns: Optional[int] = None) -> None:
        """One tick: classify every live thread. ``frames`` injectable for
        deterministic tests.

        Lifetime discipline: ``sys._current_frames()`` includes THIS
        thread's own frame — i.e. ``sample_once`` itself — and the dict is
        a local of that very frame, a reference cycle only the gc can
        break. Left in place, the cycle keeps every sampled frame (and its
        locals — live memoryview exports over data-plane buffers!) pinned
        until the next collection, which surfaces as BufferError on
        bytearray resizes far away. Popping the self entry breaks the
        cycle, so the whole dict frees by refcount the moment this
        function returns; the ``finally`` clear bounds the hold to one
        walk even if the dict was injected."""
        own = False
        if frames is None:
            frames = sys._current_frames()
            own = True
        me = threading.get_ident()
        frames.pop(me, None)  # break the frame→dict→frame self-cycle
        now = now_ns if now_ns is not None else time.monotonic_ns()
        self.ticks += 1
        try:
            for tid, frame in frames.items():
                stage, parts = self.classify(frame)
                self.samples += 1
                self.stages[stage] = self.stages.get(stage, 0) + 1
                if parts:
                    key = ";".join(parts)
                    if key in self._stacks or len(self._stacks) < _MAX_STACKS:
                        self._stacks[key] = self._stacks.get(key, 0) + 1
                    else:
                        self._stacks["(other)"] = \
                            self._stacks.get("(other)", 0) + 1
                self.recent.append((now, tid, stage))
        finally:
            if own:
                frames.clear()  # drop every sampled-frame ref NOW

    def _refresh_names(self) -> None:
        now = time.monotonic()
        if now - self._names_stamp < 1.0:
            return
        self._names_stamp = now
        try:
            self._names = {t.ident: t.name for t in threading.enumerate()
                           if t.ident is not None}
        except RuntimeError:
            pass

    def _loop(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            try:
                self.sample_once()
                self._refresh_names()
            except Exception:
                pass  # the profiler must never take anything down

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "StageProfiler":
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self.started_ns = time.monotonic_ns()
            t = threading.Thread(target=self._loop, daemon=True,
                                 name="tpurpc-lens-sampler")
            self._thread = t
            t.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout=2)

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def reset(self) -> None:
        self.samples = 0
        self.ticks = 0
        self.stages = {}
        self._stacks = {}
        self.recent.clear()

    # -- export --------------------------------------------------------------

    def snapshot(self, top: int = 20, include_samples: bool = False) -> dict:
        stages = dict(self.stages)
        other = stages.get("other", 0)
        unatt = stages.get("unattributed", 0)
        denom = self.samples - other
        shares = {s: round(n / denom * 100, 1) if denom else 0.0
                  for s, n in stages.items() if s != "other"}
        out = {
            "hz": self.hz,
            "running": self.running(),
            "ticks": self.ticks,
            "samples": self.samples,
            "stages": stages,
            "stage_pct": shares,
            "attributed_pct": (round((denom - unatt) / denom * 100, 1)
                               if denom else 0.0),
            "top_stacks": sorted(self._stacks.items(),
                                 key=lambda kv: -kv[1])[:top],
        }
        from tpurpc_torch.obs import shard as _shard

        if _shard.shard_id() >= 0:
            out["shard"] = _shard.shard_id()
        if include_samples:
            self._refresh_names()
            out["recent"] = [{"t_ns": t, "tid": tid, "stage": s,
                              "thread": self._names.get(tid, "")}
                             for t, tid, s in list(self.recent)]
        return out

    def collapsed_text(self) -> str:
        """flamegraph.pl-compatible collapsed stacks: ``a;b;c count``."""
        lines = [f"{stack} {n}"
                 for stack, n in sorted(self._stacks.items(),
                                        key=lambda kv: -kv[1])]
        return "\n".join(lines) + ("\n" if lines else "")


_instance: Optional[StageProfiler] = None
_instance_lock = threading.Lock()


def get() -> StageProfiler:
    global _instance
    if _instance is None:
        with _instance_lock:
            if _instance is None:
                _instance = StageProfiler()
    return _instance


def ensure_started() -> bool:
    """Start the continuous sampler if the lens plane is enabled; the call
    an entry point makes. Idempotent, False when TPURPC_LENS=0."""
    from tpurpc_torch.obs import lens as _lens

    if not _lens.enabled():
        return False
    get().start()
    return True


def stop() -> None:
    if _instance is not None:
        _instance.stop()


def snapshot(top: int = 20, include_samples: bool = False) -> dict:
    return get().snapshot(top=top, include_samples=include_samples)


def collapsed_text() -> str:
    return get().collapsed_text()
