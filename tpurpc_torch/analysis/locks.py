"""Lock factories: the named seam the serving plane builds its primitives
through.

A trimmed copy of ``tpurpc/analysis/locks.py``'s factories. Each returns a
plain ``threading`` object; the name is kept so that a later checked or
schedule-explored variant can hook the same call sites.
"""

from __future__ import annotations

import threading

__all__ = ["make_lock", "make_condition", "make_event"]


def make_lock(name: str):
    """A mutex for ``name`` (``Class._attr``)."""
    return threading.Lock()


def make_condition(name: str, lock=None):
    """A condition variable; pass ``lock`` to share an existing lock."""
    return threading.Condition(lock)


def make_event(name: str):
    """An event for ``name`` (``Class._attr``)."""
    return threading.Event()
