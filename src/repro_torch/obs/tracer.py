"""Span tracer for the planning stack — zero-overhead when disabled.

The planning pipeline's wall-clock story (broker waves, stacked program
dispatch, device execute, float64 commit) is invisible to the count-based
``PlanningStats``; this tracer records *where the nanoseconds go* without
ever perturbing what gets planned:

* **Monotonic clocks only.**  Every timestamp is ``time.perf_counter_ns``
  relative to the tracer epoch.  The tracer never reads a device value,
  never forces a sync, never rounds a float that feeds planning — with
  tracing on or off, plans, cache contents and ``PlanningStats`` counters
  are bit-identical (pinned by tests/test_obs.py).

* **No-op fast path.**  ``span()`` / ``instant()`` / ``complete()`` on a
  disabled tracer cost one attribute load and a branch: ``span()``
  returns the shared module-level ``NULL_SPAN`` (no allocation — asserted
  allocation-free over the broker hot-loop pattern in tests), and the
  others return immediately.  Hot call sites keep attribution kwargs
  behind the falsy null span (``if sp: sp.set(...)``) or an explicit
  ``if _obs.enabled:`` so the disabled path builds no dicts either.

* **Thread-safe, nesting-aware.**  Completed events append to one
  lock-guarded buffer; the *open*-span stack is ``threading.local``, so
  spans opened on different threads (or interleaved across
  ``flush_async`` double-buffered waves) nest independently and cannot
  corrupt each other.  Each event records its thread id and nesting
  depth.

Enablement: ``REPRO_TRACE=1`` in the environment at import, or
``get_tracer().enable()`` programmatically (the benches and tests use the
latter; both flip the same singleton).

Event model (maps 1:1 onto the Chrome trace-event JSON the exporters
write, loadable in Perfetto / chrome://tracing):

=========  =====  ==============================================
kind       ph     produced by
=========  =====  ==============================================
complete   ``X``  ``with tracer.span(name)`` / ``complete(name, t0)``
instant    ``i``  ``instant(name)``
async b/e  ``b``/``e``  ``async_begin(name, id)`` / ``async_end`` —
                  used for wave lifetimes that *overlap* host work
                  (dispatch -> commit of a double-buffered wave)
=========  =====  ==============================================
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional


class _NullSpan:
    """The disabled-tracer span: falsy, reusable, allocation-free."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **args) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One live span: ``with tracer.span("name") as sp: ... sp.set(...)``.

    Truthy (the null span is falsy), so attribution payload stays behind
    ``if sp:`` at hot call sites.  The event is emitted at ``__exit__``.
    """

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0
        self._depth = 0

    def __bool__(self) -> bool:
        return True

    def set(self, **args) -> "Span":
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        stack = self._tracer._stack()
        # tolerate a foreign top (a bug upstream, not a reason to raise
        # inside the planner) but record honestly what we saw
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._emit_complete(self.name, self.cat, self._t0, t1,
                                    self._depth, self.args)
        return False


class Tracer:
    """Nested-span tracer on monotonic clocks (module docstring)."""

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("REPRO_TRACE", "") not in ("", "0")
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._local = threading.local()
        self._epoch_ns = time.perf_counter_ns()
        self._pid = os.getpid()

    # -- enablement ---------------------------------------------------- #
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop recorded events and re-epoch (fresh trace)."""
        with self._lock:
            self._events = []
            self._epoch_ns = time.perf_counter_ns()

    # -- recording ----------------------------------------------------- #
    def span(self, name: str, cat: str = "plan", **args):
        """Context manager measuring the enclosed region.  Disabled
        tracer: returns the shared ``NULL_SPAN`` (no allocation)."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, args)

    def complete(self, name: str, start_ns: int, cat: str = "plan",
                 **args) -> None:
        """Emit a complete ("X") event whose start was stamped manually
        with ``time.perf_counter_ns()`` — for regions where a ``with``
        block would force awkward re-indentation."""
        if not self.enabled:
            return
        self._emit_complete(name, cat, start_ns, time.perf_counter_ns(),
                            len(self._stack()), args)

    def instant(self, name: str, cat: str = "plan", **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": self._us(time.perf_counter_ns()),
                    "pid": self._pid, "tid": threading.get_ident(),
                    "args": args})

    def async_begin(self, name: str, aid, cat: str = "wave",
                    **args) -> None:
        """Open an async (overlappable) interval — e.g. a dispatched
        flush wave whose device execution outlives the dispatching call."""
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "b", "id": str(aid),
                    "ts": self._us(time.perf_counter_ns()),
                    "pid": self._pid, "tid": threading.get_ident(),
                    "args": args})

    def async_end(self, name: str, aid, cat: str = "wave", **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "e", "id": str(aid),
                    "ts": self._us(time.perf_counter_ns()),
                    "pid": self._pid, "tid": threading.get_ident(),
                    "args": args})

    # -- reading ------------------------------------------------------- #
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def spans(self, name: Optional[str] = None) -> List[dict]:
        """Completed ("X") events, optionally filtered by name."""
        return [e for e in self.events()
                if e["ph"] == "X" and (name is None or e["name"] == name)]

    def chrome_trace(self) -> Dict:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "otherData": {"clock": "perf_counter_ns",
                              "epoch_ns": self._epoch_ns}}

    # -- internals ----------------------------------------------------- #
    def _us(self, t_ns: int) -> float:
        return (t_ns - self._epoch_ns) / 1000.0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _emit_complete(self, name: str, cat: str, t0: int, t1: int,
                       depth: int, args: dict) -> None:
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": self._us(t0), "dur": (t1 - t0) / 1000.0,
              "pid": self._pid, "tid": threading.get_ident(),
              "args": dict(args, depth=depth)}
        self._emit(ev)

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer singleton — hot modules bind it once at
    import (``_obs = get_tracer()``); enable/disable flips in place."""
    return _TRACER


def trace_enabled() -> bool:
    return _TRACER.enabled
