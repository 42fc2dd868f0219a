"""Timers, and the port's spans and counters.

``Timer`` and ``TimerCollection`` are the port's own copy of
``sparsex_tpu/timing.py``: parity with the reference timing API
(``include/sparsex/timing.h:24-85``: start/pause/get-seconds accumulation)
and the internal ``TimerCollection``
(``include/sparsex/internals/TimerCollection.hpp``) used for the
"PREPROCESSING TIMING STATISTICS" report.

On top of them, one mechanism for what the port measures of itself:

- a **span** (:class:`span`, a context manager) names a stretch of host
  time.  It records into a process-wide registry its count, its seconds,
  its self seconds (its seconds less those of the spans opened inside it
  on the same thread) and the name of the span it first ran inside.
  While ``torch.profiler`` records, it also opens a
  record-function range of the same name, so the span lands in the
  profiler's trace, on the device trace's clock.  With no profiler
  recording a span costs two ``perf_counter`` reads, torch's check for an
  active profiler (made by the outermost span) and an update of its
  thread's own registry: no lock, no tensor, no synchronisation, and no
  switch to turn it off;
- a **planner span** (:func:`planner`) also counts a host planner's
  seconds as rejected when it made no plan;
- a **counter** (:func:`count`, :func:`count_max`) adds to, or keeps the
  largest of, a named number;
- a timer created with a ``span`` name (``TimerCollection.create_timer``)
  opens and closes that span at each start and pause, so its seconds are
  the span's own readings.

Every span name starts with ``spx.``.  :func:`trace_snapshot` reads the
registry and :func:`trace_reset` empties it; nothing else does (a matrix's
release and ``Config.reset()`` leave it).  The names the port records are
listed in README.md ("Tracing").
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch

_clock = time.perf_counter
_profiling = torch.autograd._profiler_enabled

_lock = threading.Lock()
# each thread's span registry: name -> [count, seconds, self seconds,
# parent's name, rejected seconds]; a thread updates only its own, so a
# span takes no lock, and the registries of finished threads stay
_registries: List[dict] = []
_counters: Dict[str, float] = {}


class _State:
    """One thread's innermost open span, its open planners' rejected
    (name, seconds) lists, and its registry."""

    __slots__ = ("top", "planners", "spans")

    def __init__(self):
        self.top = None
        self.planners = []
        self.spans = {}
        with _lock:
            _registries.append(self.spans)


class _Local(threading.local):
    def __init__(self):
        self.state = _State()


_local = _Local()


class span:
    """``with span("spx.<layer>.<what>") as s:`` records the block's host
    time under that name; ``s.seconds`` holds it after the block.  A span
    inside another asks the profiler check of its outermost span only."""

    __slots__ = ("name", "seconds", "_t0", "_child", "_parent", "_range",
                 "_state")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        st = self._state = _local.state
        parent = self._parent = st.top
        st.top = self
        self._child = 0.0
        self._range = (_profiling() if parent is None else parent._range) \
            and _open_range(self.name)
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = _clock() - self._t0
        if self._range:
            self._range.__exit__(None, None, None)
        st = self._state
        # restoring the parent also drops spans an exception left open
        parent = st.top = self._parent
        self.seconds = dt
        rec = st.spans.get(self.name)
        if rec is None:
            rec = st.spans[self.name] = [0, 0.0, 0.0,
                                         parent and parent.name, 0.0]
        rec[0] += 1
        rec[1] += dt
        rec[2] += dt - self._child
        if parent is not None:
            parent._child += dt


# the profiler range torch's compiled code opens (a ``cpu_op`` event in the
# trace): a tenth of the cost of torch.profiler.record_function
_Range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


def _open_range(name: str):
    rf = _Range(name)
    rf.__enter__()
    return rf


def _commit_rejected(spans: dict, rejected) -> None:
    for name, sec in rejected:
        spans.setdefault(name, [0, 0.0, 0.0, None, 0.0])[4] += sec


def planner(rejected: Callable[[object], bool]):
    """Decorator of a host planner: each call runs in the span
    ``spx.tune.plan.<function name>``.  When ``rejected(result)`` holds
    (the planner made no plan), its seconds count as rejected, unless a
    planner around it is rejected too: then only the outer one counts."""
    def wrap(fn):
        name = "spx.tune.plan." + fn.__name__

        @functools.wraps(fn)
        def run(*args, **kwargs):
            here = _local.state
            inner = []      # rejected planners inside this one
            here.planners.append(inner)
            try:
                with span(name) as s:
                    out = fn(*args, **kwargs)
            finally:
                here.planners.pop()
            mine = [(name, s.seconds)] if rejected(out) else inner
            if here.planners:
                here.planners[-1].extend(mine)
            else:
                _commit_rejected(here.spans, mine)
            return out
        return run
    return wrap


def carry(fn):
    """``fn`` for another thread: the spans it opens there name the
    caller's innermost open span as their parent (their time is not taken
    out of that span's self seconds, which counts its own thread only)."""
    outer = _local.state.top
    if outer is None:
        return fn

    def run(*args, **kwargs):
        stand_in = span(outer.name)     # never entered: a parent by name
        stand_in._child, stand_in._range = 0.0, outer._range
        st = _local.state
        top, st.top = st.top, stand_in
        try:
            return fn(*args, **kwargs)
        finally:
            st.top = top
    return run


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def count_max(name: str, value: float) -> None:
    """Keep the largest ``value`` given to counter ``name``."""
    with _lock:
        cur = _counters.get(name)
        if cur is None or value > cur:
            _counters[name] = value


def span_seconds(name: str) -> float:
    """The seconds recorded so far under span ``name``, on every
    thread."""
    rec = _merged().get(name)
    return rec[1] if rec else 0.0


def _merged() -> Dict[str, list]:
    """Every thread's registry added up (a name's parent: the last
    thread's that recorded it)."""
    out: Dict[str, list] = {}
    with _lock:
        regs = list(_registries)
    for reg in regs:
        for name, r in list(reg.items()):
            m = out.get(name)
            if m is None:
                out[name] = list(r)
            else:
                m[0] += r[0]
                m[1] += r[1]
                m[2] += r[2]
                m[3] = r[3]
                m[4] += r[4]
    return out


def trace_snapshot() -> dict:
    """``{"spans": {name: {count, seconds, self_seconds, parent,
    rejected_seconds}}, "counters": {name: value}}``, a copy of the
    process's registry."""
    with _lock:
        counters = dict(_counters)
    return {"spans": {name: {"count": r[0], "seconds": r[1],
                             "self_seconds": r[2], "parent": r[3],
                             "rejected_seconds": r[4]}
                      for name, r in _merged().items()},
            "counters": counters}


def trace_reset() -> None:
    """Empty the registry (spans still open record when they close)."""
    with _lock:
        for reg in _registries:
            reg.clear()
        _counters.clear()


class Timer:
    """Accumulating wall-clock timer (spx_timer_t parity); with ``span``,
    each start-to-pause stretch is that span."""

    def __init__(self, description: str = "", span: Optional[str] = None):
        self.description = description
        self._span = span
        self._frame = None
        self._elapsed = 0.0
        self._start: Optional[float] = None

    def clear(self) -> None:
        self._elapsed = 0.0
        self._start = None

    def start(self) -> None:
        if self._span is None:
            self._start = _clock()
            return
        if self._frame is not None:     # started again: the span restarts
            self._frame.__exit__(None, None, None)
        self._frame = span(self._span).__enter__()
        self._start = self._frame._t0

    def pause(self) -> None:
        if self._start is None:
            return
        if self._frame is not None:
            self._frame.__exit__(None, None, None)
            self._elapsed += self._frame.seconds
            self._frame = None
        else:
            self._elapsed += _clock() - self._start
        self._start = None

    def get_secs(self) -> float:
        running = 0.0
        if self._start is not None:
            running = _clock() - self._start
        return self._elapsed + running

    def __enter__(self) -> "Timer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.pause()


class TimerCollection:
    """Named-timer map with a formatted report (TimerCollection parity)."""

    def __init__(self):
        self._timers: Dict[str, Timer] = {}

    def create_timer(self, name: str, description: str = "",
                     span: Optional[str] = None) -> None:
        self._timers.setdefault(name, Timer(description or name, span))

    def start_timer(self, name: str) -> None:
        self.create_timer(name)
        self._timers[name].start()

    def pause_timer(self, name: str) -> None:
        if name in self._timers:
            self._timers[name].pause()

    def get_secs(self, name: str) -> float:
        return self._timers[name].get_secs() if name in self._timers else 0.0

    def names(self) -> Iterable[str]:
        return self._timers.keys()

    def report(self) -> str:
        lines = []
        for name, t in self._timers.items():
            lines.append(f"{t.description or name}: {t.get_secs():.6f} s")
        return "\n".join(lines)
