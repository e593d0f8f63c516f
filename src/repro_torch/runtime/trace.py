"""Span tracing: a thread-safe, bounded, Chrome-trace-exportable tracer.

The serving stack's hot loop is a host/device pipeline (prepare ->
dispatch -> device compute -> block -> scatter) whose whole point is
*overlap* — and overlap is invisible in flat counters. A
:class:`Tracer` records wall-clock **spans** (name + start + duration +
nesting + a small args dict) into a bounded ring buffer, cheap enough
to leave attached to the hot path:

* recording one span is two clock reads, a list push/pop, and a deque
  append — no allocation beyond the span object, no locks on the hot
  path (CPython's GIL makes ``deque.append`` atomic);
* a **disabled** tracer's :meth:`Tracer.span` returns a shared no-op
  context manager, so instrumented code costs one method call when
  tracing is off;
* the ring buffer (``maxlen`` spans) bounds memory under sustained
  load — old spans fall off, ``dropped`` counts how many.

Spans nest: each thread keeps a stack, so a span started inside
another records its ``depth`` and ``parent`` (exported spans therefore
render as a flame graph). Spans on synthetic **tracks** (e.g. the
device timeline, which has no host thread) are recorded explicitly
with :meth:`Tracer.add` from timestamps the caller measured.

:meth:`Tracer.to_chrome_trace` writes the standard Chrome trace-event
JSON (``{"traceEvents": [{"ph": "X", "ts": ..., "dur": ...}, ...]}``,
timestamps in microseconds since the tracer's origin) — load it in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing`` to see the
pipeline: with async dispatch on, prepare-of-batch-*t+1* spans sit
UNDER device-compute of batch *t* instead of after it.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional

# host spans ride the recording thread's id; synthetic tracks (device
# timelines, compile lanes) get ids counted down from here so they sort
# after the host threads in trace viewers
_TRACK_BASE = 1 << 20


@dataclasses.dataclass(slots=True)
class Span:
    """One completed span (times in the tracer's clock, seconds)."""
    name: str
    cat: str
    t_start: float
    t_end: float
    tid: int
    depth: int = 0
    parent: Optional[str] = None
    args: Optional[dict] = None

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


class _NullSpan:
    """Shared no-op context manager: what a disabled tracer hands the
    hot path. Truth-tests False so ``with tracer.span(...) as sp`` code
    can guard arg updates with ``if sp:``."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _ActiveSpan:
    """A live span: context manager that records itself on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_depth",
                 "_parent")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_ActiveSpan":
        stack = self._tracer._stack()
        self._depth = len(stack)
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tracer._clock()
        self._tracer._stack().pop()
        self._tracer._record(Span(
            name=self.name, cat=self.cat, t_start=self._t0, t_end=t1,
            tid=threading.get_ident(), depth=self._depth,
            parent=self._parent, args=self.args))
        return False


class Tracer:
    """Thread-safe span recorder with a bounded ring buffer.

    ``enabled=False`` makes every :meth:`span`/:meth:`add` a no-op —
    construct one unconditionally and flip the flag from config, so
    instrumented call sites never need their own guard.
    """

    def __init__(self, maxlen: int = 65536, enabled: bool = True,
                 clock=time.perf_counter):
        self.enabled = bool(enabled)
        self.maxlen = int(maxlen)
        self._clock = clock
        self.t_origin = clock()
        self._spans: collections.deque = collections.deque(maxlen=maxlen)
        self._recorded = 0                  # total ever, for `dropped`
        self._local = threading.local()
        self._tracks: Dict[str, int] = {}   # synthetic track -> tid
        self._lock = threading.Lock()       # track map + export only

    # ----------------------------------------------------------- record
    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, span: Span) -> None:
        self._spans.append(span)            # GIL-atomic; ring drops old
        self._recorded += 1

    def span(self, name: str, cat: str = "serve",
             **args):
        """Context manager timing one span on the current thread.
        Nested ``span`` calls record their depth and parent. ``args``
        land in the exported event (more can be added on the yielded
        span object: ``with tracer.span("x") as sp: sp.args[...]``,
        guarded by ``if sp`` since a disabled tracer yields None)."""
        if not self.enabled:
            return _NULL_SPAN
        return _ActiveSpan(self, name, cat, args or {})

    def add(self, name: str, t_start: float, t_end: float, *,
            track: str = "host", cat: str = "serve",
            args: Optional[dict] = None) -> None:
        """Record a span from explicit timestamps (same clock as the
        tracer's) onto a named synthetic track — e.g. the device
        timeline, whose compute window is only known after the host
        blocks on the result."""
        if not self.enabled:
            return
        with self._lock:
            tid = self._tracks.get(track)
            if tid is None:
                tid = _TRACK_BASE + len(self._tracks)
                self._tracks[track] = tid
        self._record(Span(name=name, cat=cat, t_start=t_start,
                          t_end=t_end, tid=tid, args=args))

    # ---------------------------------------------------------- readout
    def __len__(self) -> int:
        return len(self._spans)

    @property
    def dropped(self) -> int:
        """Spans that fell off the ring buffer."""
        return max(0, self._recorded - self.maxlen)

    def events(self) -> List[Span]:
        """Snapshot of the retained spans, oldest first."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._recorded = 0

    # ----------------------------------------------------------- export
    def chrome_events(self) -> List[dict]:
        """The retained spans as Chrome trace-event dicts (``ph: "X"``
        complete events, ``ts``/``dur`` in microseconds since the
        tracer's origin) plus thread-name metadata for the synthetic
        tracks."""
        t0 = self.t_origin
        out = []
        with self._lock:
            tracks = dict(self._tracks)
            spans = list(self._spans)
        for track, tid in tracks.items():
            out.append({"ph": "M", "pid": 0, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": track}})
        for s in spans:
            ev = {"ph": "X", "pid": 0, "tid": s.tid, "name": s.name,
                  "cat": s.cat, "ts": (s.t_start - t0) * 1e6,
                  "dur": max(s.t_end - s.t_start, 0.0) * 1e6}
            args = dict(s.args) if s.args else {}
            if s.parent is not None:
                args["parent"] = s.parent
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def to_chrome_trace(self, path: str) -> str:
        """Write the span buffer as Chrome trace-event JSON (openable
        in Perfetto / chrome://tracing); returns ``path``."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {"traceEvents": self.chrome_events(),
                   "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


# the shared disabled tracer: modules that take an optional tracer
# default to this, so call sites never branch on None
NULL_TRACER = Tracer(maxlen=1, enabled=False)
