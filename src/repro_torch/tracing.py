"""Spans and counters of the simulator's driver, and the kernels' launch
counters.

Two kinds of counter live here:

* :class:`LaunchCount` — always on: a kernel's wrapper adds one where it
  launches its kernel (``kernels.router_phase.LAUNCHES``,
  ``kernels.cache_phase.LAUNCHES``, ``kernels.flash_attention.LAUNCHES``),
  so a run can show that it went through the kernel.
* :data:`RECORDER`'s counters — switched: :meth:`Recorder.count` adds to
  a named integer only while the recorder is on.

:data:`RECORDER` is off unless a profiling tool switches it on.  Off,
:meth:`Recorder.span` costs one attribute check and returns a shared
no-op context, and :meth:`Recorder.count` one check; nothing is
allocated.  On, each span records its name, its id, its parent's id, the
scenario and cycle it belongs to (set by the driver with
:meth:`Recorder.at`), and its start and end in nanoseconds of
``time.time_ns()``: the Unix-epoch clock that the PyTorch profiler (kineto)
stamps its events with, so a span lines up with the profiler's records of
the same interval without an offset.  Spans stay in memory until
:meth:`Recorder.drain` hands them out.

The driver's spans (``core/sim.py``): ``step`` (one simulated cycle over
every scenario) holds each scenario's ``cycle`` and the ``monitor``
(termination predicate and progress monitors); ``cycle`` holds ``cast``
(the state widened on entry; the statistics folded and the state
narrowed on exit), ``phase1a``, ``phase1b``, ``phase2`` and ``phase3``
(on the card, where the cycle is stepped in place, ``phase1``, the
cache-phase kernel's launch, in place of ``phase1a`` and ``phase1b``)
where the cycle runs eagerly or is captured as a CUDA graph, and
``replay`` where the captured graph is replayed; ``check`` is each
termination check read back to the host.  The counter ``host_syncs``
counts the driver's reads of a device value to the host,
``graph_captures`` the scenarios' cycles captured as CUDA graphs (one a
scenario a drive on a CUDA device) and ``graph_replays`` the
scenario-cycles replayed from them.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

__all__ = ["LaunchCount", "Span", "Recorder", "RECORDER", "self_ns",
           "innermost"]


class LaunchCount:
    """A plain launch counter, always on; :meth:`reset` before a run, read
    ``n`` after.  Each kernel's wrapper adds one where it launches its
    kernel.  The switched counters of a profiled interval are
    :meth:`Recorder.count`'s."""

    def __init__(self):
        self.n = 0

    def reset(self) -> None:
        self.n = 0


class Span(NamedTuple):
    """One closed span.  ``parent`` is the id of the span that was open
    when it opened (``None`` at the top, or where that span opened before
    the recorder was switched on); ``scenario`` and ``cycle`` are the
    driver's position (:meth:`Recorder.at`), ``scenario`` ``None`` for
    work over every scenario.  Times are ``time.time_ns()``."""

    name: str
    id: int
    parent: Optional[int]
    scenario: Optional[int]
    cycle: Optional[int]
    start_ns: int
    end_ns: int


class _Off:
    """The context :meth:`Recorder.span` returns while the recorder is
    off: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Open:
    """A span being recorded."""

    __slots__ = ("rec", "name", "id", "parent", "scenario", "cycle",
                 "epoch", "start")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> None:
        rec = self.rec
        self.id = rec._next
        rec._next += 1
        self.parent = rec._stack[-1] if rec._stack else None
        self.scenario, self.cycle = rec.scenario, rec.cycle
        self.epoch = rec._epoch
        rec._stack.append(self.id)
        self.start = time.time_ns()

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        rec = self.rec
        # a span still open when the recorder was switched off is dropped
        if not rec.on or self.epoch != rec._epoch:
            return
        rec._stack.pop()
        rec.spans.append(Span(self.name, self.id, self.parent, self.scenario,
                              self.cycle, self.start, end))


class Recorder:
    """In-memory spans and switched counters of the simulator's driver.

    :meth:`start` and :meth:`stop` switch it on and off; spans opened
    while on and closed before :meth:`stop` are kept, and the counters
    add while on.  :meth:`drain` hands both out and empties them."""

    def __init__(self):
        self.on = False
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.scenario: Optional[int] = None
        self.cycle: Optional[int] = None
        self._stack: List[int] = []
        self._next = 0
        self._epoch = 0

    def start(self) -> None:
        """Switch on."""
        self._epoch += 1
        self._stack = []
        self.on = True

    def stop(self) -> None:
        """Switch off; spans still open are dropped."""
        self.on = False
        self._stack = []

    def at(self, scenario: Optional[int], cycle: Optional[int]) -> None:
        """The driver's position, which spans opened from now on carry:
        the scenario's index (``None`` for work over every scenario) and
        the cycle being stepped (the host's clock)."""
        self.scenario, self.cycle = scenario, cycle

    def span(self, name: str):
        """A context manager that records a span named ``name`` while the
        recorder is on, and does nothing while it is off."""
        if not self.on:
            return _OFF
        return _Open(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` while the recorder is on."""
        if self.on:
            self.counters[name] = self.counters.get(name, 0) + n

    def drain(self) -> Tuple[List[Span], Dict[str, int]]:
        """The closed spans, in the order they closed, and the counters;
        both are emptied."""
        spans, counters = self.spans, self.counters
        self.spans, self.counters = [], {}
        return spans, counters


#: the process's recorder, off until a profiling tool switches it on
RECORDER = Recorder()


def self_ns(spans: Sequence[Span]) -> Dict[str, int]:
    """Nanoseconds of self time summed by span name: each span's duration
    less the durations of its recorded children."""
    child: Dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            child[s.parent] = child.get(s.parent, 0) + s.end_ns - s.start_ns
    out: Dict[str, int] = {}
    for s in spans:
        out[s.name] = (out.get(s.name, 0) + s.end_ns - s.start_ns
                       - child.get(s.id, 0))
    return out


def innermost(spans: Sequence[Span], times_ns: Sequence[Optional[int]]
              ) -> List[Optional[Span]]:
    """For each instant of ``times_ns`` (``time.time_ns()`` nanoseconds),
    the innermost span open at it, or ``None`` (also for a ``None``
    instant).  The spans nest, as one thread's spans do; an instant at a
    span's start or end is inside it."""
    order = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    todo = sorted((t, j) for j, t in enumerate(times_ns) if t is not None)
    out: List[Optional[Span]] = [None] * len(times_ns)
    stack: List[Span] = []
    i = 0
    for t, j in todo:
        while i < len(order) and order[i].start_ns <= t:
            while stack and stack[-1].end_ns < order[i].start_ns:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1].end_ns < t:
            stack.pop()
        out[j] = stack[-1] if stack else None
    return out
