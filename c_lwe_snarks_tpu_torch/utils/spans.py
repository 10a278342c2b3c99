"""Spans and counters at the port's layer boundaries.

``with span("lwe.prover"):`` marks a stage.  Tracing is on while torch's
profiler records (``torch.autograd.profiler._is_profiler_enabled``, which
torch sets from its own profiler-start and -stop callbacks) or inside a
``recording()`` block, which gives the host spans without the profiler's
cost.  Off, a span's enter and exit each check that flag and return: no
clock is read, ``record_function`` is not entered (it costs ~8 us a call
even with no profiler running) and nothing is kept.  On, a span

* opens ``torch.profiler.record_function(name)`` while the profiler
  records, so that it stands in the profile on the device trace's clock;
* keeps a ``Record``: its name, start and end by ``time.perf_counter()``,
  the index of its parent span, its request (the index of the outermost
  span open, so every span of one call into the port shares it), and the
  launches, host syncs, seconds waited for the card's earlier work,
  staged copies and new pinned buffers counted while it was open (its
  children's included).

Launches are the sum of the ``LAUNCHES`` dicts that ``ops/`` registers with
``count_launches``; host syncs are the calls of ``sync(site, device)`` made
where the port's host waits on the device.  Both count only while tracing
is on, on any device.  On a card, ``sync`` then also waits for the stream's
earlier work itself, timed, before the call that would have waited for it,
so that a span's own host time (its duration less the time waited) shows
apart from the device work it waits for.  Staged copies are the calls of
``staged(site, buf, pinned)`` made where a whole artifact crosses between
the host and the device through one host buffer; a new pinned buffer is
such a buffer, page-locked, at an address no staged copy has used before
(the caching host allocator made it for this call rather than reusing
one).  They too count only while tracing is on; the addresses are kept on
every call, so a block first used while tracing was off is not new.  The
recorder is one per process, as the profiler is, and follows the thread
that issues the port's work.

This module imports nothing of the port, so that every module of the port
can import it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.autograd.profiler as _profiler

_launch_counters: list[dict] = []
_records: list = []
_open: list[int] = []  # indices of the open spans, outermost first
_sync_sites: dict[str, int] = {}
_staged_sites: dict[str, dict[str, int]] = {}
_pinned_seen: set[int] = set()  # addresses of the pinned buffers staged through
_syncs = 0
_waited = 0.0
_staged = 0
_pinned_new = 0
_recording = 0


@dataclasses.dataclass(slots=True)
class Record:
    """One span as it ran; ``end`` is None while it is open."""

    name: str
    start: float
    end: float | None
    parent: int  # index of the enclosing span, -1 for an outermost one
    request: int  # index of the outermost span open when it began
    launches: int
    syncs: int
    waited: float  # seconds the host waited at its syncs for the card's earlier work
    staged: int = 0  # copies of a whole artifact through one host buffer
    pinned_new: int = 0  # of those, through a pinned buffer not used before


def _launched() -> int:
    return sum(sum(c.values()) for c in _launch_counters)


class span:
    """Context manager marking one stage of the port (module docstring)."""

    __slots__ = ("name", "_rec", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rec = None

    def __enter__(self):
        if _recording or _profiler._is_profiler_enabled:
            self._begin()
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._end()
        return False

    def _begin(self) -> None:
        start = time.perf_counter()
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        i = len(_records)
        self._rec = Record(self.name, start, None, _open[-1] if _open else -1,
                           _open[0] if _open else i, -_launched(), -_syncs, -_waited,
                           -_staged, -_pinned_new)
        _records.append(self._rec)
        _open.append(i)

    def _end(self) -> None:
        rec, self._rec = self._rec, None
        _open.pop()
        rec.launches += _launched()
        rec.syncs += _syncs
        rec.waited += _waited
        rec.staged += _staged
        rec.pinned_new += _pinned_new
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        rec.end = time.perf_counter()


def count_launches(counter: dict) -> dict:
    """Count the launches of ``counter`` (a module's ``LAUNCHES``: kernel
    name -> launches) in every span; returns it."""
    _launch_counters.append(counter)
    return counter


def sync(site: str, device, n: int = 1) -> None:
    """Count ``n`` waits of the host on ``device`` at ``site``; called just
    before the call that waits.  On a card, wait here for the current
    stream's earlier work and time it (module docstring)."""
    global _syncs, _waited
    if _recording or _profiler._is_profiler_enabled:
        _syncs += n
        _sync_sites[site] = _sync_sites.get(site, 0) + n
        device = torch.device(device)
        if device.type == "cuda":
            t0 = time.perf_counter()
            torch.cuda.current_stream(device).synchronize()
            _waited += time.perf_counter() - t0


def staged(site: str, buf: torch.Tensor, pinned: bool) -> None:
    """Count one copy of a whole artifact between the host and the device
    through the host buffer ``buf`` (the whole allocation) at ``site``, and,
    where ``pinned``, whether ``buf`` is a new pinned buffer (module
    docstring); called once the copy is issued."""
    global _staged, _pinned_new
    new = False
    if pinned:
        ptr = buf.data_ptr()
        new = ptr not in _pinned_seen
        _pinned_seen.add(ptr)
    if _recording or _profiler._is_profiler_enabled:
        _staged += 1
        _pinned_new += new
        c = _staged_sites.setdefault(site, {"copies": 0, "pinned_new": 0})
        c["copies"] += 1
        c["pinned_new"] += new


@contextlib.contextmanager
def recording():
    """Turn the recorder on inside the block without the profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def records() -> list:
    """Every span kept since the last ``reset()``, in the order they began."""
    return list(_records)


def sync_sites() -> dict:
    """Host syncs counted since the last ``reset()``, by site."""
    return dict(_sync_sites)


def staged_sites() -> dict:
    """Staged copies and new pinned buffers counted since the last
    ``reset()``, by site: {site: {"copies": n, "pinned_new": k}}."""
    return {site: dict(c) for site, c in _staged_sites.items()}


def reset() -> None:
    """Drop the records and the sites' counts; no span may be open."""
    if _open:
        raise RuntimeError(f"reset with {len(_open)} span(s) open")
    _records.clear()
    _sync_sites.clear()
    _staged_sites.clear()


def summary(since: int = 0) -> dict:
    """By span name, over the closed records from index ``since`` on: calls,
    total and self seconds (the duration less what its child spans cover),
    and launches, host syncs, seconds waited, staged copies and new pinned
    buffers (children's included)."""
    recs = _records[since:]
    covered = [0.0] * len(recs)
    for r in recs:
        if r.end is not None and r.parent >= since:
            covered[r.parent - since] += r.end - r.start
    out = {}
    for r, child_s in zip(recs, covered):
        if r.end is None:
            continue
        s = out.setdefault(r.name, {"calls": 0, "total_s": 0.0, "self_s": 0.0, "launches": 0,
                                    "host_syncs": 0, "waited_s": 0.0, "staged": 0,
                                    "pinned_new": 0})
        s["calls"] += 1
        s["total_s"] += r.end - r.start
        s["self_s"] += r.end - r.start - child_s
        s["launches"] += r.launches
        s["host_syncs"] += r.syncs
        s["waited_s"] += r.waited
        s["staged"] += r.staged
        s["pinned_new"] += r.pinned_new
    return out
