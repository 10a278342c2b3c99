"""The program's own spans and counters (``c_lwe_snarks_tpu_torch.utils.spans``)
as the metric readers read them, and their place on the device trace's clock.

The program keeps its records by ``time.perf_counter()``, the clock of the
harness's ``Spans.records``; the profiler's events are on a clock of its own.
The benchmark's ``request`` span stands on both, so each request gives an
offset between the two (the mean of its start's and its end's), and the
median of the window's offsets maps every program record onto the trace.
The offsets' spread (the largest less the least) is the mapping's error.

Every reader here reads the traced run on the card only, and reads nothing
(None) where the program has no recorder or kept no record, or where the
trace holds no device item (on the CPU the plain versions run, whose
launches and syncs are not the card's).
"""

from __future__ import annotations

import statistics
import sys

from portbench import trace as tracing

SERIAL = "lwe.serial."


def records(r) -> list | None:
    """The program's span records inside the run's requests, in the order
    they began, or None."""
    requests = [(s, e) for n, s, e in r.spans.records if n == "request"]
    if r.trace is None or not r.trace.device or not r.requests or not requests:
        return None
    try:
        from c_lwe_snarks_tpu_torch.utils import spans
    except ImportError:  # a program older than its recorder
        return None
    lo, hi = min(s for s, _ in requests), max(e for _, e in requests)
    recs = [x for x in spans.records() if x.end is not None and lo <= x.start and x.end <= hi]
    return recs or None


def per_request(r, field: str) -> float | None:
    """``field`` (``launches`` or ``syncs``) summed over the outermost program
    spans, a request."""
    recs = records(r)
    if recs is None:
        return None
    return sum(getattr(x, field) for x in recs if x.parent < 0) / r.requests


def host_ms(r, match) -> float | None:
    """Host milliseconds a request in the spans whose name ``match`` accepts
    (no two of which nest), less what they waited for the card's earlier
    work (``Record.waited``); None if there is none."""
    recs = records(r)
    if recs is None:
        return None
    picked = [x for x in recs if match(x.name)]
    if not picked:
        return None
    return 1e3 * sum(x.end - x.start - x.waited for x in picked) / r.requests


def clock_offset(r) -> tuple[float, float, int] | None:
    """(trace time less perf_counter time, the spread of that offset over the
    requests, in seconds; the requests) from the ``request`` spans; None
    unless both clocks hold the same requests."""
    host = sorted((s, e) for n, s, e in r.spans.records if n == "request")
    dev = sorted((s, e) for n, s, e in r.trace.spans if n == "request")
    if not host or len(host) != len(dev):
        return None
    offs = [((ts - hs) + (te - he)) / 2 for (hs, he), (ts, te) in zip(host, dev)]
    return statistics.median(offs), max(offs) - min(offs), len(offs)


def gaps(trace) -> list:
    """[(start, end)] of the gaps between the device's busy intervals in the
    traced window, as ``trace.Trace.idle_gaps`` finds them."""
    busy = tracing.union([(s, e) for _, s, e in trace.device])
    edges = [trace.window[0]] + [x for iv in busy for x in iv] + [trace.window[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def idle_by_span(r) -> dict | None:
    """{the innermost program span open when a gap began (None: none open):
    idle seconds} over the traced window, the program's records put on the
    trace's clock; the offset and its spread are said on standard error."""
    recs = records(r)
    clock = None if recs is None else clock_offset(r)
    if clock is None:
        return None
    off, spread, n = clock
    print(f"portbench: program spans on the trace's clock: offset {off:.6f} s, spread "
          f"{1e6 * spread:.1f} us over {n} requests", file=sys.stderr)
    out, stack, j = {}, [], 0
    for g0, g1 in gaps(r.trace):
        while j < len(recs) and recs[j].start + off <= g0:
            stack.append(recs[j])
            j += 1
        while stack and stack[-1].end + off <= g0:
            stack.pop()
        name = stack[-1].name if stack else None
        out[name] = out.get(name, 0.0) + (g1 - g0)
    return out
