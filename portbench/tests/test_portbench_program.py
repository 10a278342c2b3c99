"""The readers of the program's own spans and counters (``program.py`` and
the metrics that read it), on a synthetic traced run whose device trace is
on a clock 100 s ahead of the host's."""

import sys

import pytest
import torch

from c_lwe_snarks_tpu_torch import utils
from c_lwe_snarks_tpu_torch.utils import spans
from conftest import ROOT
from portbench import harness, program
from portbench.trace import Trace

OFFSET = 100.0
READERS = ["polys_idle_ms.prove", "serial_host_ms.prove", "serial_host_ms.setup",
           "serial_host_ms.verify", "verifier_host_ms.verify", "launches.prove", "launches.setup",
           "launches.verify", "host_syncs.prove", "host_syncs.setup", "host_syncs.verify"]


def _rec(name, start, end, parent, request, launches=0, syncs=0, waited=0.0):
    return spans.Record(name, start, end, parent, request, launches, syncs, waited)


def _proof(t, i):
    """The program's records of one proof that starts at host time t, the
    first of them at index i: [(record)], its gaps on the trace's clock."""
    recs = [
        _rec("lwe.prover", t + 0.0001, t + 0.0090, -1, i, launches=30, syncs=1),
        _rec("lwe.prover.polys", t + 0.0002, t + 0.0030, i, i, launches=25, syncs=1),
        _rec("lwe.prover.evals", t + 0.0030, t + 0.0080, i, i, launches=2),
        _rec("lwe.prover.smudge", t + 0.0080, t + 0.0090, i, i, launches=3),
        _rec("lwe.serial.proof_to_bytes", t + 0.0091, t + 0.0099, -1, i + 4, syncs=1,
             waited=0.0002),
    ]
    device = [("k7", t + 0.0004, t + 0.0010), ("k6", t + 0.0015, t + 0.0029),
              ("k3", t + 0.0031, t + 0.0089), ("copy", t + 0.0092, t + 0.0094)]
    return recs, [(n, s + OFFSET, e + OFFSET) for n, s, e in device]


def _run(monkeypatch, recs_fn=_proof, requests=2, trace=True):
    records, device, bench, tspans = [], [], harness.Spans(True, torch.device("cpu")), []
    for k in range(requests):
        t = 1.0 + 0.01 * k
        recs, dev = recs_fn(t, len(records))
        records += recs
        device += dev
        bench.records.append(("request", t, t + 0.01))
        # the profiler's range opens a little before the host's clock is read
        tspans.append(("request", t + OFFSET - 2e-6 * (k + 1), t + 0.01 + OFFSET + 1e-6))
    monkeypatch.setattr(spans, "records", lambda: list(records))
    r = harness.Record({}, 0.0, 0.02 * requests, requests, [0.01] * requests, bench)
    if trace:
        r.trace = Trace((1.0 + OFFSET, 1.0 + 0.01 * requests + OFFSET), device, tspans)
    return r


def _read(name, r):
    return harness.load_module(harness.metric_file(name)).read(r)


def test_the_clock_offset_and_its_spread(monkeypatch):
    off, spread, n = program.clock_offset(_run(monkeypatch, requests=3))
    assert n == 3 and off == pytest.approx(OFFSET - 1.5e-6, abs=1e-9)
    assert spread == pytest.approx(2e-6, abs=1e-9)


def test_polys_idle_gives_each_gap_to_its_innermost_span(monkeypatch):
    r = _run(monkeypatch)
    idle = program.idle_by_span(r)
    # ms from a proof's start: 0 to 0.4 before any span opens (the first proof only); 1.0
    # to 1.5 and 2.9 to 3.1 in lwe.prover.polys; 8.9 to 9.2 in lwe.prover.smudge, the
    # innermost of the two open; from 9.4 in proof_to_bytes, to the next proof's first
    # device item at 10.4, or to the window's end at 10.0
    want = {None: 0.4, "lwe.prover.polys": 1.4, "lwe.prover.smudge": 0.6,
            "lwe.serial.proof_to_bytes": 1.6}
    assert set(idle) == set(want)
    for name, ms in want.items():
        assert 1e3 * idle[name] == pytest.approx(ms, abs=1e-6), name
    assert _read("polys_idle_ms.prove", r) == pytest.approx(0.7, abs=1e-6)
    assert sum(idle.values()) == pytest.approx(sum(s for _, s in r.trace.idle_gaps()), abs=1e-12)


def test_host_time_and_counts_a_request(monkeypatch):
    r = _run(monkeypatch)
    assert _read("serial_host_ms.prove", r) == pytest.approx(0.6, abs=1e-6)  # 0.2 ms waited
    assert _read("launches.prove", r) == 30
    assert _read("host_syncs.prove", r) == 2
    assert _read("verifier_host_ms.verify", r) is None  # no such span in a proof


def test_records_outside_the_requests_are_not_read(monkeypatch):
    def with_stray(t, i):
        recs, dev = _proof(t, i)
        return recs + [_rec("lwe.prover", t + 5.0, t + 5.1, -1, i + 5, launches=999)], dev

    r = _run(monkeypatch, with_stray)
    assert _read("launches.prove", r) == 30


@pytest.mark.parametrize("name", READERS)
def test_every_reader_reads_nothing_when_nothing_was_recorded(monkeypatch, name):
    assert _read(name, _run(monkeypatch, lambda t, i: ([], [("k", t, t + 0.001)]))) is None
    assert _read(name, _run(monkeypatch, trace=False)) is None
    r = _run(monkeypatch)
    r.trace.device = []  # a run on the CPU
    assert _read(name, r) is None
    r = _run(monkeypatch)
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "c_lwe_snarks_tpu_torch.utils.spans", None)
    assert _read(name, r) is None  # a program without the recorder


@pytest.mark.parametrize("kind", ["prove", "setup", "verify"])
def test_the_one_file_readers_are_found_for_every_cell(kind):
    metrics = ROOT / "portbench" / "metrics"
    for name in ("serial_host_ms", "launches", "host_syncs"):
        assert harness.metric_file(f"{name}.{kind}") == metrics / f"{name}.py"
    assert harness.metric_file("polys_idle_ms.prove") == metrics / "polys_idle_ms.prove.py"
    assert harness.metric_file("verifier_host_ms.verify") == metrics / "verifier_host_ms.verify.py"
