"""The harness's clients and ``serve``, the batch entry's circuit of W
statements, and the roofline of a sweep shared by the outstanding proofs,
on the CPU at tiny size (m = 64, so that W - 1 pivot rows are free)."""

import json
import sys
import time

import pytest
import torch

from conftest import ROOT
from portbench import harness, roofline
from portbench.reference import protocol as ref
from portbench.reference.aes import Stream
from portbench.trace import Trace

SEED = (1 << 33) + 11


class Clock:
    """A host clock that moves only when a fake request does its work."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _ctx(traffic, entry, spans_on=True):
    cell = harness.Cell("fake", 1, "fake", {}, traffic, entry, [], [])
    cpu = torch.device("cpu")
    return harness.Context(cell, SEED, cpu, harness.Spans(spans_on, cpu))


def legacy_closed_loop(ctx, state, first, seconds):
    """The one-client loop the harness had before it took clients, kept here
    word for word as the yardstick of the one-client case."""
    kept, lat, failed = harness.Reservoir(ctx), [], 0
    t0 = harness.time.perf_counter()
    i = first
    while True:
        start = harness.time.perf_counter()
        try:
            with ctx.spans("request"):
                answer = ctx.cell.entry.request(ctx, state, i)
        except Exception as exc:  # noqa: BLE001
            print(f"request {i} failed: {exc!r}", file=sys.stderr)
            answer, failed = None, failed + 1
        end = harness.time.perf_counter()
        lat.append(end - start)
        kept.offer(i, answer)
        i += 1
        if end - t0 >= seconds:
            return kept, lat, failed, end - t0


class Serial:
    """An entry with ``request`` alone: each request takes a second, and
    request i raises where ``fails(i)``."""

    def __init__(self, clock, fails=lambda i: False):
        self.clock, self.fails, self.seen = clock, fails, []

    def request(self, ctx, state, i):
        self.seen.append(i)
        self.clock.now += 1.0
        if self.fails(i):
            raise RuntimeError("a request that fails")
        return f"answer {i}"


def _one_client(monkeypatch, loop, fails=lambda i: False):
    clock = Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    entry = Serial(clock, fails)
    ctx = _ctx({"warm": 3}, entry)
    kept, lat, failed, window = loop(ctx, None, 3, 6.5)
    return entry.seen, kept.answers(), lat, failed, window, ctx.spans.records


def test_one_client_serves_as_before(monkeypatch):
    """With one client the loop issues the same requests in the same order,
    in the same spans, and ends its window at the same answer."""
    now = _one_client(monkeypatch, harness.closed_loop)
    assert now == _one_client(monkeypatch, legacy_closed_loop)
    seen, answers, lat, failed, window, records = now
    assert seen == list(answers) == [3, 4, 5, 6, 7, 8, 9] and failed == 0
    assert lat == [1.0] * 7 and window == 7.0
    assert records == [("request", float(k), float(k + 1)) for k in range(7)]


def test_one_client_counts_a_failed_request(monkeypatch):
    seen, answers, lat, failed, window, records = _one_client(
        monkeypatch, harness.closed_loop, lambda i: i % 5 == 4)
    assert seen == [3, 4, 5, 6, 7, 8, 9] and failed == 2 and lat == [1.0] * 7
    assert answers[4] is None and answers[9] is None and answers[5] == "answer 5"
    assert len(records) == 7  # a failed request's span is kept too


class Reversed:
    """An entry whose ``serve`` answers the requests handed to it in reverse
    order, a second each, and leaves request ``skip`` unanswered."""

    def __init__(self, clock, skip=None):
        self.clock, self.skip, self.calls = clock, skip, []

    def serve(self, ctx, state, indices):
        self.calls.append(list(indices))
        for i in reversed(indices):
            if i == self.skip:
                continue
            self.clock.now += 1.0
            yield i, f"answer {i}"


def test_three_clients_time_each_request_from_its_issue(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    entry = Reversed(clock)
    ctx = _ctx({"clients": 3, "warm": 0}, entry)
    kept, lat, failed, window = harness.closed_loop(ctx, None, 10, 4.5)
    # the first call answers 12, 11, 10 at 1, 2, 3; their clients issue 13, 14, 15 then; the
    # second call answers 15 at 4 (issued at 3) and 14 at 5 (issued at 2): past 4.5, so the
    # window ends there and 13, still in flight, is not counted
    assert entry.calls == [[10, 11, 12], [13, 14, 15]]
    assert lat == [1.0, 2.0, 3.0, 1.0, 3.0] and failed == 0 and window == 5.0
    assert list(kept.answers()) == [10, 11, 12, 14, 15]
    assert [n for n, _, _ in ctx.spans.records] == ["request", "request"]


def test_a_request_serve_leaves_unanswered_fails(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    entry = Reversed(clock, skip=11)
    ctx = _ctx({"clients": 3, "warm": 0}, entry)
    kept, lat, failed, _ = harness.closed_loop(ctx, None, 10, 2.5)
    # 12 at 1, 10 at 2; 11 fails when the call ends (at 2); the next call answers 15 at 3
    assert entry.calls == [[10, 11, 12], [13, 14, 15]]
    assert lat == [1.0, 2.0, 2.0, 1.0] and failed == 1
    assert kept.answers()[11] is None


def _batch_cell(tiny):
    root, b = tiny
    cell = harness.Cell.find(b, "tiny.prove_batch", root)
    cpu = torch.device("cpu")
    return cell, harness.Context(cell, SEED, cpu, harness.Spans(False, cpu))


@pytest.fixture(scope="module")
def prepared(tiny):
    cell, ctx = _batch_cell(tiny)
    return cell, ctx, cell.entry.prepare(ctx)


def test_the_statements_satisfy_the_circuit(prepared):
    from c_lwe_snarks_tpu_torch.models import ssp
    from c_lwe_snarks_tpu_torch.ops import modp, ntt, sampling

    cell, ctx, state = prepared
    P, W, v = state["P"], state["W"], state["ssp"].v
    wits0, inst0 = ssp.random_ssp(sampling.PRGKey(ctx.seed_bytes("entropy"), "cpu"), 0, P)
    assert torch.equal(state["wits"][0], wits0) and torch.equal(state["ssp"].t, inst0.t)
    changed = sorted(int(j) for j in torch.nonzero((v != inst0.v).any(1))[:, 0])
    piv = cell.entry.pivots(ctx, wits0.tolist(), W - 1, P.m)
    assert changed == sorted(piv) and W == 10 and len(set(piv)) == 9 and min(piv) >= 1
    t = state["ssp"].t.to(torch.int64)
    for b, bits in enumerate(state["wits"]):
        assert not bits[8 * (P.m // 8):].any()  # the draw's top bits stay zero
        assert [int(bits[j - 1]) for j in piv] == [int(k == b - 1) for k in range(W - 1)]
        gate = torch.cat([torch.ones(1, dtype=torch.uint8), bits[: P.m - 1]])
        vpre = modp.gated_rowsum_mod_p(v, gate)
        want = modp.mulmod_p(t, 1 + b)
        want[0] = (want[0] + 1) % modp.P
        assert torch.equal(vpre, want)  # v_0 + the gated rows = (1 + b) t + 1
        num = ntt.poly_mul_mod_p(vpre, vpre)
        num[0] = modp.submod_p(num[0], 1)
        h = ntt.poly_div_exact_mod_p(num, t, P.d)
        assert torch.equal(ntt.poly_mul_mod_p(h, t, num.shape[0]), num)  # h t = v^2 - 1
    rowsums = {tuple(modp.gated_rowsum_mod_p(v[1:], w[: P.m - 1]).tolist())
               for w in state["wits"]}
    assert len(rowsums) == W  # a row-sum of its own for every statement


def test_port_and_reference_derive_the_same_statements(prepared):
    cell, ctx, state = prepared
    RP, W = ctx.ref_params(), state["W"]
    ent = Stream(ctx.seed_bytes("entropy"), ctx.device)
    key = ref.vrs(ent, RP)
    piv = cell.entry.pivots(ctx, ref.witness_bits(ent, RP).tolist(), W - 1, RP.m)
    others = [ref.witness_bits(Stream(ctx.seed_bytes("witness", b), ctx.device), RP)
              for b in range(1, W)]
    circs = ref.statement_circuits(ent, RP, key.s, others, piv, keep_v=True)
    assert circs[0].v.numpy().astype("<u4").tobytes() == state["ssp"].v.numpy().tobytes()
    assert torch.equal(circs[0].t, state["ssp"].t.to(torch.int64))
    for b, circ in enumerate(circs):
        assert torch.equal(circ.wits, state["wits"][b]) and circ.scale == 1 + b
        ref.prover_coeffs(ent, RP, circ, RP.prove_offset(b))  # h t = v^2 - 1 at eight points
    gated = [(circs[0].v[1:] * c.wits[: RP.m - 1, None]).sum(0) % RP.p for c in circs]
    assert all(torch.equal(g, c.rowsum) for g, c in zip(gated, circs))


def test_a_sound_prover_batch_is_served_and_correct(tiny, monkeypatch):
    """The ``snark.prover_batch`` contract, met by proofs of ``snark.prover``:
    the entry calls it once for the requests handed to it, and the run comes
    out correct."""
    from c_lwe_snarks_tpu_torch.models import snark

    calls = []

    def prover_batch(crs_key, ent_key, offsets, crs, inst, witnesses, P):
        calls.append(len(offsets))
        return [snark.prover(crs_key, ent_key, off, crs, inst, w, P)
                for off, w in zip(offsets, witnesses)]

    monkeypatch.setattr(snark, "prover_batch", prover_batch, raising=False)
    root, b = tiny
    r = harness.run_cell(b, "tiny.prove_batch", SEED, 0.4, False, "cpu", time.perf_counter(),
                         root=root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert calls and set(calls) == {10}
    json.dumps(r)


def test_a_list_writer_is_called_once_a_serve_call(tiny, monkeypatch):
    """The ``serial.proofs_to_bytes`` contract, met through ``proof_to_bytes``:
    the entry writes each ``prover_batch`` call's proofs with one call of it,
    and the run comes out correct."""
    from c_lwe_snarks_tpu_torch.models import snark
    from c_lwe_snarks_tpu_torch.utils import serial

    batches, writes = [], []
    prover_batch = snark.prover_batch

    def counted_batch(*args):
        batches.append(1)
        return prover_batch(*args)

    def proofs_to_bytes(proofs, P):
        writes.append(len(proofs))
        return [serial.proof_to_bytes(pi, P) for pi in proofs]

    monkeypatch.setattr(snark, "prover_batch", counted_batch)
    monkeypatch.setattr(serial, "proofs_to_bytes", proofs_to_bytes, raising=False)
    root, b = tiny
    r = harness.run_cell(b, "tiny.prove_batch", SEED, 0.4, False, "cpu", time.perf_counter(),
                         root=root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert len(writes) == len(batches) >= 2 and set(writes) == {10}


def test_without_a_list_writer_each_proof_is_written_alone(prepared, monkeypatch):
    from c_lwe_snarks_tpu_torch.utils import serial

    cell, ctx, state = prepared
    monkeypatch.delattr(serial, "proofs_to_bytes", raising=False)
    one, writes = serial.proof_to_bytes, []

    def proof_to_bytes(pi, P):
        writes.append(1)
        return one(pi, P)

    monkeypatch.setattr(serial, "proof_to_bytes", proof_to_bytes)
    answers = list(cell.entry.serve(ctx, state, range(10, 20)))
    assert [i for i, _ in answers] == list(range(10, 20)) and len(writes) == 10
    assert all(isinstance(a, bytes) for _, a in answers)


def test_a_list_writer_that_raises_fails_the_whole_batch(tiny, monkeypatch):
    from c_lwe_snarks_tpu_torch.utils import serial

    def proofs_to_bytes(proofs, P):
        raise RuntimeError("a writer that fails")

    monkeypatch.setattr(serial, "proofs_to_bytes", proofs_to_bytes, raising=False)
    root, b = tiny
    r = harness.run_cell(b, "tiny.prove_batch", SEED, 0.4, False, "cpu", time.perf_counter(),
                         root=root)
    assert not r["correct"] and r["attempted"] > 0 and r["failed"] == r["attempted"]


def _read_k3(name, clients, sweeps_ms, proofs):
    """``name`` read from a traced window in which K3 ran once for each of
    ``sweeps_ms`` (its milliseconds) and ``proofs`` proofs were answered."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "release.json").read_text())
    k3 = "void eval_mac_kernel<3>(unsigned int const*)"
    device = [(k3, k * 0.1, k * 0.1 + ms / 1e3) for k, ms in enumerate(sweeps_ms)]
    rec = harness.Record(cfg, 1.0, 10.0, proofs, [0.1] * proofs, None,
                         Trace((0.0, 10.0), device, []), traffic={"clients": clients})
    return harness.load_module(harness.metric_file(name)).read(rec)


def test_k3_roofline_counts_one_sweep_for_every_client():
    """One reader for one client and for C: with C clients a proof's bound
    is a sweep of 5 C lanes over C."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "release.json").read_text())
    one = _read_k3("k3_roofline_pct.prove", 1, [24.84] * 16, 16)
    batch = _read_k3("k3_roofline_pct.prove", 10, [24.84] * 16, 16)
    assert one == pytest.approx(100 * roofline.eval_bound_ms(cfg) / 24.84)
    assert batch == pytest.approx(one / 10)  # a sweep a proof reads 1/C of the one-client share
    assert batch == pytest.approx(8.02, abs=0.01)
    # one sweep of all 10 proofs' 50 lanes that takes exactly its bound reads 100 %: a shared
    # sweep reads over 100 % only if it beats the least time the card could take
    bound = roofline.eval_bound_ms(cfg, lanes=50)
    assert _read_k3("k3_roofline_pct.prove", 10, [bound, bound], 20) == pytest.approx(100.0)
    assert _read_k3("k3_roofline_pct.prove", 10, [1.25 * bound] * 2, 20) == pytest.approx(80.0)
    assert _read_k3("k3_roofline_pct.prove", 10, [bound] * 2, 14) < 100  # 6 in flight at the end
    assert _read_k3("k3_roofline_pct.prove", 10, [], 20) is None
