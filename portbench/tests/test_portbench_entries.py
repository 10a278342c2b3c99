"""Whole runs of the four entries at tiny size on the CPU, judged by the
plain reference: sound runs come out correct, traced or not; the control
(the reference in the program's place at q = 2^640) and each fault these
cells can have, planted in the program underneath a run, come out not
correct.  No cell spans chips, so no exchange between chips can be left out."""

import json
import time

import pytest
import torch

from conftest import MIXES
from portbench import harness

SEED = (1 << 33) + 7


def run(tiny, kind, trace=False, seconds=0.4):
    root, b = tiny
    return harness.run_cell(b, f"tiny.{kind}", SEED, seconds, trace, "cpu", time.perf_counter(),
                            root=root)


def failing(result) -> list:
    return [k for k, c in result["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("kind", list(MIXES))
def test_sound_run_is_correct(tiny, kind, trace):
    _, b = tiny
    r = run(tiny, kind, trace)
    assert r["correct"] and not failing(r) and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks" and r["device"]["platform"] == "cpu"
    json.dumps(r)
    if not trace:
        want = {m["name"] for m in b["end_to_end"] if f"tiny.{kind}" in m.get("workloads", [
            f"tiny.{kind}"])}
        assert set(r["metrics"]) == want
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:  # the CPU has no device trace: only the host spans' metrics read anything
        assert set(r["metrics"]) <= {"polys_host_ms.prove", "ssp_ms.setup"}
        assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.mark.parametrize("kind", list(MIXES))
def test_control_is_not_correct(tiny, kind):
    root, b = tiny
    cell = harness.Cell.find(b, f"tiny.{kind}", root)
    cpu = torch.device("cpu")
    ctx = harness.Context(cell, SEED, cpu, harness.Spans(False, cpu))
    first = int(cell.traffic["warm"])
    answers = harness.control_answers(ctx, range(first, first + 40), 640)
    checks = cell.entry.judge(ctx, answers)
    assert any(v > limit for _, v, limit in checks), checks


def _flip(blob: bytes, pos: int) -> bytes:
    out = bytearray(blob)
    out[pos % len(out)] ^= 0x01
    return bytes(out)


def _stale(fn):
    """The first result, returned for every later call: a step that leaves
    its state unchanged."""
    first = []

    def stale(*args, **kwargs):
        if not first:
            first.append(fn(*args, **kwargs))
        return first[0]

    return stale


def _plant(monkeypatch, kind: str, fault: str) -> None:
    from c_lwe_snarks_tpu_torch.models import lwe, snark
    from c_lwe_snarks_tpu_torch.utils import serial

    if kind == "prove_batch" and fault in ("altered", "stale", "half"):
        kind = "prove"  # the batch entry's proofs come from the same prover, one a request
    if (kind, fault) == ("prove", "altered"):
        f = serial.proof_to_bytes
        monkeypatch.setattr(serial, "proof_to_bytes", lambda pi, P: _flip(f(pi, P), 4000))
    elif (kind, fault) == ("prove", "stale"):
        monkeypatch.setattr(snark, "prover", _stale(snark.prover))
    elif (kind, fault) == ("prove", "half"):
        f = lwe.eval_poly_multi

        def half(key, off, b_rows, coeffs, params, **kw):
            coeffs = coeffs.clone()
            coeffs[:, coeffs.shape[1] // 2 :] = 0  # the second half of the terms left out
            return f(key, off, b_rows, coeffs, params, **kw)

        monkeypatch.setattr(lwe, "eval_poly_multi", half)
    elif (kind, fault) == ("prove", "fails"):
        f, calls = snark.prover, []

        def sometimes(*args, **kwargs):
            calls.append(1)
            if len(calls) % 5 == 4:  # the first request of the window (after 3 warm), and 1 in 5
                raise RuntimeError("a proof that fails")
            return f(*args, **kwargs)

        monkeypatch.setattr(snark, "prover", sometimes)
    elif (kind, fault) == ("setup", "altered"):
        f = serial.crs_to_bytes
        monkeypatch.setattr(serial, "crs_to_bytes", lambda crs, P: _flip(f(crs, P), 777))
    elif (kind, fault) == ("setup", "stale"):
        monkeypatch.setattr(snark, "setup", _stale(snark.setup))
    elif (kind, fault) == ("setup", "half"):
        f = lwe.encrypt_section

        def half(*args, **kw):
            rows = f(*args, **kw).clone()
            rows[rows.shape[0] // 2 :] = 0  # the second half of the encryptions left out
            return rows

        monkeypatch.setattr(lwe, "encrypt_section", half)
    elif (kind, fault) == ("verify", "altered"):
        f = snark.verifier
        monkeypatch.setattr(snark, "verifier", lambda *a: ~f(*a))
    elif (kind, fault) == ("verify", "stale"):
        monkeypatch.setattr(snark, "verifier", _stale(snark.verifier))
    elif (kind, fault) == ("prove_batch", "statement0"):
        f, first = snark.prover, []

        def statement0(crs_key, ent_key, off, crs, inst, witness, P, **kw):
            first[:] = first or [witness]  # the warm-up's first request is statement 0's
            return f(crs_key, ent_key, off, crs, inst, first[0], P, **kw)

        monkeypatch.setattr(snark, "prover", statement0)
    elif (kind, fault) == ("prove_batch", "rowsum0"):
        f, first = snark.prover_polys, []

        def rowsum0(ent_key, off, inst, witness, P, **kw):
            first[:] = first or [witness]  # every row-sum over statement 0's gates
            return f(ent_key, off, inst, first[0], P, **kw)

        monkeypatch.setattr(snark, "prover_polys", rowsum0)
    elif (kind, fault) in (("prove_batch", "swapped"), ("prove_batch", "half_batch")):

        def batch(crs_key, ent_key, offsets, crs, inst, witnesses, P):
            proofs = [snark.prover(crs_key, ent_key, off, crs, inst, w, P)
                      for off, w in zip(offsets, witnesses)]
            if fault == "half_batch":
                return proofs[: len(proofs) // 2]  # the second half of the requests unanswered
            for k in range(0, len(proofs) - 1, 2):  # each pair of answers swapped
                proofs[k], proofs[k + 1] = proofs[k + 1], proofs[k]
            return proofs

        monkeypatch.setattr(snark, "prover_batch", batch, raising=False)
    else:
        raise AssertionError((kind, fault))


@pytest.mark.parametrize("kind,fault", [
    ("prove", "altered"), ("prove", "stale"), ("prove", "half"), ("prove", "fails"),
    ("setup", "altered"), ("setup", "stale"), ("setup", "half"),
    ("verify", "altered"), ("verify", "stale"),
    ("prove_batch", "altered"), ("prove_batch", "stale"), ("prove_batch", "half"),
    ("prove_batch", "statement0"), ("prove_batch", "rowsum0"), ("prove_batch", "swapped"),
    ("prove_batch", "half_batch")])
def test_planted_fault_is_not_correct(tiny, monkeypatch, kind, fault):
    _plant(monkeypatch, kind, fault)
    # requests a call leaves unanswered fail when the call ends, and the window's first request is
    # statement 0's, which a fault on the other statements leaves right: a window that outlasts one call
    long = fault in ("half_batch", "statement0", "rowsum0")
    r = run(tiny, kind, seconds=5.0 if long else 0.4)
    assert not r["correct"] and failing(r), r["checks"]
    assert (r["failed"] > 0) == (fault in ("fails", "half_batch"))


def test_new_files_are_found_by_name(tiny, tmp_path):
    """A mix and a metric added as files, and a cell that names them, run
    with no other file edited."""
    import shutil

    root, b = tiny
    mine = tmp_path / "bench"
    shutil.copytree(root / "portbench", mine / "portbench")
    (mine / "portbench" / "traffic" / "prove_two.json").write_text(json.dumps(
        {"entry": "prove", "warm": 1, "check": 2, "trace_seconds": 1}))
    (mine / "portbench" / "metrics" / "attempts_seen.py").write_text(
        "def read(r):\n    return float(r.requests)\n")
    b = json.loads(json.dumps(b))
    b["workloads"].append({"name": "tiny.prove_two", "config": "tiny", "traffic": "prove_two",
                           "chips": 1, "why": "a new mix"})
    b["end_to_end"].append({"name": "attempts_seen", "unit": "proofs", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["tiny.prove_two"]})
    for m in b["end_to_end"]:
        if m["name"] == "proofs_per_s":
            m["workloads"].append("tiny.prove_two")
    r = harness.run_cell(b, "tiny.prove_two", SEED, 0.3, False, "cpu", time.perf_counter(),
                         root=mine)
    assert r["correct"] and r["metrics"]["attempts_seen"]["value"] == r["attempted"]
    assert set(r["metrics"]) == {"attempts_seen", "proofs_per_s", "setup_s"}
