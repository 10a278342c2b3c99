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


def _plant(monkeypatch, kind: str, fault: str) -> dict:
    """Plant ``fault`` under the program; returns {hook: the calls the run
    made of it}, counted for every hook set, so that a hook the timed path
    no longer calls shows as one never called."""
    from c_lwe_snarks_tpu_torch.models import lwe, snark
    from c_lwe_snarks_tpu_torch.utils import serial

    calls = {}

    def hook(obj, name, fn):
        calls[name] = 0

        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(obj, name, counted, raising=False)

    if kind == "prove_batch" and fault in ("altered", "half"):
        kind = "prove"  # the batch's proofs are written and evaluated by the same functions
    if (kind, fault) == ("prove", "altered"):
        f = serial.proof_to_bytes
        hook(serial, "proof_to_bytes", lambda pi, P: _flip(f(pi, P), 4000))
    elif (kind, fault) == ("prove", "stale"):
        hook(snark, "prover", _stale(snark.prover))
    elif (kind, fault) == ("prove", "half"):
        f = lwe.eval_poly_multi

        def half(key, off, b_rows, coeffs, params, **kw):
            coeffs = coeffs.clone()
            coeffs[:, coeffs.shape[1] // 2 :] = 0  # the second half of the terms left out
            return f(key, off, b_rows, coeffs, params, **kw)

        hook(lwe, "eval_poly_multi", half)
    elif (kind, fault) == ("prove", "fails"):
        f, seen = snark.prover, []

        def sometimes(*args, **kwargs):
            seen.append(1)
            if len(seen) % 5 == 4:  # the first request of the window (after 3 warm), and 1 in 5
                raise RuntimeError("a proof that fails")
            return f(*args, **kwargs)

        hook(snark, "prover", sometimes)
    elif (kind, fault) == ("setup", "altered"):
        f = serial.crs_to_bytes
        hook(serial, "crs_to_bytes", lambda crs, P: _flip(f(crs, P), 777))
    elif (kind, fault) == ("setup", "stale"):
        hook(snark, "setup", _stale(snark.setup))
    elif (kind, fault) == ("setup", "half"):
        f = lwe.encrypt_section

        def half(*args, **kw):
            rows = f(*args, **kw).clone()
            rows[rows.shape[0] // 2 :] = 0  # the second half of the encryptions left out
            return rows

        hook(lwe, "encrypt_section", half)
    elif (kind, fault) == ("verify", "altered"):
        f = snark.verifier
        hook(snark, "verifier", lambda *a: ~f(*a))
    elif (kind, fault) == ("verify", "stale"):
        hook(snark, "verifier", _stale(snark.verifier))
    elif (kind, fault) == ("prove_batch", "stale"):
        f, first = snark.prover_batch, []

        def stale(crs_key, ent_key, offsets, crs, inst, witnesses, P):
            first[:] = first or f(crs_key, ent_key, offsets, crs, inst, witnesses, P)
            return [first[k % len(first)] for k in range(len(offsets))]  # the first batch again

        hook(snark, "prover_batch", stale)
    elif (kind, fault) == ("prove_batch", "statement0"):
        f, first = snark.prover_batch, []

        def statement0(crs_key, ent_key, offsets, crs, inst, witnesses, P):
            first[:] = first or [witnesses[0]]  # the warm-up's first request is statement 0's
            return f(crs_key, ent_key, offsets, crs, inst, first * len(witnesses), P)

        hook(snark, "prover_batch", statement0)
    elif (kind, fault) == ("prove_batch", "rowsum0"):
        f, first = snark.prover_polys_batch, []

        def rowsum0(ent_key, offsets, inst, witnesses, P):
            first[:] = first or [witnesses[0]]  # every row-sum over statement 0's gates
            return f(ent_key, offsets, inst, first[0].repeat(witnesses.shape[0], 1), P)

        # prover_batch looks it up as a module global; the b_w lanes keep their own bits
        hook(snark, "prover_polys_batch", rowsum0)
    elif (kind, fault) in (("prove_batch", "swapped"), ("prove_batch", "half_batch")):

        def batch(crs_key, ent_key, offsets, crs, inst, witnesses, P):
            proofs = [snark.prover(crs_key, ent_key, off, crs, inst, w, P)
                      for off, w in zip(offsets, witnesses)]
            if fault == "half_batch":
                return proofs[: len(proofs) // 2]  # the second half of the requests unanswered
            for k in range(0, len(proofs) - 1, 2):  # each pair of answers swapped
                proofs[k], proofs[k + 1] = proofs[k + 1], proofs[k]
            return proofs

        hook(snark, "prover_batch", batch)
    elif (kind, fault) == ("prove_batch", "writer_altered"):

        def proofs_to_bytes(proofs, P):
            out = [serial.proof_to_bytes(pi, P) for pi in proofs]
            return [_flip(out[0], 4000), *out[1:]]  # a byte of the call's answer 0 flipped

        hook(serial, "proofs_to_bytes", proofs_to_bytes)
    else:
        raise AssertionError((kind, fault))
    return calls


@pytest.mark.parametrize("kind,fault", [
    ("prove", "altered"), ("prove", "stale"), ("prove", "half"), ("prove", "fails"),
    ("setup", "altered"), ("setup", "stale"), ("setup", "half"),
    ("verify", "altered"), ("verify", "stale"),
    ("prove_batch", "altered"), ("prove_batch", "stale"), ("prove_batch", "half"),
    ("prove_batch", "statement0"), ("prove_batch", "rowsum0"), ("prove_batch", "swapped"),
    ("prove_batch", "half_batch"), ("prove_batch", "writer_altered")])
def test_planted_fault_is_not_correct(tiny, monkeypatch, kind, fault):
    calls = _plant(monkeypatch, kind, fault)
    # requests a call leaves unanswered fail when the call ends, and the window's first request is
    # statement 0's, which a fault on the other statements leaves right: a window that outlasts one
    # call; a fault on each call's answer 0 alone: a window that ends at its first answer, that one
    seconds = {"half_batch": 5.0, "statement0": 5.0, "rowsum0": 5.0, "writer_altered": 0.01}
    r = run(tiny, kind, seconds=seconds.get(fault, 0.4))
    never = [name for name, n in calls.items() if not n]
    assert calls and not never, f"hook never called: {never}"
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
