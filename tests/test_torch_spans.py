"""The port's spans and counters (``utils/spans.py``) on the CPU: off they
record nothing, on (torch's profiler or ``recording()``) they nest by
request, count launches and host syncs, and change no byte of any artifact.
"""

import ast
import json
import pathlib

import pytest
import torch

from c_lwe_snarks_tpu_torch.models import snark, ssp
from c_lwe_snarks_tpu_torch.ops import aes, digits, eval_fused, modp, ntt, sampling, verify
from c_lwe_snarks_tpu_torch.utils import obs, serial, spans
from c_lwe_snarks_tpu_torch.utils.params import Params

ROOT = pathlib.Path(__file__).resolve().parents[1]
P = Params(d=16, m=8)
DEV = "cpu"
OFF_SETUP = ssp.entropy_bytes_random_ssp(P)
OFF_PROVE = OFF_SETUP + snark.setup_entropy_bytes(P)
PROVER_CHILDREN = ("lwe.prover.polys", "lwe.prover.evals", "lwe.prover.smudge")

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture(scope="module")
def keys():
    return (sampling.PRGKey(bytes(range(40)), DEV),
            sampling.PRGKey(bytes(range(40, 80)), DEV))


def _setup(keys):
    crs_key, ent_key = keys
    wits, inst = ssp.random_ssp(ent_key, 0, P)
    crs, vrs = snark.setup(crs_key, ent_key, OFF_SETUP, inst, P)
    return wits, inst, crs, vrs


@pytest.fixture(scope="module")
def circuit(keys):
    return _setup(keys)


def _prove(keys, circuit):
    wits, inst, crs, _ = circuit
    return snark.prover(keys[0], keys[1], OFF_PROVE, crs, inst, wits, P)


def _stage(stage, keys, circuit):
    """A request of each benchmark cell: the port's calls it makes."""
    if stage == "prove":
        return serial.proof_to_bytes(_prove(keys, circuit), P)
    if stage == "prove_batch":  # two statements' proofs in one call, then their bytes
        wits, inst, crs, _ = circuit
        step = snark.prover_entropy_bytes(P)
        proofs = snark.prover_batch(keys[0], keys[1], [OFF_PROVE, OFF_PROVE + step], crs, inst,
                                    [wits, 1 - wits], P)
        return [serial.proof_to_bytes(pi, P) for pi in proofs]
    if stage == "setup":
        _, _, crs, vrs = _setup(keys)
        return serial.crs_to_bytes(crs, P), serial.vrs_to_bytes(vrs, P)
    _, inst, _, vrs = circuit
    blob = serial.proof_to_bytes(_prove(keys, circuit), P)
    spans.reset()
    proof = serial.proof_from_bytes(blob, P, DEV)
    return bool(snark.verifier(vrs, inst, proof, P))


def _outermost(recs):
    return [r for r in recs if r.parent < 0]


def test_off_records_and_counts_nothing(keys, circuit):
    _, inst, crs, vrs = circuit
    blob = serial.proof_to_bytes(_prove(keys, circuit), P)
    serial.crs_to_bytes(crs, P)
    serial.vrs_to_bytes(vrs, P)
    assert snark.verifier(vrs, inst, serial.proof_from_bytes(blob, P, DEV), P)
    _setup(keys)
    assert spans.records() == [] and spans.sync_sites() == {} and spans.staged_sites() == {}


def test_profiler_records_the_prover_and_its_stages(keys, circuit):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _prove(keys, circuit)
    recs = spans.records()
    assert [r.name for r in recs] == ["lwe.prover", *PROVER_CHILDREN]
    top = recs[0]
    assert top.parent == -1 and top.request == 0
    for r in recs[1:]:
        assert r.parent == 0 and r.request == 0
        assert top.start <= r.start <= r.end <= top.end
    s = spans.summary()
    children = sum(r.end - r.start for r in recs[1:])
    assert s["lwe.prover"]["self_s"] == pytest.approx(top.end - top.start - children, abs=1e-12)
    assert s["lwe.prover"]["total_s"] == top.end - top.start
    assert {r.name for r in recs} <= {e.name for e in prof.events()}


def test_recording_turns_the_recorder_on_without_the_profiler(keys, circuit):
    assert not torch.autograd.profiler._is_profiler_enabled
    with spans.recording():
        _prove(keys, circuit)
        _prove(keys, circuit)
    recs = spans.records()
    assert [r.name for r in recs] == ["lwe.prover", *PROVER_CHILDREN] * 2
    assert [r.request for r in recs] == [0] * 4 + [4] * 4
    assert spans.summary()["lwe.prover"]["calls"] == 2
    _prove(keys, circuit)
    assert len(spans.records()) == 8  # off again after the block


@pytest.mark.parametrize("artifact", ["proof", "crs", "vrs"])
def test_bytes_identical_with_tracing_on_and_off(keys, circuit, artifact):
    def blob():
        if artifact == "proof":
            return serial.proof_to_bytes(_prove(keys, circuit), P)
        _, _, crs, vrs = _setup(keys)
        return serial.crs_to_bytes(crs, P) if artifact == "crs" else serial.vrs_to_bytes(vrs, P)

    off = blob()
    with spans.recording():
        on = blob()
    assert on == off
    assert any(r.name.startswith("lwe.serial.") for r in spans.records())


@pytest.mark.parametrize("stage,syncs,sites", [
    ("prove", 2, {"ntt.poly_degree_and_lead": 1, "serial.proof_to_bytes": 1}),
    ("prove_batch", 3, {"ntt.poly_degree_and_lead": 1, "serial.proof_to_bytes": 2}),
    ("setup", 2, {"serial.crs_to_bytes": 1, "serial.vrs_to_bytes": 1}),
    ("verify", 0, {}),
])
def test_host_syncs_of_a_request(keys, circuit, stage, syncs, sites):
    with spans.recording():
        _stage(stage, keys, circuit)
    assert sum(r.syncs for r in _outermost(spans.records())) == syncs
    assert spans.sync_sites() == sites


def test_every_launch_counter_is_counted():
    registered = [id(c) for c in spans._launch_counters]
    for mod in (aes, eval_fused, ntt, modp, digits, verify):
        assert registered.count(id(mod.LAUNCHES)) == 1, mod.__name__
    assert {"eval_mac_planes", "eval_mac_lanes", "encrypt_b_fused"} <= set(eval_fused.LAUNCHES)


def test_launches_of_spans_add_up_to_the_launch_counters(keys, circuit):
    def total():
        return sum(sum(c.values()) for c in (aes.LAUNCHES, eval_fused.LAUNCHES, ntt.LAUNCHES,
                                            modp.LAUNCHES, digits.LAUNCHES, verify.LAUNCHES))

    saved = dict(modp.LAUNCHES), dict(digits.LAUNCHES)
    before = total()
    try:
        with spans.recording():
            _stage("prove", keys, circuit)
            with spans.span("outer"):
                modp.LAUNCHES["matvec_mod_p"] += 2
                with spans.span("inner"):
                    digits.LAUNCHES["carry_fold"] += 3
        delta = total() - before
    finally:
        modp.LAUNCHES.update(saved[0])
        digits.LAUNCHES.update(saved[1])
    s = spans.summary()
    assert (s["outer"]["launches"], s["inner"]["launches"]) == (5, 3)
    assert sum(r.launches for r in _outermost(spans.records())) == delta == 5


def _calls(path, func):
    """String first arguments of the calls ``func(...)`` or ``x.func(...)``."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if name == func and isinstance(node.args[0].value, str):
                out.add(node.args[0].value)
    return out


def test_program_span_names_are_not_the_benchmarks():
    """The benchmark's trace reader takes any host event named as one of its
    spans for its own: no program span may share such a name."""
    program = set()
    for path in (ROOT / "c_lwe_snarks_tpu_torch").rglob("*.py"):
        program |= _calls(path, "span")
    bench = {"window", "request"}
    for path in (ROOT / "portbench" / "entries").glob("*.py"):
        bench |= _calls(path, "spans")
    assert {"lwe.prover", *PROVER_CHILDREN, "lwe.prover_batch", "lwe.prover_batch.evals",
            "lwe.random_ssp", "lwe.setup", "lwe.setup.keys",
            "lwe.setup.messages", "lwe.setup.encrypt", "lwe.verifier",
            "lwe.serial.proof_to_bytes", "lwe.serial.crs_to_bytes", "lwe.serial.vrs_to_bytes",
            "lwe.serial.proof_from_bytes"} <= program
    assert all(n.startswith("lwe.") for n in program)
    assert {"prover", "prover_polys", "proof_to_bytes", "verifier"} <= bench
    assert not program & bench


def test_the_prover_calls_prover_polys_by_its_module_name(keys, circuit, monkeypatch):
    calls = []
    original = snark.prover_polys

    def wrapped(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(snark, "prover_polys", wrapped)
    with spans.recording():
        _prove(keys, circuit)
    assert calls == [1]
    assert "lwe.prover.polys" in spans.summary()


def test_profile_writes_the_spans_beside_the_trace(keys, circuit, tmp_path):
    with obs.profile(str(tmp_path)):
        serial.proof_to_bytes(_prove(keys, circuit), P)
    got = json.loads((tmp_path / "spans.json").read_text())
    assert set(got) == {"lwe.prover", *PROVER_CHILDREN, "lwe.serial.proof_to_bytes"}
    assert got["lwe.prover"]["calls"] == 1 and got["lwe.prover"]["host_syncs"] == 1
    assert got["lwe.serial.proof_to_bytes"]["host_syncs"] == 1
    assert got["lwe.serial.proof_to_bytes"]["staged"] == 1
    assert got["lwe.prover"]["staged"] == 0
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_staged_counts_copies_and_new_pinned_buffers_by_site():
    """A pinned buffer is new at an address no staged copy used before,
    the address kept with tracing off too; counts only with tracing on."""
    a, b = torch.empty(8, dtype=torch.uint8), torch.empty(8, dtype=torch.uint8)
    spans.staged("x", a, True)
    assert spans.staged_sites() == {}
    with spans.recording(), spans.span("lwe.x"):
        spans.staged("x", a, True)
        spans.staged("x", b, True)
        spans.staged("x", b, True)
        spans.staged("y", b, False)
    assert spans.staged_sites() == {"x": {"copies": 3, "pinned_new": 1},
                                    "y": {"copies": 1, "pinned_new": 0}}
    rec, = spans.records()
    assert (rec.staged, rec.pinned_new) == (4, 1)
    assert (spans.summary()["lwe.x"]["staged"], spans.summary()["lwe.x"]["pinned_new"]) == (4, 1)
    spans.reset()
    assert spans.staged_sites() == {}


def test_reset_refuses_an_open_span():
    with spans.recording(), spans.span("lwe.x"):
        with pytest.raises(RuntimeError):
            spans.reset()
