"""``snark.prover_batch`` on the CPU: B statements of one circuit proved with
one polynomial stage (``snark.prover_polys_batch``, each row
``snark.prover_polys``'s) and one sweep for all 5B evaluations, each proof
byte for byte ``snark.prover``'s
and the JAX package's (tests/golden/torch_port_batch_proofs.json, written
by tools/make_torch_golden.py --batch, since the JAX prover takes minutes an
offset to compile on the CPU); and K3's many-lane wrapper (``eval_fused.eval_mac_planes``
past 8 lanes, ``lane_segments``), whose card form tests/test_torch_cuda.py
holds against the plain version.

Small shapes: d = 64, m = 16 at n = 32, so a proof takes ~0.1 s on the CPU.
"""

import dataclasses
import hashlib
import json
import pathlib

import pytest
import torch

from c_lwe_snarks_tpu_torch.models import snark, ssp
from c_lwe_snarks_tpu_torch.ops import eval_fused as tef
from c_lwe_snarks_tpu_torch.ops import modp, ntt, sampling
from c_lwe_snarks_tpu_torch.utils import serial, spans
from c_lwe_snarks_tpu_torch.utils.params import Params

P = Params(d=64, m=16, n=32)
DEV = "cpu"
OFF_SETUP = ssp.entropy_bytes_random_ssp(P)
OFF_PROVE = OFF_SETUP + snark.setup_entropy_bytes(P)
STEP = snark.prover_entropy_bytes(P)
GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden" / "torch_port_batch_proofs.json")
                    .read_text())

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def circuit():
    """(crs key, entropy key, crs, vrs, ssp, witnesses): statement 0 is
    random_ssp's witness, statements 1 and 2 the golden file's other bits."""
    assert GOLDEN["params"] == {"d": P.d, "m": P.m, "n": P.n}
    crs_key = sampling.PRGKey(bytes.fromhex(GOLDEN["crs_seed"]), DEV)
    ent_key = sampling.PRGKey(bytes.fromhex(GOLDEN["ent_seed"]), DEV)
    wits, inst = ssp.random_ssp(ent_key, 0, P)
    crs, vrs = snark.setup(crs_key, ent_key, OFF_SETUP, inst, P)
    bits = [torch.tensor([int(c) for c in w], dtype=torch.uint8) for w in GOLDEN["statements"]]
    assert torch.equal(bits[0], wits)
    return crs_key, ent_key, crs, vrs, inst, bits


@pytest.fixture(scope="module")
def single(circuit):
    """``snark.prover``'s bytes, memoized by (offset, statement)."""
    crs_key, ent_key, crs, _, inst, wits = circuit
    done = {}

    def proof(off, j):
        if (off, j) not in done:
            pi = snark.prover(crs_key, ent_key, off, crs, inst, wits[j], P)
            done[off, j] = serial.proof_to_bytes(pi, P)
        return done[off, j]

    return proof


@pytest.mark.parametrize("requests", [
    [(0, 0)],                              # B = 1
    [(0, 0), (1, 1), (2, 2)],              # three statements, offsets of their own
    [(3, 1), (0, 0), (5, 2), (4, 0)],      # statement 0 at two offsets, out of order
], ids=["B1", "B3", "B4_repeated"])
def test_prover_batch_equals_prover(circuit, single, requests):
    """Each proof is ``snark.prover``'s bytes and the JAX package's prover's
    (its sha256) for the same keys, offset and witness."""
    crs_key, ent_key, crs, vrs, inst, wits = circuit
    offsets = [OFF_PROVE + i * STEP for i, _ in requests]
    proofs = snark.prover_batch(crs_key, ent_key, offsets, crs, inst,
                                [wits[j] for _, j in requests], P)
    assert len(proofs) == len(requests)
    for off, (i, j), pi in zip(offsets, requests, proofs):
        got = serial.proof_to_bytes(pi, P)
        assert got == single(off, j)
        assert hashlib.sha256(got).hexdigest() == GOLDEN["proof_sha256"][f"{i},{j}"]
    # the satisfying statement's proofs verify
    assert all(bool(snark.verifier(vrs, inst, pi, P))
               for (_, j), pi in zip(requests, proofs) if j == 0)


def test_prover_batch_spans_and_syncs(circuit):
    """One outermost span for the batch, t's degree read once, one
    ``lwe.prover.polys`` for the batch before the shared sweep
    (``lwe.prover.evals``, the single prover's) and one
    ``lwe.prover.smudge`` a statement after it; no proofs for no requests;
    offsets and witnesses paired."""
    crs_key, ent_key, crs, _, inst, wits = circuit
    spans.reset()
    with spans.recording():
        snark.prover_batch(crs_key, ent_key, [OFF_PROVE, OFF_PROVE + STEP], crs, inst, wits[:2], P)
    names = [r.name for r in spans.records()]
    assert names == ["lwe.prover_batch", "lwe.prover.polys", "lwe.prover.evals",
                     "lwe.prover.smudge", "lwe.prover.smudge"]
    assert [r.parent for r in spans.records()] == [-1, 0, 0, 0, 0]
    assert spans.sync_sites() == {"ntt.poly_degree_and_lead": 1}
    spans.reset()
    assert snark.prover_batch(crs_key, ent_key, [], crs, inst, [], P) == []
    with pytest.raises(ValueError, match="offsets"):
        snark.prover_batch(crs_key, ent_key, [OFF_PROVE], crs, inst, wits[:2], P)


def _statements(wits, b):
    """b witnesses: the circuit's three statements, all-zero and all-one bits."""
    pool = [wits[0], torch.zeros_like(wits[0]), wits[1], torch.ones_like(wits[0]), wits[2]]
    return [pool[j % len(pool)] for j in range(b)]


@pytest.mark.parametrize("b,zero_top", [
    (1, 0),
    (2, 0),
    (10, 0),
    (16, 0),
    (10, 2),   # t's last two formal coefficients 0: the division's shift branch
], ids=["B1", "B2", "B10", "B16", "B10_shift"])
def test_prover_polys_batch_equals_prover_polys(circuit, b, zero_top):
    """Row j of the batched stage is byte for byte ``prover_polys`` of
    statement j, offsets out of order and not block-aligned, witnesses
    random, all 0 and all 1."""
    _, ent_key, _, _, inst, wits = circuit
    if zero_top:
        t = inst.t.clone()
        t[-zero_top:] = 0
        inst = dataclasses.replace(inst, t=t)
        assert ntt.poly_degree_and_lead(t)[0] < P.d - zero_top
    offs = [OFF_PROVE + (7 * j % b) * STEP for j in range(b)]
    stmts = _statements(wits, b)
    got = snark.prover_polys_batch(ent_key, offs, inst, torch.stack(stmts), P)
    assert [tuple(x.shape) for x in got] == [(b,), (b, P.d), (b, P.d), (b, P.d)]
    for j, (off, wit) in enumerate(zip(offs, stmts)):
        want = snark.prover_polys(ent_key, off, inst, wit, P)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == torch.int64 and torch.equal(g[j], w)
    # a count of witnesses that differs from the offsets' is refused
    with pytest.raises(ValueError, match="offsets"):
        snark.prover_polys_batch(ent_key, offs + [OFF_PROVE], inst, torch.stack(stmts), P)


@pytest.mark.parametrize("b,zero_top", [(1, 0), (4, 0), (4, 3)], ids=["B1", "B4", "B4_shift"])
def test_batched_division_equals_single_divisions(b, zero_top):
    """num [B, ln] over a 1-D den: row j is the 1-D division of num[j] (the
    exact quotient), in both branches (zero_top > 0: the shift)."""
    g = torch.Generator().manual_seed(40 + zero_top)
    d = 24
    t = torch.randint(1, modp.P, (d,), generator=g)
    if zero_top:
        t[-zero_top:] = 0
    quot = torch.randint(0, modp.P, (b, d), generator=g)
    num = ntt.poly_mul_mod_p(quot, t)  # [b, 2d - 1]
    degree, lead = ntt.poly_degree_and_lead(t)
    got = ntt.poly_div_exact_mod_p(num, t, d, den_degree=degree, den_lead=lead)
    assert got.shape == (b, d) and torch.equal(got, quot)
    for j in range(b):
        assert torch.equal(ntt.poly_div_exact_mod_p(num[j], t, d), got[j])


@pytest.mark.parametrize("fault", ["statement0", "swapped"])
def test_planted_faults_in_the_batched_stage_change_the_proofs(circuit, single, monkeypatch, fault):
    """A batched stage that takes statement 0's witness for every row, or
    swaps two rows' witnesses, gives proofs that differ from ``snark.prover``'s
    for the statements it wronged: ``prover_batch`` calls the stage through
    the module's name, where such a fault is planted."""
    crs_key, ent_key, crs, _, inst, wits = circuit
    original = snark.prover_polys_batch

    def planted(ent_key, offsets, ssp, witnesses, params, **kw):
        bad = witnesses.clone()
        if fault == "statement0":
            bad[:] = witnesses[0]
        else:
            bad[[0, 1]] = witnesses[[1, 0]]
        return original(ent_key, offsets, ssp, bad, params, **kw)

    monkeypatch.setattr(snark, "prover_polys_batch", planted)
    requests = [(0, 0), (1, 1), (2, 2)]
    offsets = [OFF_PROVE + i * STEP for i, _ in requests]
    proofs = snark.prover_batch(crs_key, ent_key, offsets, crs, inst,
                                [wits[j] for _, j in requests], P)
    same = [serial.proof_to_bytes(pi, P) == single(off, j)
            for off, (_, j), pi in zip(offsets, requests, proofs)]
    assert same == ([True, False, False] if fault == "statement0" else [False, False, True])


def _tree(recs):
    """(name, parent, launches, host syncs) of each span below the outermost."""
    return [(r.name, r.parent, r.launches, r.syncs) for r in recs[1:]]


@pytest.mark.parametrize("i", [0, 1], ids=["off0", "off1"])
@pytest.mark.parametrize("j", [0, 1, 2], ids=["stmt0", "stmt1", "stmt2"])
def test_prover_is_a_batch_of_one(circuit, i, j):
    """``prover(off, w)`` and ``prover_batch([off], [w])[0]`` run one body:
    the same bytes (the JAX package's), the same host syncs and the same
    spans under their outermost one (``lwe.prover.polys``,
    ``lwe.prover.evals``, ``lwe.prover.smudge``)."""
    crs_key, ent_key, crs, _, inst, wits = circuit
    off = OFF_PROVE + i * STEP
    got = {}
    for name, call in (
            ("lwe.prover", lambda: snark.prover(crs_key, ent_key, off, crs, inst, wits[j], P)),
            ("lwe.prover_batch", lambda: snark.prover_batch(
                crs_key, ent_key, [off], crs, inst, [wits[j]], P)[0])):
        spans.reset()
        with spans.recording():
            blob = serial.proof_to_bytes(call(), P)
        recs = [r for r in spans.records() if not r.name.startswith("lwe.serial")]
        assert recs[0].name == name and recs[0].parent == -1
        got[name] = (blob, _tree(recs), spans.sync_sites())
    spans.reset()
    one, batch = got["lwe.prover"], got["lwe.prover_batch"]
    assert one == batch
    assert [n for n, *_ in one[1]] == ["lwe.prover.polys", "lwe.prover.evals",
                                       "lwe.prover.smudge"]
    assert one[2] == {"ntt.poly_degree_and_lead": 1, "serial.proof_to_bytes": 1}
    assert hashlib.sha256(one[0]).hexdigest() == GOLDEN["proof_sha256"][f"{i},{j}"]


@pytest.mark.parametrize("zero_top", [0, 2], ids=["top_nonzero", "top_zero"])
def test_the_polynomial_stage_reads_t_once_a_call(circuit, zero_top):
    """``prover_polys`` and ``prover_polys_batch`` each read t's degree and
    lead from the device once a call, whether t's top formal coefficients
    are zero (the division's shift branch) or not."""
    _, ent_key, _, _, inst, wits = circuit
    if zero_top:
        t = inst.t.clone()
        t[-zero_top:] = 0
        inst = dataclasses.replace(inst, t=t)
    offs = [OFF_PROVE + k * STEP for k in range(3)]
    for call in (lambda: snark.prover_polys(ent_key, offs[0], inst, wits[0], P),
                 lambda: snark.prover_polys_batch(ent_key, offs, inst, torch.stack(wits), P)):
        spans.reset()
        with spans.recording():
            call()
        assert spans.sync_sites() == {"ntt.poly_degree_and_lead": 1}
        assert [r.name for r in spans.records()] == ["lwe.prover.polys"]
    spans.reset()


def test_a_mesh_sweeps_one_statement(circuit):
    """The sharded sweep proves one statement: the body refuses a mesh with
    B > 1 before it evaluates anything."""
    crs_key, ent_key, crs, _, inst, wits = circuit
    offs = [OFF_PROVE, OFF_PROVE + STEP]
    delta, w, v, h = snark.prover_polys_batch(ent_key, offs, inst, torch.stack(wits[:2]), P)
    with pytest.raises(ValueError, match="one statement"):
        snark._evaluate_and_smudge(crs_key, ent_key, offs, crs, delta, w, v, h,
                                   torch.stack(wits[:2]), P, mesh=object())


def test_onepass_terms_lay_out_lanes_by_kind(circuit):
    """Lane t B + j of the batch is lane t of proof j's own terms; each
    section's nonzero lanes lie inside ``onepass_sections``."""
    crs_key, ent_key, crs, _, inst, wits = circuit
    polys = [snark.prover_polys(ent_key, OFF_PROVE + i * STEP, inst, wits[i], P) for i in range(3)]
    delta, w, v, h = (torch.stack(x) for x in zip(*polys))
    b_all, coeffs = snark.onepass_terms(crs, w, h, v, delta, torch.stack(wits), P)
    assert coeffs.shape == (15, P.crs_num_cts)
    for j, (dj, wj, vj, hj) in enumerate(polys):
        b_one, one = snark.onepass_terms(crs, wj, hj, vj, dj, wits[j], P)
        assert torch.equal(b_one, b_all) and torch.equal(coeffs[j::3], one)
    mask = torch.zeros_like(coeffs, dtype=torch.bool)
    for r0, r1, l0, l1 in snark.onepass_sections(P, 3):
        mask[l0:l1, r0:r1] = True
    assert not coeffs[~mask].any()


def test_plain_holds_the_caller_to_the_sections():
    """Past 8 lanes the caller gives the sections; a nonzero coefficient
    outside them, which the card's many-lane form would not read, is
    refused on the CPU; inside them the planes are those without sections."""
    key = sampling.PRGKey(bytes(range(40)), DEV)
    n, d = 2, 40
    coeffs = torch.randint(0, 1 << 32, (12, d), generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="past 8"):
        tef.eval_mac_planes(key, 24, coeffs, n, 92 * n)
    sections = ((0, 25, 0, 6), (25, d, 6, 12))
    with pytest.raises(ValueError, match="outside the sections"):
        tef.eval_mac_planes(key, 24, coeffs, n, 92 * n, sections=sections)
    with pytest.raises(ValueError, match="outside the sections"):
        tef.eval_mac_planes_plain(key, 24, coeffs[:5], n, 92 * n, sections=((0, d, 0, 4),))
    for r0, r1, l0, l1 in sections:
        coeffs[l0:l1, :r0] = 0
        coeffs[l0:l1, r1:] = 0
    want = tef.eval_mac_planes_plain(key, 24, coeffs, n, 92 * n)
    assert torch.equal(tef.eval_mac_planes(key, 24, coeffs, n, 92 * n, sections=sections), want)


def _covered(segs, d, k):
    cover = torch.zeros(k, d, dtype=torch.int64)
    for r0, r1, l0, w in segs:
        cover[l0 : l0 + w, r0:r1] += 1
    return cover


@pytest.mark.parametrize("d,n,sections", [
    (87381, 1470, snark.onepass_sections(Params(d=1 << 15, m=21845), 10)),
    (87381, 1470, snark.onepass_sections(Params(d=1 << 15, m=21845), 11)),
    (87381, 1470, ((0, 87381, 0, 45),)),
    (300, 6, ((0, 130, 0, 10), (130, 300, 10, 12))),
    (150000, 2, ((0, 150000, 3, 30), (0, 7, 0, 3))),
    (5, 32, ((0, 5, 0, 9), (2, 2, 9, 12))),
])
def test_lane_segments_cover_each_section_once(d, n, sections):
    """Every row and lane of a section in exactly one segment and nothing
    outside them; at most 20 lanes and 32,768 rows a segment (the signed
    32-bit sums), whole tiles of 256 rows but a window's last."""
    k = max(l1 for *_, l1 in sections)
    segs = tef.lane_segments(d, n, sections)
    want = torch.zeros(k, d, dtype=torch.int64)
    for r0, r1, l0, l1 in sections:
        want[l0:l1, r0:r1] = 1
    assert torch.equal(_covered(segs, d, k), want)
    for r0, r1, l0, w in segs:
        assert 1 <= w <= tef.WIDE_LANES and 0 < r1 - r0 <= tef.MAX_SEGMENT_ROWS
        assert (r1 - r0) % tef.WIDE_ROWS == 0 or any(r1 == s1 for _, s1, *_ in sections)


def test_lane_segments_at_release():
    """At release widths B = 10 is one launch of 8 segments, the s and as
    sections' 20 lanes a segment and b_w's 10, ~4,500 blocks of 240 columns;
    B = 11 splits the s and as sections' 22 lanes into windows of 20 and 2,
    and the keystream it sweeps is 1.75 passes, not 2."""
    rel = Params(d=1 << 15, m=21845)
    segs = tef.lane_segments(rel.crs_num_cts, rel.n, snark.onepass_sections(rel, 10))
    assert len(segs) == 8 <= tef.MAX_SEGMENTS
    assert sorted({w for *_, w in segs}) == [10, 20]
    assert len(segs) * -(-92 * rel.n // tef.WIDE_COLS) == 4512
    segs11 = tef.lane_segments(rel.crs_num_cts, rel.n, snark.onepass_sections(rel, 11))
    swept = sum(r1 - r0 for r0, r1, *_ in {(r0, r1, l0) for r0, r1, l0, _ in segs11})
    assert swept == 4 * rel.d + rel.m == 152917 and swept < 2 * rel.crs_num_cts


def test_sections_are_checked():
    key = sampling.PRGKey(bytes(range(40)), DEV)
    c = torch.zeros(10, 8, dtype=torch.int64)
    for bad in (((0, 9, 0, 10),), ((0, 8, 0, 11),), ((0, 8, 0, 6), (4, 8, 5, 10))):
        with pytest.raises(ValueError, match="outside|overlap"):
            tef.eval_mac_planes(key, 0, c, 2, 184, sections=bad)
