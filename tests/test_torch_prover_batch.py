"""``snark.prover_batch`` on the CPU: B statements of one circuit proved with
one sweep for all 5B evaluations, each proof byte for byte ``snark.prover``'s
and the JAX package's (tests/golden/torch_port_batch_proofs.json, written
by tools/make_torch_golden.py --batch, since the JAX prover takes minutes an
offset to compile on the CPU); and K3's many-lane wrapper (``eval_fused.eval_mac_planes``
past 8 lanes, ``lane_segments``), whose card form tests/test_torch_cuda.py
holds against the plain version.

Small shapes: d = 64, m = 16 at n = 32, so a proof takes ~0.1 s on the CPU.
"""

import hashlib
import json
import pathlib

import pytest
import torch

from c_lwe_snarks_tpu_torch.models import snark, ssp
from c_lwe_snarks_tpu_torch.ops import eval_fused as tef
from c_lwe_snarks_tpu_torch.ops import sampling
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
    ``lwe.prover.polys`` and one ``lwe.prover.smudge`` a statement around the
    shared sweep; no proofs for no requests; offsets and witnesses paired."""
    crs_key, ent_key, crs, _, inst, wits = circuit
    spans.reset()
    with spans.recording():
        snark.prover_batch(crs_key, ent_key, [OFF_PROVE, OFF_PROVE + STEP], crs, inst, wits[:2], P)
    names = [r.name for r in spans.records()]
    assert names == ["lwe.prover_batch", "lwe.prover.polys", "lwe.prover.polys",
                     "lwe.prover_batch.evals", "lwe.prover.smudge", "lwe.prover.smudge"]
    assert [r.parent for r in spans.records()] == [-1, 0, 0, 0, 0, 0]
    assert spans.sync_sites() == {"ntt.poly_degree_and_lead": 1}
    spans.reset()
    assert snark.prover_batch(crs_key, ent_key, [], crs, inst, [], P) == []
    with pytest.raises(ValueError, match="offsets"):
        snark.prover_batch(crs_key, ent_key, [OFF_PROVE], crs, inst, wits[:2], P)


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
