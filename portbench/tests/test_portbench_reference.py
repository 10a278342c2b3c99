"""The plain reference against the committed golden digests (tiny and toy
profiles, the seeds of tests/golden/torch_port_digests.json), against the
port's host AES, and its verifier on honest and tampered proofs."""

import hashlib
import json

import numpy as np
import pytest

from conftest import ROOT
from portbench.reference import protocol as ref
from portbench.reference.aes import Stream

GOLDEN = json.loads((ROOT / "tests" / "golden" / "torch_port_digests.json").read_text())


@pytest.fixture(scope="module", params=["tiny", "toy"])
def derived(request):
    prof = GOLDEN["profiles"][request.param]
    P = ref.Params(**prof["params"])
    crs = Stream(bytes.fromhex(GOLDEN["crs_seed"]), "cpu")
    ent = Stream(bytes.fromhex(GOLDEN["ent_seed"]), "cpu")
    st = ref.setup(crs, ent, P, keep_v=True)
    proof = ref.proofs(crs, ent, P, st.circuit, st.key, [P.off_prove])[0]
    return prof, P, st, proof, crs, ent


def test_golden_digests(derived):
    prof, _, st, proof, _, _ = derived
    blobs = {"ssp": ref.ssp_bytes(st.circuit), "crs": st.crs, "vrs": st.vrs, "proof": proof}
    assert {k: hashlib.sha256(v).hexdigest() for k, v in blobs.items()} == prof["sha256"]


def test_verifier_accepts_honest_and_rejects_tampered(derived):
    _, P, st, proof, _, _ = derived
    assert ref.verify(proof, st.key, st.t, st.circuit.v0, P)
    n = P.n
    for ct, row, pos in ((0, n, 0), (4, n, 87), (2, 5, 40), (3, 0, 3)):
        bad = bytearray(proof)
        bad[(ct * (n + 1) + row) * ref.STORED + pos] ^= 0x5A
        assert not ref.verify(bytes(bad), st.key, st.t, st.circuit.v0, P)


def test_gated_rows_give_the_same_circuit(derived):
    """The prover's and the verifier's checks derive only the rows the witness
    gates: the same t, v_0, row-sum and v_i(s) as from every row."""
    _, P, st, _, _, ent = derived
    part = ref.circuit(ent, P, st.key.s, every_row=False)
    full = st.circuit
    assert all(bool((getattr(part, k) == getattr(full, k)).all()) for k in ("t", "v0", "rowsum"))
    known = part.v_at_s >= 0
    assert bool((part.v_at_s[known] == full.v_at_s[known]).all()) and bool(known[0])


def test_several_proofs_from_one_sweep(derived):
    _, P, st, proof, crs, ent = derived
    offs = [P.prove_offset(3), P.prove_offset(0)]
    many = ref.proofs(crs, ent, P, st.circuit, st.key, offs)
    assert many[1] == proof and many[0] != proof
    assert ref.verify(many[0], st.key, st.t, st.circuit.v0, P)


def test_control_precision_differs(derived):
    """The control's q = 2^640: the same proof with the top limb of every
    digit row cleared, which the byte comparison sees."""
    _, P, st, proof, crs, ent = derived
    P640 = ref.Params(**{**GOLDEN["profiles"]["tiny"]["params"], "d": P.d, "m": P.m, "n": P.n},
                      q_bits=640)
    low = ref.proofs(crs, ent, P640, st.circuit, st.key, [P.off_prove])[0]
    a = np.frombuffer(proof, np.uint8).reshape(-1, ref.STORED)
    b = np.frombuffer(low, np.uint8).reshape(-1, ref.STORED)
    assert (a[:, :80] == b[:, :80]).all() and not (b[:, 80:] != 0).any()
    assert (a[:, 80:88] != 0).any()


def test_keystream_matches_the_ports_host_aes():
    from c_lwe_snarks_tpu_torch.utils import aes_host

    seed = bytes(range(40))
    start = (1 << 32) - 3  # the counter's low word wraps
    got = Stream(seed, "cpu").bytes(16 * start + 5, 300).numpy()
    want = aes_host.ctr_keystream_numpy(seed[8:], int.from_bytes(seed[:8], "little"), start, 20)
    assert (got == want[5:305]).all()
