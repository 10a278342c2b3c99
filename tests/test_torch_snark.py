"""PyTorch port vs the JAX package and the host oracle: the whole protocol.

At tiny parameters (the seeds and sizes of tests/test_snark_tpu.py) the
port's random_ssp -> setup -> prover -> verifier must give SSP, CRS, VRS
and proof bytes equal to the JAX package's (through both serial modules)
and to the oracle's, accept the honest proof and reject a tampered proof,
a wrong witness and a wrong sk.  The committed golden digests (what the
GPU run is checked against) are regenerated from JAX here.
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

import jax

from c_lwe_snarks_tpu.models import snark as jsnark
from c_lwe_snarks_tpu.models import ssp as jssp
from c_lwe_snarks_tpu.ops import sampling as jsam
from c_lwe_snarks_tpu.oracle import snark as osnark
from c_lwe_snarks_tpu.oracle import ssp as ossp
from c_lwe_snarks_tpu.oracle.prg import EntropySource
from c_lwe_snarks_tpu.utils import params as params_mod
from c_lwe_snarks_tpu.utils import serial as jserial
from c_lwe_snarks_tpu_torch.__main__ import run_protocol
from c_lwe_snarks_tpu_torch.models import snark as tsnark
from c_lwe_snarks_tpu_torch.models import ssp as tssp
from c_lwe_snarks_tpu_torch.ops import digits as td
from c_lwe_snarks_tpu_torch.ops import sampling as tsam
from c_lwe_snarks_tpu_torch.utils import convert
from c_lwe_snarks_tpu_torch.utils import serial as tserial
from c_lwe_snarks_tpu_torch.utils.params import Params

torch.set_num_threads(1)

P = Params(d=16, m=8, n=32)
CRS_SEED = bytes(range(40, 80))
ENT_SEED = bytes(range(40))
GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_port_digests.json"
ARTIFACTS = ["ssp", "crs", "vrs", "proof"]


def _jax_protocol(params):
    crs_key, ent_key = jsam.PRGKey(CRS_SEED), jsam.PRGKey(ENT_SEED)
    off_setup = jssp.entropy_bytes_random_ssp(params)
    off_prove = off_setup + jsnark.setup_entropy_bytes(params)

    @jax.jit
    def run():
        wits, inst = jssp.random_ssp(ent_key, 0, params)
        crs, vrs = jsnark.setup(crs_key, ent_key, off_setup, inst, params)
        pi = jsnark.prover(crs_key, ent_key, off_prove, crs, inst, wits, params)
        return wits, inst, crs, vrs, pi

    return run()


def _jax_blobs(params, run):
    _, inst, crs, vrs, pi = run
    return {
        "ssp": jserial.ssp_to_buffer(inst, params),
        "crs": jserial.crs_to_bytes(crs, params),
        "vrs": jserial.vrs_to_bytes(vrs, params),
        "proof": jserial.proof_to_bytes(pi, params),
    }


def _port_blobs(params, run):
    return {
        "ssp": tserial.ssp_to_buffer(run.ssp, params),
        "crs": tserial.crs_to_bytes(run.crs, params),
        "vrs": tserial.vrs_to_bytes(run.vrs, params),
        "proof": tserial.proof_to_bytes(run.proof, params),
    }


def _sha(blobs):
    return {k: hashlib.sha256(v).hexdigest() for k, v in blobs.items()}


@pytest.fixture(scope="module")
def jax_run():
    return _jax_protocol(P)


@pytest.fixture(scope="module")
def port_run():
    return run_protocol(P, "cpu", CRS_SEED, ENT_SEED)


@pytest.fixture(scope="module")
def oracle_run():
    ent = EntropySource(ENT_SEED)
    wit, inst = ossp.random_ssp(P, ent)
    crs, vrs = osnark.setup(P, inst, ent, seed=CRS_SEED)
    pi = osnark.prover(P, crs, inst, wit, ent)
    return wit, inst, crs, vrs, pi


@pytest.mark.parametrize("artifact", ARTIFACTS)
def test_artifact_bytes_match_jax(jax_run, port_run, artifact):
    assert _port_blobs(P, port_run)[artifact] == _jax_blobs(P, jax_run)[artifact]


def test_artifacts_match_oracle(oracle_run, port_run):
    owit, oinst, ocrs, ovrs, opi = oracle_run
    assert [int(b) for b in port_run.witness] == [(owit >> i) & 1 for i in range(P.m)]
    assert port_run.ssp.t.tolist() == oinst.t + [0] * (P.d - len(oinst.t))
    for i in range(P.m):
        assert port_run.ssp.v[i].tolist() == oinst.v[i] + [0] * (P.d - len(oinst.v[i]))
    assert [int(port_run.vrs.alpha), int(port_run.vrs.beta), int(port_run.vrs.s)] == [
        ovrs.alpha, ovrs.beta, ovrs.s]
    for rows, want in ((port_run.crs.b_s, ocrs.s), (port_run.crs.b_as, ocrs.as_),
                       (port_run.crs.b_v, ocrs.v)):
        assert [td.digits_to_int(r) for r in rows] == [int.from_bytes(w, "little") for w in want]
    for name in ("h", "hat_h", "hat_v", "v_w", "b_w"):
        ct, oct_ = getattr(port_run.proof, name), getattr(opi, name)
        assert [td.digits_to_int(r) for r in ct[: P.n]] == [a % (1 << 704) for a in oct_.a]
        assert td.digits_to_int(ct[P.n]) == oct_.b % (1 << 704), name


def test_verifier_accepts(port_run):
    assert port_run.verified
    assert bool(tsnark.verifier(port_run.vrs, port_run.ssp, port_run.proof, P))


def test_verifier_rejects_tampered_proof(port_run):
    pi = port_run.proof
    bad_h = pi.h.clone()
    bad_h[P.n, 0] ^= 1
    bad = tsnark.Proof(h=bad_h, hat_h=pi.hat_h, hat_v=pi.hat_v, v_w=pi.v_w, b_w=pi.b_w)
    assert not bool(tsnark.verifier(port_run.vrs, port_run.ssp, bad, P))


def test_verifier_rejects_wrong_witness(port_run):
    crs_key, ent_key = tsam.PRGKey(CRS_SEED, "cpu"), tsam.PRGKey(ENT_SEED, "cpu")
    off_prove = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    bad_wits = port_run.witness.clone()
    bad_wits[0] = 1 - bad_wits[0]
    pi = tsnark.prover(crs_key, ent_key, off_prove, port_run.crs, port_run.ssp, bad_wits, P)
    assert not bool(tsnark.verifier(port_run.vrs, port_run.ssp, pi, P))


def test_verifier_rejects_wrong_sk(port_run):
    vrs = port_run.vrs
    bad_sk = vrs.sk.clone()
    bad_sk[0, 0] ^= 1
    bad = tsnark.VRS(alpha=vrs.alpha, beta=vrs.beta, s=vrs.s, sk=bad_sk)
    assert not bool(tsnark.verifier(bad, port_run.ssp, port_run.proof, P))


def test_prover_only_from_jax_state(jax_run):
    """The port's prover, fed the JAX package's SSP and CRS through
    utils/convert.py, gives the JAX package's proof."""
    wits, inst, crs, vrs, pi = jax_run
    ssp = convert.ssp_from_numpy(np.asarray(inst.t), np.asarray(inst.v), "cpu")
    tcrs = convert.crs_from_numpy(crs.seed, np.asarray(crs.b_s), np.asarray(crs.b_as),
                                  np.asarray(crs.b_t), np.asarray(crs.b_v), "cpu")
    tvrs = convert.vrs_from_numpy(np.asarray(vrs.alpha), np.asarray(vrs.beta),
                                  np.asarray(vrs.s), np.asarray(vrs.sk), "cpu")
    off_prove = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    proof = tsnark.prover(tsam.PRGKey(CRS_SEED, "cpu"), tsam.PRGKey(ENT_SEED, "cpu"), off_prove, tcrs,
                          ssp,
                          torch.from_numpy(np.array(wits)), P)
    np.testing.assert_array_equal(convert.proof_to_numpy(proof), np.asarray(pi.stack()))
    assert bool(tsnark.verifier(tvrs, ssp, proof, P))


def test_golden_tiny_digests(jax_run, port_run):
    """The committed tiny digests == JAX regenerated now == the port."""
    entry = json.loads(GOLDEN.read_text())["profiles"]["tiny"]
    assert Params(**entry["params"]) == P
    assert _sha(_jax_blobs(P, jax_run)) == entry["sha256"]
    assert _sha(_port_blobs(P, port_run)) == entry["sha256"]


@pytest.mark.slow
def test_golden_toy_digests():
    """The committed toy digests == JAX regenerated now == the port (minutes)."""
    golden = json.loads(GOLDEN.read_text())
    assert golden["crs_seed"] == CRS_SEED.hex() and golden["ent_seed"] == ENT_SEED.hex()
    entry = golden["profiles"]["toy"]
    params = Params(**entry["params"])
    assert _sha(_jax_blobs(params, _jax_protocol(params))) == entry["sha256"]
    port = run_protocol(params, "cpu", CRS_SEED, ENT_SEED)
    assert port.verified
    assert _sha(_port_blobs(params, port)) == entry["sha256"]


@pytest.mark.parametrize("params", [P, params_mod.toy(), params_mod.release()],
                         ids=["tiny", "toy", "release"])
def test_entropy_layout_matches_jax(params):
    """The draw sizes that place every stage in the entropy stream."""
    for name in ("err_bytes", "enc_entropy_bytes", "smudge_entropy_bytes",
                 "setup_entropy_bytes", "prover_entropy_bytes"):
        assert getattr(tsnark, name)(params) == getattr(jsnark, name)(params), name
    assert tssp.entropy_bytes_random_ssp(params) == jssp.entropy_bytes_random_ssp(params)
    assert tssp.witness_pad_bytes(params) == jssp.witness_pad_bytes(params)


def test_witness_bits_release_m():
    """Release m = 21845: the top m % 8 witness bits are zero (floor-byte draw)."""
    m = 21845
    owit = EntropySource(ENT_SEED).urandomb(m)
    wits = tssp.witness_bits(tsam.keystream_bytes(tsam.PRGKey(ENT_SEED, "cpu"), 0, m // 8), m)
    assert wits.tolist() == [(owit >> i) & 1 for i in range(m)]
    assert not wits[21840:].any()


def test_ragged_m_protocol_matches_oracle():
    """m % 8 != 0: the top witness bits are zero and propagate into t, w
    and b_w; the port's proof equals the oracle's."""
    pm = Params(d=16, m=13, n=32)
    ent = EntropySource(ENT_SEED)
    owit, oinst = ossp.random_ssp(pm, ent)
    ocrs, _ = osnark.setup(pm, oinst, ent, seed=CRS_SEED)
    opi = osnark.prover(pm, ocrs, oinst, owit, ent)
    run = run_protocol(pm, "cpu", CRS_SEED, ENT_SEED)
    assert run.verified
    assert int(run.witness[-1]) == 0
    for name in ("h", "hat_h", "hat_v", "v_w", "b_w"):
        ct, oct_ = getattr(run.proof, name), getattr(opi, name)
        assert [td.digits_to_int(r) for r in ct[: pm.n]] == [a % (1 << 704) for a in oct_.a]
        assert td.digits_to_int(ct[pm.n]) == oct_.b % (1 << 704), name
