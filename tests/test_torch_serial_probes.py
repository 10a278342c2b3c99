"""PyTorch port vs the JAX package: artifact readers, streaming IO and the
designated-verifier decrypt-probes.

One JAX protocol run at the tiny parameters (one jit) gives the JAX
package's CRS/VRS/proof/SSP bytes; every ``*_from_bytes`` reader of the
port must read them into the same arrays, the stream writers must be
byte-identical to ``*_to_bytes``, and the probes must agree with the JAX
probes on the same run and turn false on a tampered CRS.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from c_lwe_snarks_tpu.models import snark as jsnark
from c_lwe_snarks_tpu.models import ssp as jssp
from c_lwe_snarks_tpu.ops import sampling as jsam
from c_lwe_snarks_tpu.utils import obs as jobs
from c_lwe_snarks_tpu.utils import serial as jserial
from c_lwe_snarks_tpu_torch.models import snark as tsnark
from c_lwe_snarks_tpu_torch.utils import obs as tobs
from c_lwe_snarks_tpu_torch.utils import serial as tserial
from c_lwe_snarks_tpu_torch.utils.params import Params

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
P = Params(d=16, m=8, n=32)
CRS_SEED = bytes(range(40, 80))
ENT_SEED = bytes(range(40))


@pytest.fixture(scope="module")
def jax_run():
    crs_key, ent_key = jsam.PRGKey(CRS_SEED), jsam.PRGKey(ENT_SEED)
    off_setup = jssp.entropy_bytes_random_ssp(P)
    off_prove = off_setup + jsnark.setup_entropy_bytes(P)

    @jax.jit
    def run():
        wits, inst = jssp.random_ssp(ent_key, 0, P)
        crs, vrs = jsnark.setup(crs_key, ent_key, off_setup, inst, P)
        pi = jsnark.prover(crs_key, ent_key, off_prove, crs, inst, wits, P)
        return wits, inst, crs, vrs, pi

    return run()


@pytest.fixture(scope="module")
def jax_blobs(jax_run):
    _, inst, crs, vrs, pi = jax_run
    return {
        "ssp": jserial.ssp_to_buffer(inst, P),
        "crs": jserial.crs_to_bytes(crs, P),
        "vrs": jserial.vrs_to_bytes(vrs, P),
        "proof": jserial.proof_to_bytes(pi, P),
    }


@pytest.fixture(scope="module")
def port_state(jax_blobs):
    """The port's objects, read from the JAX package's bytes on the CPU."""
    return {
        "ssp": tserial.ssp_from_buffer(jax_blobs["ssp"], P, "cpu"),
        "crs": tserial.crs_from_bytes(jax_blobs["crs"], P, "cpu"),
        "vrs": tserial.vrs_from_bytes(jax_blobs["vrs"], P, "cpu"),
        "proof": tserial.proof_from_bytes(jax_blobs["proof"], P, "cpu"),
    }


def _same(t: torch.Tensor, want, dtype) -> None:
    assert t.dtype == dtype and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


def test_crs_from_bytes_reads_jax_bytes(jax_run, port_state):
    crs, jcrs = port_state["crs"], jax_run[2]
    assert crs.seed == bytes(jcrs.seed) == CRS_SEED
    for name in ("b_s", "b_as", "b_t", "b_v"):
        _same(getattr(crs, name), getattr(jcrs, name), torch.uint8)
    assert crs.b_s.shape == (P.d, 88) and crs.b_t.shape == (88,) and crs.b_v.shape == (P.m - 1, 88)


def test_vrs_from_bytes_reads_jax_bytes(jax_run, port_state):
    vrs, jvrs = port_state["vrs"], jax_run[3]
    for name in ("alpha", "beta", "s"):
        _same(getattr(vrs, name), getattr(jvrs, name), torch.uint32)  # VRSDev's type
    _same(vrs.sk, jvrs.sk, torch.uint8)


def test_proof_from_bytes_reads_jax_bytes(jax_run, port_state):
    _same(port_state["proof"].stack(), jax_run[4].stack(), torch.uint8)


def test_ssp_from_buffer_reads_jax_bytes(jax_run, port_state):
    _same(port_state["ssp"].t, jax_run[1].t, torch.uint32)
    _same(port_state["ssp"].v, jax_run[1].v, torch.uint32)


@pytest.mark.parametrize("artifact", ["ssp", "crs", "vrs", "proof"])
def test_round_trip_through_port_writers(jax_blobs, port_state, artifact):
    writer = {"ssp": tserial.ssp_to_buffer, "crs": tserial.crs_to_bytes,
              "vrs": tserial.vrs_to_bytes, "proof": tserial.proof_to_bytes}[artifact]
    assert writer(port_state[artifact], P) == jax_blobs[artifact]


@pytest.mark.parametrize("artifact", ["ssp", "crs", "vrs", "proof"])
def test_readers_refuse_a_wrong_length(jax_blobs, artifact):
    reader = {"ssp": tserial.ssp_from_buffer, "crs": tserial.crs_from_bytes,
              "vrs": tserial.vrs_from_bytes, "proof": tserial.proof_from_bytes}[artifact]
    with pytest.raises(ValueError):
        reader(jax_blobs[artifact][:-1], P, "cpu")


def test_readers_give_what_the_jax_readers_give(jax_blobs, port_state):
    """The port's reader and the JAX reader on the same bytes."""
    jcrs = jserial.crs_from_bytes(jax_blobs["crs"], P)
    _same(port_state["crs"].b_v, jcrs.b_v, torch.uint8)
    jssp_ = jserial.ssp_from_buffer(jax_blobs["ssp"], P)
    _same(port_state["ssp"].v, jssp_.v, torch.uint32)
    jpi = jserial.proof_from_bytes(jax_blobs["proof"], P)
    _same(port_state["proof"].b_w, jpi.b_w, torch.uint8)


@pytest.mark.parametrize("rows_per_chunk", [1, 3, 256])
def test_stream_writers_are_byte_identical(tmp_path, jax_blobs, port_state, rows_per_chunk):
    ssp_path, crs_path = str(tmp_path / "ssp.bin"), str(tmp_path / "crs.bin")
    tserial.ssp_write_stream(ssp_path, port_state["ssp"], P, rows_per_chunk=rows_per_chunk)
    tserial.crs_write_stream(crs_path, port_state["crs"], P, rows_per_chunk=rows_per_chunk)
    assert tserial.load(ssp_path) == jax_blobs["ssp"]
    assert tserial.load(crs_path) == jax_blobs["crs"]


@pytest.mark.parametrize("rows_per_chunk", [1, 4, 256])
def test_ssp_read_stream(tmp_path, jax_blobs, port_state, rows_per_chunk):
    path = str(tmp_path / "ssp.bin")
    tserial.save(path, jax_blobs["ssp"])
    ssp = tserial.ssp_read_stream(path, P, "cpu", rows_per_chunk=rows_per_chunk)
    assert torch.equal(ssp.t, port_state["ssp"].t) and torch.equal(ssp.v, port_state["ssp"].v)


@pytest.mark.parametrize("row", [0, 5, P.m])
def test_ssp_readers_refuse_an_unreduced_coefficient(tmp_path, jax_blobs, row):
    bad = bytearray(jax_blobs["ssp"])
    bad[8 * (row * P.d + 3) : 8 * (row * P.d + 3) + 8] = int(P.p).to_bytes(8, "little")
    path = str(tmp_path / "ssp.bin")
    tserial.save(path, bytes(bad))
    with pytest.raises(ValueError, match="reduced mod p"):
        tserial.ssp_read_stream(path, P, "cpu", rows_per_chunk=4)
    with pytest.raises(ValueError, match="reduced mod p"):
        tserial.ssp_from_buffer(bytes(bad), P, "cpu")


def test_crs_row_table(tmp_path, jax_blobs, port_state):
    path = str(tmp_path / "crs.bin")
    tserial.save(path, jax_blobs["crs"])
    seed, table = tserial.crs_row_table(path, P)
    assert seed == CRS_SEED and table.shape == (P.crs_num_cts, 92)
    np.testing.assert_array_equal(table[P.d : 2 * P.d, :88], port_state["crs"].b_as.numpy())
    np.testing.assert_array_equal(table[2 * P.d, :88], port_state["crs"].b_t.numpy())
    assert not table[:, 88:].any()


# --------------------------------------------------------------------------
# probes
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_probes(jax_run):
    _, _, crs, vrs, pi = jax_run

    @jax.jit
    def run(crs, vrs, pi):
        return (jobs.probe_crs(crs, vrs, P), jobs.probe_proof(pi, vrs, P),
                jobs.probe_crs_range(crs, vrs, P), jobs.probe_crs_range(crs, vrs, P, lo=3, count=6))

    return run(crs, vrs, pi)


def _flags(checks: dict) -> dict:
    return {k: bool(v) for k, v in checks.items() if np.asarray(v).dtype == np.bool_}


def test_probe_crs_agrees_with_jax(jax_probes, port_state):
    got = tobs.probe_crs(port_state["crs"], port_state["vrs"], P)
    assert _flags(got) == _flags(jax_probes[0])
    assert len(got) == 6 and all(_flags(got).values())


def test_probe_proof_agrees_with_jax(jax_probes, port_state):
    got = tobs.probe_proof(port_state["proof"], port_state["vrs"], P)
    want = jax_probes[1]
    assert bool(got["pke_h"]) and bool(want["pke_h"])
    for name in ("h", "hat_h", "hat_v", "v_w", "b_w"):
        assert int(got[name]) == int(want[name]), name


@pytest.mark.parametrize("case,kwargs", [(2, {}), (3, dict(lo=3, count=6))])
def test_probe_crs_range_agrees_with_jax(jax_probes, port_state, case, kwargs):
    got = tobs.probe_crs_range(port_state["crs"], port_state["vrs"], P, **kwargs)
    assert _flags(got) == _flags(jax_probes[case])
    assert all(_flags(got).values())
    assert ("s0_is_one" in got) == (kwargs.get("lo", 0) == 0)


def test_probe_compressed_decrypts_the_powers_of_s(port_state):
    from c_lwe_snarks_tpu_torch.ops import modp, sampling

    crs, vrs = port_state["crs"], port_state["vrs"]
    key = sampling.PRGKey(crs.seed, "cpu")
    dec = tobs.probe_compressed(key, P.ctr_s, crs.b_s, vrs.sk, P)
    assert torch.equal(dec, modp.powers_mod_p(vrs.s, P.d))


@pytest.mark.parametrize("section,row,flag", [
    ("b_s", 0, "s0_is_one"), ("b_as", 1, "alpha_correlated_1"), ("b_s", P.d - 1, "s_power_last")])
def test_probes_turn_false_on_a_flipped_crs_byte(port_state, section, row, flag):
    crs, vrs = port_state["crs"], port_state["vrs"]
    rows = getattr(crs, section).clone()
    rows[row, 0] ^= 1
    bad = tsnark.CRS(**{**vars(crs), section: rows})
    assert not bool(tobs.probe_crs(bad, vrs, P)[flag])
    ranged = tobs.probe_crs_range(bad, vrs, P)
    assert not all(_flags(ranged).values())


def test_probe_proof_turns_false_on_a_tampered_proof(port_state):
    pi, vrs = port_state["proof"], port_state["vrs"]
    bad_h = pi.h.clone()
    bad_h[P.n, 0] ^= 1
    bad = tsnark.Proof(h=bad_h, hat_h=pi.hat_h, hat_v=pi.hat_v, v_w=pi.v_w, b_w=pi.b_w)
    assert not bool(tobs.probe_proof(bad, vrs, P)["pke_h"])


def test_profile_writes_a_trace(tmp_path, port_state):
    with tobs.profile(str(tmp_path / "trace")) as prof:
        tobs.probe_proof(port_state["proof"], port_state["vrs"], P)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_cli_probe_and_save_dir(tmp_path):
    """python -m c_lwe_snarks_tpu_torch --d 16 --m 8 --device cpu --probe --save-dir DIR."""
    res = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys, torch\ntorch.set_num_threads(1)\n"
         "sys.argv = ['c_lwe_snarks_tpu_torch', '--d', '16', '--m', '8', '--device', 'cpu', "
         f"'--probe', '--save-dir', {str(tmp_path)!r}]\n"
         "runpy.run_module('c_lwe_snarks_tpu_torch', run_name='__main__')\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "verified: True" in res.stdout
    assert "crs probe: {'s0_is_one': True" in res.stderr and "False" not in res.stderr
    assert "proof probe: {'pke_h': True}" in res.stderr
    Pc = Params(d=16, m=8)
    crs = tserial.crs_from_bytes(tserial.load(str(tmp_path / "crs.bin")), Pc, "cpu")
    vrs = tserial.vrs_from_bytes(tserial.load(str(tmp_path / "vrs.bin")), Pc, "cpu")
    pi = tserial.proof_from_bytes(tserial.load(str(tmp_path / "proof.bin")), Pc, "cpu")
    ssp = tserial.ssp_read_stream(str(tmp_path / "ssp.bin"), Pc, "cpu")
    assert bool(tsnark.verifier(vrs, ssp, pi, Pc))
    assert all(_flags(tobs.probe_crs_range(crs, vrs, Pc, count=4)).values())


# --------------------------------------------------------------------------
# staged copies: the 92-byte rows made and taken off on the digits' device
# --------------------------------------------------------------------------

WRITERS = {"crs": tserial.crs_to_bytes, "vrs": tserial.vrs_to_bytes,
           "proof": tserial.proof_to_bytes}
READERS = {"crs": tserial.crs_from_bytes, "vrs": tserial.vrs_from_bytes,
           "proof": tserial.proof_from_bytes}
PROOF_FIELDS = ("h", "hat_h", "hat_v", "v_w", "b_w")


def _strided(t: torch.Tensor) -> torch.Tensor:
    """The same values as a view whose entries lie two apart."""
    wide = torch.full((*t.shape, 2), 0xA5, dtype=t.dtype)
    wide[..., 0] = t
    return wide[..., 0]


def test_writers_take_non_contiguous_sections(jax_blobs, port_state):
    crs, vrs, pi = port_state["crs"], port_state["vrs"], port_state["proof"]
    crs_v = tsnark.CRS(seed=crs.seed, **{k: _strided(getattr(crs, k))
                                         for k in ("b_s", "b_as", "b_t", "b_v")})
    vrs_v = tsnark.VRS(alpha=vrs.alpha, beta=vrs.beta, s=vrs.s, sk=_strided(vrs.sk))
    pi_v = tsnark.Proof(**{k: _strided(getattr(pi, k)) for k in PROOF_FIELDS})
    assert not (crs_v.b_s.is_contiguous() or crs_v.b_t.is_contiguous() or pi_v.h.is_contiguous())
    assert tserial.crs_to_bytes(crs_v, P) == jax_blobs["crs"]
    assert tserial.vrs_to_bytes(vrs_v, P) == jax_blobs["vrs"]
    assert tserial.proof_to_bytes(pi_v, P) == jax_blobs["proof"]


def test_readers_strip_into_one_tensor(port_state):
    """A reader's fields are contiguous slices of one [..., 88] tensor, in
    the stored order."""
    pi, crs = port_state["proof"], port_state["crs"]
    fields = [getattr(pi, k) for k in PROOF_FIELDS]
    for i, c in enumerate(fields):
        assert c.is_contiguous() and c.shape == (P.n + 1, 88)
        assert c.data_ptr() == fields[0].data_ptr() + i * (P.n + 1) * 88
    starts = {"b_s": 0, "b_as": P.d, "b_t": 2 * P.d, "b_v": 2 * P.d + 1}
    for k, row in starts.items():
        assert getattr(crs, k).is_contiguous()
        assert getattr(crs, k).data_ptr() == crs.b_s.data_ptr() + 88 * row


@pytest.mark.parametrize("word", [0, 1, (1 << 31) + 7, P.p - 1])
def test_vrs_scalars_as_words(port_state, word):
    """The scalars go out as 8-byte LE words from the device and come back
    as uint32 scalars, at the top of their range too."""
    vrs = port_state["vrs"]
    w = torch.tensor(word, dtype=torch.uint32)
    blob = tserial.vrs_to_bytes(tsnark.VRS(alpha=w, beta=vrs.beta, s=w.clone(), sk=vrs.sk), P)
    assert blob[:8] == blob[16:24] == word.to_bytes(8, "little")
    assert blob[8:16] == int(vrs.beta).to_bytes(8, "little")
    back = tserial.vrs_from_bytes(blob, P, "cpu")
    for x in (back.alpha, back.beta, back.s):
        assert x.dtype == torch.uint32 and x.shape == ()
    assert (int(back.alpha), int(back.s)) == (word, word)
    assert tserial.vrs_to_bytes(back, P) == blob


@pytest.mark.parametrize("artifact", ["crs", "vrs", "proof"])
@pytest.mark.parametrize("change", ["longer", "empty"])
def test_readers_refuse_a_longer_or_empty_blob(jax_blobs, artifact, change):
    blob = jax_blobs[artifact] + b"\0" if change == "longer" else b""
    with pytest.raises(ValueError, match="bytes, expected"):
        READERS[artifact](blob, P, "cpu")


def test_each_artifact_stages_one_copy(jax_blobs, port_state):
    """Traced, each whole artifact crosses in one staged copy through a
    host buffer (not pinned on the CPU); a writer syncs once, a reader
    never."""
    from c_lwe_snarks_tpu_torch.utils import spans

    names = [f"{a}_to_bytes" for a in WRITERS] + [f"{a}_from_bytes" for a in READERS]
    spans.reset()
    try:
        with spans.recording():
            for a in WRITERS:
                WRITERS[a](port_state[a], P)
            for a in READERS:
                READERS[a](jax_blobs[a], P, "cpu")
        assert spans.staged_sites() == {f"serial.{f}": {"copies": 1, "pinned_new": 0}
                                        for f in names}
        assert spans.sync_sites() == {f"serial.{a}_to_bytes": 1 for a in WRITERS}
        s = spans.summary()
        assert all(s[f"lwe.serial.{f}"]["staged"] == 1 for f in names)
    finally:
        spans.reset()
