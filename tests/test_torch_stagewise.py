"""PyTorch port vs the JAX package: the stage-wise prover and the scan
(two-stage) forms of eval_poly_multi / encrypt_section.

At the tiny parameters of tests/test_torch_snark.py the port's
``prover(tile=...)`` must give the JAX package's stage-wise proof and the
port's own one-pass proof, byte for byte; the scan paths, ``encrypt`` and
``ct_select_add`` are held against the JAX functions on inputs made from
numpy seeds, at n = 6 where a ciphertext is a half AES block long, so
odd-index offsets have lead 8.  Each JAX reference set is ONE jit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c_lwe_snarks_tpu.models import lwe as jlwe
from c_lwe_snarks_tpu.models import snark as jsnark
from c_lwe_snarks_tpu.models import ssp as jssp
from c_lwe_snarks_tpu.ops import sampling as jsam
from c_lwe_snarks_tpu_torch.__main__ import run_protocol
from c_lwe_snarks_tpu_torch.models import lwe as tlwe
from c_lwe_snarks_tpu_torch.models import snark as tsnark
from c_lwe_snarks_tpu_torch.models import ssp as tssp
from c_lwe_snarks_tpu_torch.ops import modp as tmodp
from c_lwe_snarks_tpu_torch.ops import sampling as tsam
from c_lwe_snarks_tpu_torch.utils import convert
from c_lwe_snarks_tpu_torch.utils.params import Params

torch.set_num_threads(1)

P = Params(d=16, m=8, n=32)
CRS_SEED = bytes(range(40, 80))
ENT_SEED = bytes(range(40))
TILE = 4

# the lwe-level cases: n = 6, so CTR_CT = 552 = 8 (mod 16)
PL = Params(d=16, m=8, n=6)
SEED = bytes(range(40))
EVAL_D, EVAL_OFF = 15, 3 * PL.ctr_ct  # odd degree, lead-8 offset
ENC_COUNT, ENC_OFF = 10, 5 * PL.ctr_ct  # ragged against a tile of 4, lead 8


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


def _t(x) -> torch.Tensor:
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype != np.uint8 else x)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX protocol with the stage-wise prover at tile=TILE, one jit."""
    crs_key, ent_key = jsam.PRGKey(CRS_SEED), jsam.PRGKey(ENT_SEED)
    off_setup = jssp.entropy_bytes_random_ssp(P)
    off_prove = off_setup + jsnark.setup_entropy_bytes(P)

    @jax.jit
    def run():
        wits, inst = jssp.random_ssp(ent_key, 0, P)
        crs, vrs = jsnark.setup(crs_key, ent_key, off_setup, inst, P)
        pi = jsnark.prover(crs_key, ent_key, off_prove, crs, inst, wits, P, tile=TILE)
        return wits, inst, crs, vrs, pi

    return run()


@pytest.fixture(scope="module")
def port_run():
    return run_protocol(P, "cpu", CRS_SEED, ENT_SEED)


def _port_prover(run, tile):
    crs_key, ent_key = tsam.PRGKey(CRS_SEED, "cpu"), tsam.PRGKey(ENT_SEED, "cpu")
    off_prove = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    return tsnark.prover(crs_key, ent_key, off_prove, run.crs, run.ssp, run.witness, P, tile=tile)


def test_stagewise_proof_equals_jax_stagewise(jax_run, port_run):
    pi = _port_prover(port_run, TILE)
    np.testing.assert_array_equal(convert.proof_to_numpy(pi), np.asarray(jax_run[4].stack()))


@pytest.mark.parametrize("tile", [2, TILE, 6, 16, 256])
def test_stagewise_proof_equals_onepass(port_run, tile):
    """Tiles below, at and above the section lengths (m - 1 = 7, d = 16)."""
    pi = _port_prover(port_run, tile)
    assert torch.equal(pi.stack(), port_run.proof.stack())
    assert bool(tsnark.verifier(port_run.vrs, port_run.ssp, pi, P))


def test_stagewise_from_jax_state(jax_run):
    """The port's stage-wise prover fed the JAX package's SSP and CRS."""
    wits, inst, crs, vrs, pi = jax_run
    ssp = convert.ssp_from_numpy(np.asarray(inst.t), np.asarray(inst.v), "cpu")
    tcrs = convert.crs_from_numpy(crs.seed, np.asarray(crs.b_s), np.asarray(crs.b_as),
                                  np.asarray(crs.b_t), np.asarray(crs.b_v), "cpu")
    off_prove = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    got = tsnark.prover(tsam.PRGKey(CRS_SEED, "cpu"), tsam.PRGKey(ENT_SEED, "cpu"), off_prove,
                        tcrs, ssp, torch.from_numpy(np.array(wits)), P, tile=TILE)
    np.testing.assert_array_equal(convert.proof_to_numpy(got), np.asarray(pi.stack()))


@pytest.mark.parametrize("tile", [TILE, 6])
def test_setup_with_tile_equals_fused_setup(port_run, tile):
    """setup(tile=...) takes the scan encrypt path; same CRS and VRS."""
    crs_key, ent_key = tsam.PRGKey(CRS_SEED, "cpu"), tsam.PRGKey(ENT_SEED, "cpu")
    crs, vrs = tsnark.setup(crs_key, ent_key, tssp.entropy_bytes_random_ssp(P), port_run.ssp, P,
                            tile=tile)
    for name in ("b_s", "b_as", "b_t", "b_v"):
        assert torch.equal(getattr(crs, name), getattr(port_run.crs, name)), name
    assert torch.equal(vrs.sk, port_run.vrs.sk) and int(vrs.s) == int(port_run.vrs.s)


# --------------------------------------------------------------------------
# lwe level
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lwe_inputs():
    rng = np.random.default_rng(2024)
    return {
        "coeffs": rng.integers(0, PL.p, size=(2, EVAL_D), dtype=np.uint64).astype(np.uint32),
        "b_rows": rng.integers(0, 256, size=(EVAL_D, 92), dtype=np.uint8),
        "sk": rng.integers(0, 256, size=(PL.n, 88), dtype=np.uint8),
        "msgs": rng.integers(0, PL.p, size=ENC_COUNT, dtype=np.uint64).astype(np.uint32),
        "errs": np.pad(rng.integers(0, 256, size=(ENC_COUNT, 69), dtype=np.uint8),
                       ((0, 0), (0, 19))),
        "acc": rng.integers(0, 256, size=(3, PL.n + 1, 88), dtype=np.uint8),
        "ct": rng.integers(0, 256, size=(3, PL.n + 1, 88), dtype=np.uint8),
        "pred": np.array([True, False, True]),
    }


@pytest.fixture(scope="module")
def jax_lwe(lwe_inputs):
    """All JAX references of the lwe-level tests from ONE jit."""
    jkey = jsam.PRGKey(SEED)
    x = {k: jnp.asarray(v) for k, v in lwe_inputs.items()}

    @jax.jit
    def run():
        return {
            "eval_scan": jlwe.eval_poly_multi(
                jkey, EVAL_OFF, x["b_rows"], x["coeffs"], PL, impl="scan", tile=TILE),
            "eval_scan_default_tile": jlwe.eval_poly_multi(
                jkey, EVAL_OFF, x["b_rows"], x["coeffs"], PL, impl="scan"),
            "eval_poly": jlwe.eval_poly(jkey, EVAL_OFF, x["b_rows"], x["coeffs"][0], PL),
            "enc_scan": jlwe.encrypt_section(
                jkey, ENC_OFF, x["sk"], x["msgs"], x["errs"], PL, impl="scan", tile=TILE),
            "encrypt": jlwe.encrypt(jkey, ENC_OFF, x["sk"], x["msgs"][:3], x["errs"][:3], PL),
            "select_add": jlwe.ct_select_add(x["pred"][:, None], x["acc"], x["ct"]),
            "ct_export": jlwe.ct_export(x["ct"], PL),
        }

    return run()


@pytest.fixture(scope="module")
def tkey():
    return tsam.PRGKey(SEED, "cpu")


@pytest.mark.parametrize("tile,ref", [(TILE, "eval_scan"), (None, "eval_scan_default_tile"),
                                      (2, "eval_scan"), (5, "eval_scan")])
def test_eval_poly_multi_scan_vs_jax(tkey, lwe_inputs, jax_lwe, tile, ref):
    """Odd degree (zero-padded to whole tiles) from a lead-8 offset."""
    got = tlwe.eval_poly_multi(tkey, EVAL_OFF, _t(lwe_inputs["b_rows"]), _t(lwe_inputs["coeffs"]),
                               PL, impl="scan", tile=tile)
    _eq(got, jax_lwe[ref])


def test_eval_poly_multi_scan_equals_fused(tkey, lwe_inputs, jax_lwe):
    args = (tkey, EVAL_OFF, _t(lwe_inputs["b_rows"]), _t(lwe_inputs["coeffs"]), PL)
    fused = tlwe.eval_poly_multi(*args, impl="fused")
    assert torch.equal(fused, tlwe.eval_poly_multi(*args))  # auto is fused
    _eq(fused, jax_lwe["eval_scan"])
    _eq(tlwe.eval_poly(tkey, EVAL_OFF, _t(lwe_inputs["b_rows"]), _t(lwe_inputs["coeffs"])[0], PL),
        jax_lwe["eval_poly"])
    with pytest.raises(ValueError):
        tlwe.eval_poly_multi(*args, impl="pallas")


def test_eval_poly_multi_acc_planes_stay_small(tkey, lwe_inputs):
    """One partial fold per tile keeps positions <= 255 + 2^23."""
    c = torch.nn.functional.pad(_t(lwe_inputs["coeffs"]), (0, 1))
    b = torch.nn.functional.pad(_t(lwe_inputs["b_rows"]), (0, 0, 0, 1))
    acc = tlwe.eval_poly_multi_acc(tkey, EVAL_OFF, b, c, PL, tile=TILE)
    assert acc.shape == (2, PL.n + 1, 88) and acc.dtype == torch.int64
    assert 0 <= int(acc.min()) and int(acc.max()) <= 255 + (1 << 23)


@pytest.mark.parametrize("tile", [TILE, 2, 3, None])
def test_encrypt_section_scan_vs_jax(tkey, lwe_inputs, jax_lwe, tile):
    """A ragged count (10 against tiles of 4) pads with dummy encryptions;
    an odd tile takes the single-slab branch.  Every tile gives the bytes
    of the JAX scan path."""
    x = lwe_inputs
    got = tlwe.encrypt_section(tkey, ENC_OFF, _t(x["sk"]), _t(x["msgs"]), _t(x["errs"]), PL,
                               impl="scan", tile=tile)
    _eq(got, jax_lwe["enc_scan"])


def test_encrypt_section_scan_equals_fused(tkey, lwe_inputs, jax_lwe):
    x = lwe_inputs
    args = (tkey, ENC_OFF, _t(x["sk"]), _t(x["msgs"]), _t(x["errs"]), PL)
    _eq(tlwe.encrypt_section(*args, impl="fused"), jax_lwe["enc_scan"])
    _eq(tlwe.encrypt_section(*args), jax_lwe["enc_scan"])


def test_encrypt_vs_jax(tkey, lwe_inputs, jax_lwe):
    x = lwe_inputs
    got = tlwe.encrypt(tkey, ENC_OFF, _t(x["sk"]), _t(x["msgs"][:3]), _t(x["errs"][:3]), PL)
    _eq(got, jax_lwe["encrypt"])
    _eq(tlwe.ct_b(got), np.asarray(jax_lwe["enc_scan"])[:3])


def test_ct_select_add_and_export_vs_jax(lwe_inputs, jax_lwe):
    x = lwe_inputs
    got = tlwe.ct_select_add(torch.from_numpy(x["pred"])[:, None], _t(x["acc"]), _t(x["ct"]))
    _eq(got, jax_lwe["select_add"])
    _eq(tlwe.ct_export(_t(x["ct"]), PL), jax_lwe["ct_export"])
    assert tlwe.b_export(_t(x["ct"])[0], PL).shape == (PL.n + 1, 92)


def test_mul32_exact():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, size=257, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, size=257, dtype=np.uint64)
    a[:3], b[:3] = [0xFFFFFFFF, 0, 0xFFFFFFFF], [0xFFFFFFFF, 0xFFFFFFFF, 1]
    hi, lo = tmodp.mul32(_t(a), _t(b))
    want = [int(x) * int(y) for x, y in zip(a, b)]
    assert [(int(h) << 32) | int(l) for h, l in zip(hi, lo)] == want
