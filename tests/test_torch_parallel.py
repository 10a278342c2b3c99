"""The port's sharded primitives over gloo worlds of 2, 3 and 4 ranks, held
against the JAX package's single-device functions, tolerance 0.

One world for each size runs ``tests/_torch_dist_worker.py primitives``
(jax blocked in every rank) on the CPU; the cases are those of
tests/test_parallel.py: encryptions with counts 16 and 7 (a ragged last
rank), odd n = 3 and 5 (CTR_CT = 92n is not 8-byte aligned: the per-rank
offsets are exact ints, no chunk is rounded), the lead-8 offset 40, the
evaluations with k = 2, random_ssp at m = 8, 13, 24, v_i(s) at m = 8, 13,
and the 4-step NTT's product, series inverse and exact division at
n = 64 and 1024 with its threshold lowered (eligible at W = 2 and 4, not
at 3), each also against the single-device port.  The series inverse and
the quotient are held against JAX's product (t * s = 1 mod x^n, den * q =
num, q the quotient the case was built from): JAX's Newton loops trace
for tens of seconds at these lengths, its product in about one.  The
protocol at the tiny parameters gives the committed golden digests (made
from the JAX package) on every rank.
"""

import functools
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c_lwe_snarks_tpu.models import lwe as jlwe
from c_lwe_snarks_tpu.models import ssp as jssp
from c_lwe_snarks_tpu.ops import modp as jmodp
from c_lwe_snarks_tpu.ops import ntt as jntt
from c_lwe_snarks_tpu.ops import sampling as jsam
from c_lwe_snarks_tpu.utils import params as params_mod
from c_lwe_snarks_tpu_torch.ops import ntt as tntt

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_dist_worker as worker  # noqa: E402

torch.set_num_threads(1)

WORLDS = (2, 3, 4)
GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_port_digests.json"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return worker.run_worlds("primitives", WORLDS, tmp_path_factory.mktemp("gloo"))


def _u32(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


@functools.cache
def jax_reference(case: str) -> dict:
    """The JAX package's single-device result of a case, as numpy."""
    kind, p = worker.CASES[case]
    x = worker.case_inputs(case)
    crs_key, ent_key = jsam.PRGKey(worker.CRS_SEED), jsam.PRGKey(worker.ENT_SEED)
    if kind == "encrypt":
        P = params_mod.Params(d=16, m=8, n=p["n"])
        out = jax.jit(lambda sk, m, e: jlwe.encrypt_section(crs_key, p["off"], sk, m, e, P))(
            jnp.asarray(x["sk"]), _u32(x["msgs"]), jnp.asarray(x["errs"]))
        return {"out": out}
    if kind == "eval":
        P = params_mod.Params(d=p["d"], m=8, n=p["n"])
        out = jax.jit(lambda b, c: jlwe.eval_poly_multi(crs_key, p["off"], b, c, P))(
            jnp.asarray(x["b_rows"]), _u32(x["coeffs"]))
        return {"out": out}
    if kind == "random_ssp":
        P = params_mod.Params(d=16, m=p["m"], n=32)
        wits, inst = jax.jit(lambda: jssp.random_ssp(ent_key, 0, P))()
        return {"wits": wits, "t": inst.t, "v": inst.v}
    if kind == "v_at_s":
        powers = jmodp.powers_mod_p(jnp.uint32(int(x["s"])), 16)
        out = jax.jit(lambda v, pw: jmodp.sum_mod_p(jmodp.mulmod_p(v, pw[None, :]), axis=-1))(
            _u32(x["v"]), powers)
        return {"out": out}
    if kind == "mul":
        return {"out": _jmul(_u32(x["a"]), _u32(x["b"]), p["n"] - 1)}
    if kind == "inv":  # checked through JAX's product in the test
        return {}
    return {"out": x["quot"]}


_jmul = jax.jit(jntt.poly_mul_mod_p, static_argnums=2)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(worker.CASES))
def test_sharded_equals_jax(worlds, case, world):
    got = np.load(worlds[world] / f"{case}.npz")
    want = jax_reference(case)
    for name, ref in want.items():
        np.testing.assert_array_equal(
            got[name].astype(np.int64), np.asarray(ref).astype(np.int64), err_msg=name)
    kind, p = worker.CASES[case]
    if kind in ("mul", "inv", "div", "div_shift"):
        # the 4-step rule: W divides n1 and n2 at W = 2 and 4, not at 3
        assert bool(got["sharded"]) == (world != 3)
        x = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in worker.case_inputs(case).items()}
        one = {"mul": lambda: tntt.poly_mul_mod_p(x["a"], x["b"]),
               "inv": lambda: tntt.poly_inv_series_mod_p(x["t"], p["n"])}.get(
            kind, lambda: tntt.poly_div_exact_mod_p(x["num"], x["den"], x["quot_len"]))()
        np.testing.assert_array_equal(got["out"], one.numpy())
        if kind == "inv":  # t * s = 1 mod x^n
            want = np.zeros(p["n"], np.int64)
            want[0] = 1
            prod = _jmul(_u32(x["t"].numpy()), _u32(got["out"]), p["n"])
            np.testing.assert_array_equal(np.asarray(prod).astype(np.int64), want)
        elif kind != "mul":  # den * q = num
            want = x["num"].numpy()
            prod = _jmul(_u32(x["den"].numpy()), _u32(got["out"]), want.shape[0])
            np.testing.assert_array_equal(np.asarray(prod).astype(np.int64), want)
    if kind == "random_ssp":  # rank 0 holds the first rows; t and v are uint32, as in JAX
        assert int(got["row0"]) == 0
        assert got["t"].dtype == got["v"].dtype == np.asarray(want["v"]).dtype == np.uint32


@pytest.mark.parametrize("world", WORLDS)
def test_protocol_digests_equal_golden(worlds, world):
    """random_ssp -> setup -> prover -> verifier at the tiny parameters with
    the mesh: every rank has the golden SSP (gathered), CRS, VRS and proof,
    the verifier accepts, and rank r's rows of v start at the chunk rule's.
    The scan setup and the stage-wise prover (tile 8) under the mesh give
    the same CRS and proof."""
    golden = json.loads(GOLDEN.read_text())
    assert golden["profiles"]["tiny"]["params"] == worker.TINY
    want = golden["profiles"]["tiny"]["sha256"]
    chunk = -(-worker.TINY["m"] // world)
    for rank in range(world):
        got = json.loads((worlds[world] / f"protocol_{rank}.json").read_text())
        assert got["verified"] is True
        assert got["sha256"] == {**want, "crs_scan": want["crs"], "proof_stagewise": want["proof"]}
        assert got["row0"] == min(rank * chunk, worker.TINY["m"])
