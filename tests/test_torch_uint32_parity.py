"""The port's mod-p and polynomial functions on the JAX package's uint32 words.

The JAX package holds the SSP (t [d], v [m, d]) and the VRS's scalars
(alpha, beta, s) as uint32, and its mod-p and polynomial functions take
those words as they are.  Each port counterpart must take them too, and
int64 words as well, and give the JAX package's values (tolerance 0: both
sides are exact integers), from the same seeded SSP at d = 16, m = 8.  The
port's results are int64 (torch has no uint32 arithmetic on the CPU); what
it stores, the SSP and the VRS, has the JAX package's type: the VRS's
scalars are uint32 from ``setup``, ``serial.vrs_from_bytes`` and
``convert.vrs_from_numpy``, and its bytes are the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c_lwe_snarks_tpu.models import snark as jsnark
from c_lwe_snarks_tpu.models import ssp as jssp
from c_lwe_snarks_tpu.ops import modp as jmodp
from c_lwe_snarks_tpu.ops import ntt as jntt
from c_lwe_snarks_tpu.ops import sampling as jsam
from c_lwe_snarks_tpu.utils import serial as jserial
from c_lwe_snarks_tpu_torch.models import snark as tsnark
from c_lwe_snarks_tpu_torch.models import ssp as tssp
from c_lwe_snarks_tpu_torch.ops import modp, ntt
from c_lwe_snarks_tpu_torch.ops import sampling as tsam
from c_lwe_snarks_tpu_torch.utils import convert, serial
from c_lwe_snarks_tpu_torch.utils.params import Params

torch.set_num_threads(1)

CRS_SEED, ENT_SEED = bytes(range(40, 80)), bytes(range(40))
TINY = Params(d=16, m=8, n=32)
POW_E = 123456789


@pytest.fixture(scope="module")
def jax_state():
    """The JAX package's SSP and VRS at the tiny profile, from one seed."""
    crs_key, ent_key = jsam.PRGKey(CRS_SEED), jsam.PRGKey(ENT_SEED)
    off_setup = jssp.entropy_bytes_random_ssp(TINY)

    @jax.jit
    def run():
        _, inst = jssp.random_ssp(ent_key, 0, TINY)
        _, vrs = jsnark.setup(crs_key, ent_key, off_setup, inst, TINY)
        return inst, vrs

    return run()


def _port(x, dtype: str) -> torch.Tensor:
    """A JAX uint32 array as the port takes it: uint32 as it is, or int64."""
    t = torch.from_numpy(np.asarray(x).copy())
    assert t.dtype == torch.uint32
    return t if dtype == "uint32" else t.to(torch.int64)


# name -> (the JAX function on (t, v0, v), the port's on the same words)
CASES = {
    "poly_true_degree": (
        lambda t, v0, v: jntt.poly_true_degree(t),
        lambda t, v0, v: ntt.poly_true_degree(t)),
    "poly_degree_and_lead": (  # port-only: JAX's degree and t at it
        lambda t, v0, v: jnp.stack([jntt.poly_true_degree(t).astype(jnp.uint32),
                                    t[jntt.poly_true_degree(t)]]),
        lambda t, v0, v: list(ntt.poly_degree_and_lead(t))),
    "poly_mul_mod_p_t": (
        lambda t, v0, v: jntt.poly_mul_mod_p(t, t),
        lambda t, v0, v: ntt.poly_mul_mod_p(t, t)),
    "poly_mul_mod_p_v0": (
        lambda t, v0, v: jntt.poly_mul_mod_p(v0, v0),
        lambda t, v0, v: ntt.poly_mul_mod_p(v0, v0)),
    "poly_inv_series_mod_p": (
        lambda t, v0, v: jntt.poly_inv_series_mod_p(t, TINY.d),
        lambda t, v0, v: ntt.poly_inv_series_mod_p(t, TINY.d)),
    "poly_div_exact_mod_p": (
        lambda t, v0, v: jntt.poly_div_exact_mod_p(jntt.poly_mul_mod_p(t, t), t, TINY.d),
        lambda t, v0, v: ntt.poly_div_exact_mod_p(
            ntt.poly_mul_mod_p(t, t).to(t.dtype), t, TINY.d)),
    "mulmod_p": (
        lambda t, v0, v: jmodp.mulmod_p(t, v0),
        lambda t, v0, v: modp.mulmod_p(t, v0)),
    "addmod_p": (
        lambda t, v0, v: jmodp.addmod_p(t, v0),
        lambda t, v0, v: modp.addmod_p(t, v0)),
    "submod_p": (
        lambda t, v0, v: jmodp.submod_p(t, v0),
        lambda t, v0, v: modp.submod_p(t, v0)),
    "powmod_p": (
        lambda t, v0, v: jmodp.powmod_p(t, POW_E),
        lambda t, v0, v: modp.powmod_p(t, POW_E)),
    "invmod_p": (
        lambda t, v0, v: jmodp.invmod_p(v0),
        lambda t, v0, v: modp.invmod_p(v0)),
    "matvec_mod_p": (  # v is uint32 on both sides; w = t in the parametrised type
        lambda t, v0, v: jmodp.matvec_mod_p(v, t),
        lambda t, v0, v: modp.matvec_mod_p(_port(v, "uint32"), t)),
}


@pytest.mark.parametrize("dtype", ["uint32", "int64"])
@pytest.mark.parametrize("name", list(CASES))
def test_function_takes_jax_words(jax_state, name, dtype):
    """The port's function on the SSP's words (uint32 as the JAX package
    holds them, or int64) returns the JAX package's values."""
    inst, _ = jax_state
    jfn, tfn = CASES[name]
    t, v0, v = inst.t, inst.v[0], inst.v
    want = np.asarray(jax.jit(jfn)(t, v0, v)).astype(np.int64)
    got = tfn(_port(t, dtype), _port(v0, dtype), v)
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.int64  # the port's mod-p results are int64 words
        got = got.numpy()
    np.testing.assert_array_equal(np.asarray(got, dtype=np.int64), want)


def _port_vrs(how: str, vrs) -> tsnark.VRS:
    if how == "setup":
        ent_key = tsam.PRGKey(ENT_SEED, "cpu")
        _, ssp = tssp.random_ssp(ent_key, 0, TINY)
        return tsnark.setup(tsam.PRGKey(CRS_SEED, "cpu"), ent_key,
                            tssp.entropy_bytes_random_ssp(TINY), ssp, TINY)[1]
    if how == "vrs_from_bytes":
        return serial.vrs_from_bytes(jserial.vrs_to_bytes(vrs, TINY), TINY, "cpu")
    return convert.vrs_from_numpy(np.asarray(vrs.alpha), np.asarray(vrs.beta),
                                  np.asarray(vrs.s), np.asarray(vrs.sk), "cpu")


@pytest.mark.parametrize("how", ["setup", "vrs_from_bytes", "vrs_from_numpy"])
def test_vrs_scalars_are_uint32_as_in_jax(jax_state, how):
    """alpha, beta and s are uint32 scalars equal to VRSDev's, and the VRS's
    bytes are the JAX package's."""
    _, vrs = jax_state
    got = _port_vrs(how, vrs)
    for name in ("alpha", "beta", "s"):
        want = np.asarray(getattr(vrs, name))
        assert want.dtype == np.uint32
        x = getattr(got, name)
        assert x.dtype == torch.uint32 and x.numel() == 1, name
        assert int(x) == int(want), name
    assert serial.vrs_to_bytes(got, TINY) == jserial.vrs_to_bytes(vrs, TINY)
