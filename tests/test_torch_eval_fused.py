"""PyTorch port vs the JAX package: the fused kernels K3 (eval MAC) and
K4 (encrypt), and the LWE functions built on them.

The port's plain versions are held against the JAX Pallas kernels in
interpret mode (small lane widths, several row chunks), and the port's
eval_poly_multi / encrypt_section against the JAX scan path, bit for bit.
The CUDA kernels are held against the plain versions on a GPU in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c_lwe_snarks_tpu.models import lwe as jlwe
from c_lwe_snarks_tpu.ops import eval_fused as jef
from c_lwe_snarks_tpu.ops import sampling as jsam
from c_lwe_snarks_tpu.utils import params as params_mod
from c_lwe_snarks_tpu_torch.models import lwe as tlwe
from c_lwe_snarks_tpu_torch.ops import eval_fused as tef
from c_lwe_snarks_tpu_torch.ops import sampling as tsam

torch.set_num_threads(1)

SEED = bytes(range(40))
P = params_mod.custom(d=256, m=8, n=6)


@pytest.fixture(scope="module")
def keys():
    return tsam.PRGKey(SEED, "cpu"), jsam.PRGKey(SEED)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def _coeffs(k, d, seed):
    return np.random.default_rng(seed).integers(0, P.p, size=(k, d), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("off", [0, 32, 40])  # 40: a half-block (lead 8) offset
@pytest.mark.parametrize("k", [1, 2, 5])
def test_eval_mac_planes_vs_pallas(keys, off, k):
    """lane_w=64 at d=256 gives two row chunks (grid accumulation)."""
    tkey, jkey = keys
    c = _coeffs(k, P.d, 7 + k)
    want = jef.eval_mac_planes(jkey, off, jnp.asarray(c), P.n, P.ctr_ct, lane_w=64, interpret=True)
    got = tef.eval_mac_planes(tkey, off, torch.from_numpy(c.astype(np.int64)), P.n, P.ctr_ct)
    _eq(got, want)


@pytest.mark.parametrize("count,lead", [(20, 0), (19, 0), (20, 8), (17, 8)])
def test_encrypt_b_fused_vs_pallas(keys, count, lead):
    """Odd counts leave a dummy pair tail in the TPU kernel; lane_w=4
    gives several row chunks."""
    tkey, jkey = keys
    rng = np.random.default_rng(11 + count + lead)
    sk = rng.integers(0, 256, size=(P.n, 88), dtype=np.uint8)
    off = 3 * 16 + lead
    want = jef.encrypt_b_fused(jkey, off, jnp.asarray(sk), count, P.n, P.ctr_ct,
                               lane_w=4, interpret=True)
    got = tef.encrypt_b_fused(tkey, off, torch.from_numpy(sk), count, P.n, P.ctr_ct)
    _eq(got, want)


@pytest.mark.parametrize("off", [0, 40])
def test_eval_poly_multi_vs_scan(keys, off):
    tkey, jkey = keys
    rng = np.random.default_rng(5)
    b_rows = rng.integers(0, 256, size=(P.d, 88), dtype=np.uint8)
    c = _coeffs(2, P.d, 9)
    want = jax.jit(lambda b, cc: jlwe.eval_poly_multi(jkey, off, b, cc, P, impl="scan"))(
        jnp.asarray(b_rows), jnp.asarray(c))
    got = tlwe.eval_poly_multi(tkey, off, torch.from_numpy(b_rows),
                               torch.from_numpy(c.astype(np.int64)), P)
    _eq(got, want)


@pytest.mark.parametrize("lead", [0, 8])
def test_encrypt_section_vs_scan(keys, lead):
    tkey, jkey = keys
    rng = np.random.default_rng(21 + lead)
    count = 33
    sk = rng.integers(0, 256, size=(P.n, 88), dtype=np.uint8)
    msgs = rng.integers(0, P.p, size=count, dtype=np.uint64).astype(np.uint32)
    errs = rng.integers(0, 256, size=(count, 88), dtype=np.uint8)
    errs[:, 69:] = 0  # 69 live error bytes, as setup draws them
    off = 5 * 16 + lead
    want = jax.jit(lambda: jlwe.encrypt_section(
        jkey, off, jnp.asarray(sk), jnp.asarray(msgs), jnp.asarray(errs), P, impl="scan"))()
    got = tlwe.encrypt_section(
        tkey, off, torch.from_numpy(sk), torch.from_numpy(msgs.astype(np.int64)),
        torch.from_numpy(errs), P)
    _eq(got, want)


def test_lwe_algebra_vs_jax(keys):
    """decrypt, ct_add, ct_mul_ui, smudge (both signs) and ct_import."""
    tkey, jkey = keys
    rng = np.random.default_rng(31)
    ct = rng.integers(0, 256, size=(3, P.n + 1, 88), dtype=np.uint8)
    ct2 = rng.integers(0, 256, size=(3, P.n + 1, 88), dtype=np.uint8)
    sk = rng.integers(0, 256, size=(P.n, 88), dtype=np.uint8)
    s_dig = np.zeros(88, np.uint8)
    s_dig[:80] = rng.integers(0, 256, size=80, dtype=np.uint8)
    b92 = rng.integers(0, 256, size=(2, 92), dtype=np.uint8)
    c = np.uint32(4000000000)

    @jax.jit
    def jref(ct, ct2, sk, s_dig, b92):
        return (jlwe.decrypt(ct, sk, P), jlwe.ct_add(ct, ct2), jlwe.ct_mul_ui(ct, jnp.uint32(c)),
                jlwe.smudge(ct[0], s_dig, jnp.bool_(True), P),
                jlwe.smudge(ct[0], s_dig, jnp.bool_(False), P),
                jlwe.ct_import(jkey, 40, b92, P))

    want = jref(*map(jnp.asarray, (ct, ct2, sk, s_dig, b92)))
    t = [torch.from_numpy(x) for x in (ct, ct2, sk, s_dig, b92)]
    got = (tlwe.decrypt(t[0], t[2], P), tlwe.ct_add(t[0], t[1]),
           tlwe.ct_mul_ui(t[0], torch.tensor(int(c))),
           tlwe.smudge(t[0][0], t[3], torch.tensor(True), P),
           tlwe.smudge(t[0][0], t[3], torch.tensor(False), P),
           tlwe.ct_import(tkey, 40, t[4], P))
    for g, w in zip(got, want):
        _eq(g, w)
